"""Device-mesh parallelism.

The workload's parallelism is data parallelism over page/crop batches
(SURVEY.md §2.4: the reference is strictly serial; DP over pages is the
equivalent that matters), plus tensor parallelism over the recognizer's
wide dense kernels for the training path. Everything routes through
jax.sharding Meshes + NamedSharding annotations — XLA inserts the
collectives (psum for DP grads, all-gather/reduce-scatter for TP) from the
shardings; no hand-written collective calls are needed at this layer.

Axes:
  data  — batch dimension (pages, crops, text lines)
  model — TP shards of large dense kernels
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Multi-process (multi-host) initialization.

    Call ONCE before any backend use on each host of a multi-host
    deployment. Parameters come from arguments or the env vars
    SYNAPTA_COORDINATOR / SYNAPTA_NUM_PROCESSES / SYNAPTA_PROCESS_ID.
    After this, ``jax.devices()`` spans every host's devices: the data
    meshes below shard pages across all of them (SURVEY §2.4).

    Returns True when a multi-process runtime was initialized, False for
    the single-process degenerate case (no coordinator configured) —
    callers need no branches; the meshes work identically either way.

    VALIDATION STATUS: exercised for real by
    tests/test_parallel.py::test_two_process_cpu_cluster — two OS
    processes (4 virtual CPU devices each, gloo collectives) join through
    this function into one 8-device cluster, build the global dp x tp
    mesh, and run the sharded inference + train steps with results
    matching a single-process run: the coordinator handshake, global
    device view, and cross-process collectives are what this validates.
    """
    import os

    coordinator = coordinator or os.environ.get("SYNAPTA_COORDINATOR")
    if num_processes is None:
        env = os.environ.get("SYNAPTA_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("SYNAPTA_PROCESS_ID")
        process_id = int(env) if env else None
    if not coordinator and num_processes in (None, 1):
        return False  # single-process: nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_mesh(n_devices: Optional[int] = None, model_axis: int = 1) -> Mesh:
    """A (data, model) mesh over the first n devices. data*model must
    divide the device count."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if n % model_axis:
        raise ValueError(f"{n} devices not divisible by model axis {model_axis}")
    arr = np.array(devs[:n]).reshape(n // model_axis, model_axis)
    return Mesh(arr, ("data", "model"))


def data_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-D ('data',) mesh over the first n devices — the inference-path
    mesh for page/crop-batch data parallelism (SURVEY §2.4)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), ("data",))


def data_mesh_auto(batch: int, n_devices: Optional[int] = None) -> Mesh:
    """The largest data mesh whose size divides ``batch`` (fixed-shape
    device chunks must split evenly across the 'data' axis)."""
    avail = n_devices or len(jax.devices())
    n = max(d for d in range(1, avail + 1) if batch % d == 0)
    return data_mesh(n)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharded(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("data"))


def param_spec(path: tuple, value: Any, mesh: Mesh) -> NamedSharding:
    """TP rule: 2-D+ kernels whose output dim divides the model axis shard
    on 'model'; everything else replicates."""
    model_size = mesh.shape["model"]
    name = str(path[-1]) if path else ""
    if (
        model_size > 1
        and hasattr(value, "ndim")
        and value.ndim >= 2
        and "kernel" in name
        and value.shape[-1] % model_size == 0
    ):
        return NamedSharding(mesh, P(*([None] * (value.ndim - 1) + ["model"])))
    return replicated(mesh)


def shard_params(params, mesh: Mesh):
    """Device-put a param tree with TP shardings applied."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    specs = {
        tuple(k.key for k in path): param_spec(
            tuple(k.key for k in path), v, mesh
        )
        for path, v in flat
    }

    def place(path, v):
        return jax.device_put(v, specs[tuple(k.key for k in path)])

    return jax.tree_util.tree_map_with_path(place, params)


def params_shardings(params, mesh: Mesh):
    """The sharding tree matching shard_params (for jit in_shardings)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, v: param_spec(tuple(k.key for k in path), v, mesh), params
    )


def shard_batch(batch, mesh: Mesh):
    """Device-put arrays batch-sharded along 'data'."""
    return jax.tree.map(lambda a: jax.device_put(a, data_sharded(mesh)), batch)


def make_inference_fn(apply_fn, mesh: Mesh, params):
    """jit an apply function with batch inputs sharded over 'data' and
    params in their TP layout."""
    pshard = params_shardings(params, mesh)
    return jax.jit(
        apply_fn,
        in_shardings=(pshard, data_sharded(mesh)),
        out_shardings=data_sharded(mesh),
    )


def make_dp_tp_train_step(tx, mesh: Mesh, params):
    """Full training step sharded dp x tp: batch on 'data', wide kernels on
    'model', optimizer state mirroring the param layout. XLA derives the
    gradient psum over 'data' and the activation collectives over 'model'
    from these shardings."""
    import optax

    from synapta_tpu.models.train import ctc_objective

    pshard = params_shardings(params, mesh)
    oshard = jax.tree.map(
        lambda _: replicated(mesh), jax.eval_shape(tx.init, params),
        is_leaf=lambda x: hasattr(x, "shape"),
    )
    data = data_sharded(mesh)

    def step(p, opt_state, imgs, labels, label_lens):
        loss, grads = jax.value_and_grad(ctc_objective)(
            p, imgs, labels, label_lens
        )
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        return p, opt_state, loss

    return jax.jit(
        step,
        in_shardings=(pshard, oshard, data, data, data),
        out_shardings=(pshard, oshard, replicated(mesh)),
        donate_argnums=(0, 1),
    )
