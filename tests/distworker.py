"""Worker subprocess for the 2-process distributed integration test
(tests/test_parallel.py::test_two_process_cpu_cluster).

Each worker owns 4 virtual CPU devices; jax.distributed.initialize joins
them into one 8-device cluster (localhost coordinator, gloo CPU
collectives). The worker builds the global dp x tp mesh through the
SAME production helpers the pipeline uses (parallel/mesh.py), runs a
sharded recognizer inference checksum and two dp x tp CTC train steps on
deterministic data, and writes its replicated results as JSON for the
parent test to compare against a single-process run.
"""
import json
import os
import sys


def main() -> None:
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    coord = sys.argv[3]
    out_path = sys.argv[4]

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    import jax

    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from synapta_tpu.parallel.mesh import init_distributed

    assert init_distributed(coordinator=coord, num_processes=nproc,
                            process_id=pid) is True
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.local_device_count() == 4
    assert jax.device_count() == 4 * nproc

    results = run_workload()
    results["process_count"] = jax.process_count()
    results["device_count"] = jax.device_count()
    with open(out_path, "w") as f:
        json.dump(results, f)


def run_workload() -> dict:
    """The sharded computation, identical for single- and multi-process
    callers: dp4 x tp2 mesh, inference checksum + 2 CTC train steps."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from synapta_tpu.models.recognizer import init_recognizer, recognize
    from synapta_tpu.parallel.mesh import (
        data_sharded,
        make_dp_tp_train_step,
        make_mesh,
        params_shardings,
        replicated,
    )

    H, W, B, L = 32, 64, 8, 8
    mesh = make_mesh(8, model_axis=2)  # global dp=4 x tp=2

    def init_fn():
        return init_recognizer(jax.random.PRNGKey(0), width=W)

    shapes = jax.eval_shape(init_fn)
    pshard = params_shardings(shapes, mesh)
    # params materialize ALREADY sharded across every process's devices:
    # computed identically everywhere, placed by out_shardings (no
    # host->global device_put needed in the multi-process case)
    params = jax.jit(init_fn, out_shardings=pshard)()

    rng = np.random.default_rng(3)
    imgs_h = rng.random((B, H, W, 1)).astype(np.float32)
    labels_h = rng.integers(1, 50, size=(B, 16)).astype(np.int32)
    lens_h = np.full((B,), L, np.int32)

    def garr(x):
        sh = NamedSharding(mesh, P("data"))
        return jax.make_array_from_callback(x.shape, sh, lambda i: x[i])

    imgs, labels, lens = garr(imgs_h), garr(labels_h), garr(lens_h)

    chk_fn = jax.jit(
        lambda p, x: jnp.mean(jnp.abs(
            recognize(p, x).astype(jnp.float32))),
        in_shardings=(pshard, data_sharded(mesh)),
        out_shardings=replicated(mesh),
    )
    chk = float(np.asarray(chk_fn(params, imgs).addressable_data(0)))

    tx = optax.adam(1e-3)
    step = make_dp_tp_train_step(tx, mesh, shapes)
    oshard = jax.tree.map(
        lambda _: replicated(mesh), jax.eval_shape(tx.init, shapes),
        is_leaf=lambda x: hasattr(x, "shape"),
    )
    opt_state = jax.jit(tx.init, out_shardings=oshard)(params)
    losses = []
    for _ in range(2):
        params, opt_state, loss = step(params, opt_state, imgs, labels,
                                       lens)
        losses.append(float(np.asarray(loss.addressable_data(0))))
    return {"chk": chk, "losses": losses}


if __name__ == "__main__":
    main()
