"""Smoke run of the segmentation pipeline on NVIDIA GPUs.

Drives ``VisualSegmentationPipeline.process`` and ``serve.BookQueue`` at
production shapes — 512x512 crops analyzed 16 at a time, text lines
recognized 128 at a time on 32x384 tiles, 32-page super-batches, analyze
depth 4, recognize depth 2 — scores the output against the generators'
ground truth, and runs every device program of that path on the GPU and on
the host CPU at real widths to compare them. Any failure exits non-zero
before the result line; on success the last stdout line is one JSON
object naming the device.

    make -C native                  # the PDF engine (also run below)
    python chip_smoke.py            # one GPU: every phase
    python chip_smoke.py --four     # four GPUs: the sharded book only

Every printed number carries the card's name and power limit, because a
card capped below its maximum runs slower under load.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# production shapes (PipelineConfig / OCRConfig defaults), checked below
SHAPES = {
    "crop_size": 512, "crop_batch": 16, "line_batch": 128,
    "line_height": 32, "line_max_width": 384, "pages_per_batch": 32,
    "analyze_depth": 4, "recognize_depth": 2,
}
BOOK_PAGES, BOOK_SEED = 192, 42
SCANNED_PAGES = 8

# accuracy bars on the generators' ground truth. Classification: 190 of
# this book's 192 visuals; a squat-bar chart (page 50) and a line chart
# (page 163) fall to the classifier's embedded-table gate on every
# backend, so any further miss fails the run.
BARS = {"detection_recall@0.5": 1.0, "mean_iou": 0.95,
        "classification_accuracy": 0.985, "ocr_cer": 0.05,
        "scanned_ocr_cer": 0.05}

CARD = "?"
FAILURES: list = []


class SmokeFailure(RuntimeError):
    pass


def say(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    """Record a failed check and go on, so one run reports every
    failure; main exits non-zero, without the result line, if any."""
    if not ok:
        FAILURES.append(msg)
        say(f"FAIL: {msg}")


def require_gpu(backend: str) -> None:
    """Refuse any backend but the GPU: a CPU fallback would pass every
    phase and measure nothing."""
    if backend != "gpu":
        raise SmokeFailure(f"JAX backend is {backend!r}, not 'gpu'")


def nvidia_smi() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def timed(fn, *args, reps: int = 20):
    """Median and min wall seconds of fn(*args) after two warm calls,
    each call waited on with block_until_ready."""
    import jax

    for _ in range(2):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), min(ts)


# ------------------------------------------------------------------ phases


def run_book(pdf: str, out_dir: str, cfg, ocr=None, book_id: str = "book"):
    from synapta_tpu.llm.fake import DisabledClient
    from synapta_tpu.pipeline import VisualSegmentationPipeline

    pipe = VisualSegmentationPipeline(
        book_id=book_id, pdf_path=pdf, output_dir=out_dir,
        use_mermaid=False, config=cfg, llm_client=DisabledClient(),
        ocr=ocr, resume=False,
    )
    t0 = time.perf_counter()
    segs = pipe.process()
    wall = time.perf_counter() - t0
    pipe.close()
    check(pipe.stats.errors == 0,
          f"{book_id}: pipeline counted {pipe.stats.errors} errors")
    return pipe, segs, wall


def phase_born_digital(tmp: str, cfg):
    from synapta_tpu.eval import score_book
    from synapta_tpu.io.pdf_writer import make_test_book
    from synapta_tpu.utils.profiler import TIMERS

    pdf = os.path.join(tmp, "book.pdf")
    truths = make_test_book(pdf, pages=BOOK_PAGES, seed=BOOK_SEED)
    pipe, segs, cold = run_book(pdf, os.path.join(tmp, "cold"), cfg)
    TIMERS.totals.clear()
    TIMERS.counts.clear()
    pipe2, segs2, warm = run_book(pdf, os.path.join(tmp, "warm"), cfg,
                                  ocr=pipe.ocr)
    say(f"born-digital {BOOK_PAGES} pages: first run {cold:.3f} s "
        f"(compile included), warm run {warm:.3f} s, compile+first-touch "
        f"{cold - warm:.3f} s, warm {BOOK_PAGES / warm:.3f} pages/s, "
        f"segments={len(segs2)} errors={pipe2.stats.errors}")
    stages = TIMERS.report()
    say("warm-run host stages (s): " + ", ".join(
        f"{k}={v['total_s']}" for k, v in list(stages.items())[:10]))
    scores = score_book(truths, segs2)
    say(f"born-digital accuracy: {json.dumps(scores)}")
    check(scores["detection_recall@0.5"] >= BARS["detection_recall@0.5"],
          f"recall {scores['detection_recall@0.5']}")
    check(scores["mean_iou"] >= BARS["mean_iou"],
          f"mean IoU {scores['mean_iou']}")
    check(scores["classification_accuracy"]
          >= BARS["classification_accuracy"],
          f"classification {scores['classification_accuracy']}")
    check(scores["ocr_cer"] <= BARS["ocr_cer"], f"CER {scores['ocr_cer']}")
    return pdf, pipe.ocr


def phase_scanned(tmp: str, cfg, ocr):
    from synapta_tpu.eval import score_scanned
    from synapta_tpu.io.pdf_writer import make_scanned_book

    pdf = os.path.join(tmp, "scanned.pdf")
    _, expected = make_scanned_book(pdf, pages=SCANNED_PAGES)
    _, _, cold = run_book(pdf, os.path.join(tmp, "scanned_cold"), cfg,
                          ocr=ocr, book_id="scanned")
    _, segs, warm = run_book(pdf, os.path.join(tmp, "scanned"), cfg,
                             ocr=ocr, book_id="scanned")
    scores = score_scanned(expected, segs)
    say(f"scanned {SCANNED_PAGES} pages (DB detector): first run "
        f"{cold:.3f} s (compile included), warm run {warm:.3f} s "
        f"({SCANNED_PAGES / warm:.3f} pages/s), {json.dumps(scores)}")
    check(scores["scanned_detected"] == SCANNED_PAGES,
          f"scanned pages detected {scores['scanned_detected']}")
    check(scores["scanned_ocr_cer"] <= BARS["scanned_ocr_cer"],
          f"scanned CER {scores['scanned_ocr_cer']}")
    return pdf


def _prepared(pdf: str, cfg, pages, n: int):
    """The first n prepared crops of a book (canvases, dims, ctxs), cut
    by the production prepare path."""
    import numpy as np

    from synapta_tpu.io.ingest import open_pdf
    from synapta_tpu.io.loader import prepare_batch
    from synapta_tpu.vision.detect import DetectionEngine

    doc, render_doc = open_pdf(pdf), open_pdf(pdf)
    engine = DetectionEngine(doc, cfg.detection, pixels_doc=render_doc)
    batch, errors = prepare_batch(engine, render_doc, cfg.detection.render_dpi,
                                  cfg.ocr.crop_size, list(pages))
    if errors or batch is None or len(batch[2]) < n:
        raise SmokeFailure(f"prepare of pages {pages} failed: {errors} "
                           f"errors, {0 if batch is None else len(batch[2])} "
                           f"crops")
    _, canvases, dims, _, _, ctxs = batch
    return (np.array(canvases[:n]), np.array(dims[:n], np.int32),
            list(ctxs[:n]))


def _box_iou(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / union if union > 0 else 0.0


def phase_device_vs_cpu(book_pdf: str, scanned_pdf: str, cfg, ocr):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from synapta_tpu.models.charset import decode_greedy_batch
    from synapta_tpu.models.detector import (
        DBLineDetector,
        detect_maps,
        load_det_params,
    )
    from synapta_tpu.models.recognizer import recognize
    from synapta_tpu.models.train import load_params
    from synapta_tpu.ops.features import (
        _SCALAR_KEYS,
        device_analyze,
        device_analyze_dispatch,
    )

    cpu = jax.devices("cpu")[0]
    cb = cfg.ocr.crop_batch

    # -- analyze chunk: 16 real crops ------------------------------------
    canvases, dims, ctxs = _prepared(book_pdf, cfg, range(0, 32), 2 * cb)
    chunk, sizes = canvases[:cb], dims[:cb]
    f_gpu, b_gpu = device_analyze(chunk, sizes=sizes)
    with jax.default_device(cpu):
        f_cpu, b_cpu = device_analyze(chunk, sizes=sizes)
    continuous = {"ring_score", "ring_radius", "circle_edge_density",
                  "ring_coverage", "variance", "kmeans_centers"}
    counts = [k for k in list(_SCALAR_KEYS) + ["kmeans_counts"]
              if k not in continuous]
    say("tolerance: analyze counts exact (integer pixel/component counts "
        "held in f32 below 2^24 are exact on any backend); continuous "
        "features rtol 1e-4, atol 1e-6 (f32 reductions summed in another "
        "order); line boxes exact (integer CC bounding boxes)")
    for k in counts:
        diff = np.abs(f_gpu[k] - f_cpu[k]).max()
        check(np.array_equal(f_gpu[k], f_cpu[k]),
              f"analyze count {k} differs GPU vs CPU (max |d| {diff})")
    worst = 0.0
    for k in sorted(continuous):
        ok = np.allclose(f_gpu[k], f_cpu[k], rtol=1e-4, atol=1e-6)
        rel = float(np.max(np.abs(f_gpu[k] - f_cpu[k])
                           / np.maximum(np.abs(f_cpu[k]), 1e-6)))
        worst = max(worst, rel)
        check(ok, f"analyze feature {k} differs GPU vs CPU (rel {rel})")
    check(np.array_equal(b_gpu, b_cpu), "line boxes differ GPU vs CPU")
    say(f"analyze chunk {cb}x{cfg.ocr.crop_size}^2 GPU==CPU: "
        f"{len(counts)} count features exact, {len(continuous)} continuous "
        f"max rel diff {worst:.3e}, line boxes identical")

    # -- recognizer: 128 real line tiles ---------------------------------
    tiles = []
    for i in (0, cb):
        t, _, _, _ = ocr.collect_tiles(canvases[i:i + cb], ctxs[i:i + cb])
        tiles.extend(t)
    nb = cfg.ocr.line_batch
    if len(tiles) < nb:
        raise SmokeFailure(f"only {len(tiles)} line tiles")
    x = np.stack(tiles[:nb])[..., None]
    params = load_params()

    @functools.partial(jax.jit, static_argnums=2)
    def probs(p, t, dtype):
        return jax.nn.softmax(
            recognize(p, t.astype(jnp.float32) / 255.0, dtype))

    p_gpu = np.asarray(probs(params, x, jnp.bfloat16))
    with jax.default_device(cpu):
        p_cpu = np.asarray(probs(params, x, jnp.bfloat16))
        p_f32 = np.asarray(probs(params, x, jnp.float32))
    s_gpu = decode_greedy_batch(p_gpu.argmax(-1))
    s_cpu = decode_greedy_batch(p_cpu.argmax(-1))
    same = float(np.mean([a == b for a, b in zip(s_gpu, s_cpu)]))
    dmax = float(np.abs(p_gpu - p_cpu).max())
    cost = float(np.abs(p_cpu - p_f32).max())
    tol = max(2e-2, cost)
    say("tolerance: recognizer greedy strings identical on >= 99% of "
        "lines; softmax within max(2e-2, the bf16 cost) — the network "
        "runs in bf16, and XLA fuses and rounds bf16 intermediates "
        "differently per backend, so two bf16 runs may differ as much as "
        "one differs from float32 (max |CPU bf16 - CPU f32| = "
        f"{cost:.3e} on these tiles)")
    say(f"recognizer {nb} tiles 32x384 GPU vs CPU: strings identical on "
        f"{same:.4f} of lines, softmax max |d| {dmax:.3e} (tolerance "
        f"{tol:.3e})")
    check(same >= 0.99, f"recognizer strings agree on {same}")
    check(dmax <= tol, f"recognizer softmax differs by {dmax} > {tol}")

    # -- DB detector on the scanned pages --------------------------------
    scan_canvases, _, scan_ctxs = _prepared(scanned_pdf, cfg,
                                            range(SCANNED_PAGES), SCANNED_PAGES)
    det = DBLineDetector(det_size=cfg.ocr.crop_size)
    s16 = scan_canvases.astype(np.uint16)
    gray = ((77 * s16[..., 0] + 150 * s16[..., 1] + 29 * s16[..., 2])
            >> 8).astype(np.float32)[..., None] / 255.0
    det_params = load_det_params()

    @functools.partial(jax.jit, static_argnums=2)
    def prob_map(p, g, dtype):
        return jax.nn.sigmoid(detect_maps(p, g, dtype)[..., 0])

    m_gpu = np.asarray(prob_map(det_params, gray, jnp.bfloat16))
    with jax.default_device(cpu):
        m_cpu = np.asarray(prob_map(det_params, gray, jnp.bfloat16))
        m_f32 = np.asarray(prob_map(det_params, gray, jnp.float32))
        det_cpu = DBLineDetector(det_size=cfg.ocr.crop_size)
        rows_cpu = det_cpu.detect_lines(scan_canvases, hires=scan_ctxs)
    rows_gpu = det.detect_lines(scan_canvases, hires=scan_ctxs)
    mmax = float(np.abs(m_gpu - m_cpu).max())
    mcost = float(np.abs(m_cpu - m_f32).max())
    mtol = max(2e-2, mcost)
    total = matched = 0
    for rg, rc in zip(rows_gpu, rows_cpu):
        for bx in rg:
            total += 1
            matched += any(_box_iou(bx, o) >= 0.9 for o in rc)
    frac = matched / max(total, 1)
    say("tolerance: DB probability maps within max(2e-2, the bf16 cost) "
        "(bf16 conv stack; max |CPU bf16 - CPU f32| = "
        f"{mcost:.3e} on these pages), >= 99% of line boxes matched at "
        "IoU >= 0.9 (a map value near the 0.3 threshold can move a box "
        "edge by a pixel)")
    say(f"DB detector {SCANNED_PAGES} pages GPU vs CPU: prob map max |d| "
        f"{mmax:.3e} (tolerance {mtol:.3e}), {matched}/{total} boxes "
        f"matched ({frac:.4f})")
    check(mmax <= mtol, f"DB probability maps differ by {mmax} > {mtol}")
    check(total > 0 and frac >= 0.99, f"DB boxes matched {frac}")

    # -- XLA timings: the bar for a future hand-written kernel -----------
    sizes_j = jnp.asarray(sizes)
    med, best = timed(lambda: device_analyze_dispatch(chunk, sizes=sizes_j))
    say(f"XLA analyze chunk {cb}x{cfg.ocr.crop_size}^2 (H2D included): "
        f"median {med * 1e3:.3f} ms, min {best * 1e3:.3f} ms")
    cc_med, cc_best = time_cc(chunk)
    say(f"XLA connected components inside that chunk (4 while_loops): "
        f"median {cc_med * 1e3:.3f} ms, min {cc_best * 1e3:.3f} ms")


def time_cc(chunk):
    """Time the four connected-components while_loops of one analyze
    chunk on its real masks, called as the analyze pass calls them
    (ops/features._component_censuses and ocr/linedet)."""
    import jax
    import numpy as np

    from synapta_tpu.ocr.linedet import fuse_text_mask
    from synapta_tpu.ops.cc import connected_components
    from synapta_tpu.ops.color import gray_quarter_host
    from synapta_tpu.ops.features import _core_features, _enclosed_mask
    from synapta_tpu.ops.filters import downsample2, downsample2_min

    gray, rgb_q = gray_quarter_host(chunk)
    feats = _core_features(gray, np.ascontiguousarray(rgb_q[:, ::2, ::2]))
    ink, vink, bg = feats["_ink"], feats["_vink"], feats["_bg"]

    @jax.jit
    def cc_pass(ink, vink, bg):
        return (
            connected_components(downsample2(ink), max_iters=6),
            connected_components(downsample2_min(vink), max_iters=4),
            connected_components(downsample2(_enclosed_mask(1.0 - bg)),
                                 connectivity=4, max_iters=6),
            connected_components(downsample2(fuse_text_mask(ink, 7)),
                                 max_iters=10),
        )

    return timed(cc_pass, ink, vink, bg)


def phase_serve(tmp: str, cfg):
    from synapta_tpu.io.pdf_writer import make_scanned_book, make_test_book
    from synapta_tpu.llm.fake import DisabledClient
    from synapta_tpu.serve import BookQueue

    a = os.path.join(tmp, "shelf_a.pdf")
    b = os.path.join(tmp, "shelf_b.pdf")
    make_test_book(a, pages=32, seed=7)
    make_scanned_book(b, pages=4, seed=2)
    q = BookQueue(output_root=os.path.join(tmp, "shelf"),
                  config=cfg.replace(use_mermaid=False),
                  llm_client=DisabledClient())
    q.add(a)
    q.add(b)
    t0 = time.perf_counter()
    manifest = q.run()
    wall = time.perf_counter() - t0
    books = manifest["books"]
    say(f"serve.BookQueue 2 books: {wall:.3f} s, " + ", ".join(
        f"{k}: {v['status']} pages={v['pages']} segments={v['segments']} "
        f"errors={v['errors']}" for k, v in books.items()))
    check(len(books) == 2 and all(
        v["status"] == "done" and v["errors"] == 0 and v["segments"] > 0
        for v in books.values()), "a served book failed")


def _leaf_diffs(a, b, path: str = ""):
    """(path, a, b) for every leaf where two JSON trees differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            yield from _leaf_diffs(a.get(k), b.get(k), f"{path}.{k}")
    elif (isinstance(a, list) and isinstance(b, list)
          and len(a) == len(b)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _leaf_diffs(x, y, f"{path}[{i}]")
    elif a != b:
        yield path, a, b


# fields decided on the host from the PDF alone: a sharded run must
# reproduce them exactly
HOST_FIELDS = ("segment_id", "page_no", "bbox", "caption_text",
               "figure_number", "extraction_method", "image_path")


def compare_segments(one: list, four: list) -> None:
    """Segments of the one-GPU and four-GPU runs: host-decided fields and
    segment types identical, OCR block texts identical on >= 99% of
    blocks (the bf16 recognizer runs at another per-device batch, so
    its rounding may differ), every other difference listed."""
    import re

    check(len(one) == len(four) > 0,
          f"segment counts differ: {len(one)} vs {len(four)}")
    diffs = list(_leaf_diffs(one, four))
    groups: dict = {}
    resized = 0  # blocks of segments whose block lists differ in length
    for path, a, b in diffs:
        key = re.sub(r"\[\d+\]", "[]", path)
        if key == "[].ocr_result.blocks":
            resized += max(len(a or []), len(b or []))
        n, worst = groups.get(key, (0, 0.0))
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            worst = max(worst, abs(float(a) - float(b)))
        groups[key] = (n + 1, worst)
    n_blocks = sum(len(seg["ocr_result"]["blocks"]) for seg in one
                   if seg.get("ocr_result"))
    texts = groups.get("[].ocr_result.blocks[].text", (0, 0.0))[0] + resized
    host = [k for k in groups if k.split(".")[1] in HOST_FIELDS
            or k == "[].segment_type"]
    say(f"1-GPU vs 4-GPU segments: {len(diffs)} differing leaves in "
        f"{len(groups)} fields; OCR block texts identical on "
        f"{1 - texts / max(n_blocks, 1):.4f} of {n_blocks} blocks")
    for k, (n, worst) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:15]:
        say(f"  differs: {k} x{n}"
            + (f", max |d| {worst:.4g}" if worst else ""))
    check(not host, f"host-decided fields differ: {host}")
    check(texts <= 0.01 * n_blocks,
          f"OCR texts differ on {texts} of {n_blocks} blocks")


def phase_four(tmp: str, cfg):
    """The born-digital book sharded over four GPUs against one GPU, on a
    {'data': 4} mesh."""
    from synapta_tpu.io.pdf_writer import make_test_book

    pdf = os.path.join(tmp, "book.pdf")
    make_test_book(pdf, pages=BOOK_PAGES, seed=BOOK_SEED)
    payloads = {}
    for n in (1, 4):
        out = os.path.join(tmp, f"dev{n}")
        c = cfg.replace(data_devices=n)
        pipe, segs, cold = run_book(pdf, out, c)
        _, _, warm = run_book(pdf, out + "w", c, ocr=pipe.ocr)
        mesh = dict(pipe.mesh.shape)
        check(mesh == {"data": n}, f"mesh {mesh} for data_devices={n}")
        with open(os.path.join(out + "w", "book_visual_segments.json")) as f:
            payload = json.load(f)
        for seg in payload["segments"]:
            seg["image_path"] = os.path.basename(seg["image_path"])
        payloads[n] = payload["segments"]
        say(f"data_devices={n}: mesh={mesh} first run {cold:.3f} s, warm "
            f"{warm:.3f} s ({BOOK_PAGES / warm:.3f} pages/s), "
            f"segments={len(segs)}")
    if payloads[1] == payloads[4]:
        say(f"4-GPU segments identical to 1-GPU: {len(payloads[4])} segments")
    else:
        compare_segments(payloads[1], payloads[4])


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded book")
    args = ap.parse_args(argv)

    import jax

    require_gpu(jax.default_backend())
    n_dev = 4 if args.four else 1
    if len(jax.devices()) < n_dev:
        raise SmokeFailure(f"need {n_dev} GPUs, JAX sees "
                           f"{len(jax.devices())}")
    subprocess.run(["make", "-C", os.path.join(REPO, "native"),
                    f"-j{os.cpu_count() or 1}"], check=True,
                   stdout=subprocess.DEVNULL)

    from synapta_tpu.config import PipelineConfig
    from synapta_tpu.utils.jaxsetup import compile_cache_dir, setup_jax

    setup_jax()
    cards = nvidia_smi()
    CARD = cards[0]
    dev = jax.devices()[0]
    say(f"devices: {len(jax.devices())} x {dev.device_kind} "
        f"(platform {dev.platform}); compile cache {compile_cache_dir()}")
    cfg = PipelineConfig(use_vision_llm=False, use_mermaid=False)
    got = {"crop_size": cfg.ocr.crop_size, "crop_batch": cfg.ocr.crop_batch,
           "line_batch": cfg.ocr.line_batch,
           "line_height": cfg.ocr.line_height,
           "line_max_width": cfg.ocr.line_max_width,
           "pages_per_batch": cfg.pages_per_batch,
           "analyze_depth": cfg.analyze_depth,
           "recognize_depth": cfg.recognize_depth}
    if got != SHAPES:
        raise SmokeFailure(f"config shapes {got} != production {SHAPES}")
    say(f"shapes: {json.dumps(got)}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.four:
            phase_four(tmp, cfg)
        else:
            cfg = cfg.replace(data_devices=1)
            book, ocr = phase_born_digital(tmp, cfg)
            scanned = phase_scanned(tmp, cfg, ocr)
            phase_device_vs_cpu(book, scanned, cfg, ocr)
            phase_serve(tmp, cfg)

    if FAILURES:
        raise SmokeFailure(f"{len(FAILURES)} check(s) failed: "
                           + "; ".join(FAILURES))
    for line in cards:
        print(line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
