"""LLM-on validation at full book scale (VERDICT r2 item 5).

Runs the 1,000-page bench book twice — vision-LLM disabled, then with a
latency-injecting fake client (default 2 s/call, the measured
api.mistral.ai comprehensive-call latency from the reference's serial
path, ref pdf_image_segmentation.py:615,853,999) — and reports the wall
-time delta plus the late-patch accounting (llm_patches /
llm_unpatched / llm_drain_wait_s from PipelineStats).

Pass criterion (VERDICT): LLM-on wall time within 5% of LLM-off at
1,000 pages, all segments patched or accounted for.

Usage:  python scripts/llm_at_scale.py [--pages 1000] [--delay 2.0]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("SYNAPTA_LOG_LEVEL", "WARNING")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pages", type=int, default=1000)
    ap.add_argument("--delay", type=float, default=2.0)
    # Pool sizing is Little's law, not taste: at full pipeline throughput
    # the pipeline emits ~1.3 calls/page -> ~26 calls/s over a 1,000-page
    # book, and 2 s/call latency means ~52 calls permanently in flight.
    # 64 network-bound threads cover that with margin; the reference by
    # contrast ran every call serially inline (ref :615,853,999).
    ap.add_argument("--workers", type=int, default=64)
    args = ap.parse_args()

    from synapta_tpu.utils.jaxsetup import setup_jax

    setup_jax()
    from synapta_tpu.config import PipelineConfig
    from synapta_tpu.io.pdf_writer import make_test_book
    from synapta_tpu.llm.fake import FakePixtralClient
    from synapta_tpu.ocr.processor import TPUOCR
    from synapta_tpu.pipeline import VisualSegmentationPipeline

    class DelayedFakeClient(FakePixtralClient):
        """Futures resolve after a real delay on a thread pool — models
        the external vision-LLM's per-call latency (same harness as
        tests/test_llm_async.py)."""

        def __init__(self, delay: float, workers: int = 64, **kw):
            super().__init__(**kw)
            self.delay = delay
            self._pool = ThreadPoolExecutor(max_workers=workers)

        def _delayed(self, fn, *a):
            # no pixel copies needed: the pipeline snapshots ring-view
            # pixels once per segment before any submit (_snap_pixels)

            def work():
                time.sleep(self.delay)
                return fn(*a)

            return self._pool.submit(work)

        def submit_comprehensive(self, pixels, ocr):
            return self._delayed(self.analyze_comprehensive, pixels, ocr)

        def submit_mermaid(self, pixels, visual_type, ocr):
            return self._delayed(self.extract_mermaid, pixels, visual_type, ocr)

        def submit_calculations(self, pixels, ocr, nearby):
            return self._delayed(self.extract_calculations, pixels, ocr, nearby)

        def shutdown(self):
            self._pool.shutdown(wait=True)

    # same cached fixture scheme as bench.py
    import synapta_tpu.io.pdf_writer as _pw

    cache_dir = os.path.join(tempfile.gettempdir(), "synapta_bench_books")
    os.makedirs(cache_dir, exist_ok=True)
    gen_hash = hashlib.md5(open(_pw.__file__, "rb").read()).hexdigest()[:10]
    pdf_path = os.path.join(cache_dir, f"textbook_p{args.pages}_s42_{gen_hash}.pdf")
    if not os.path.exists(pdf_path):
        tmp_pdf = pdf_path + ".tmp"
        make_test_book(tmp_pdf, pages=args.pages, seed=42)
        os.replace(tmp_pdf, pdf_path)

    tmp = tempfile.mkdtemp(prefix="synapta_llmscale_")
    ocr = TPUOCR()  # share one recognizer/executable set across both runs

    def run(tag: str, client):
        pipe = VisualSegmentationPipeline(
            book_id=f"llmscale_{tag}",
            pdf_path=pdf_path,
            output_dir=os.path.join(tmp, tag),
            use_mermaid=client is not None,
            config=PipelineConfig(use_vision_llm=False),
            llm_client=client,
            ocr=ocr,
            resume=False,
        )
        t0 = time.time()
        pipe.process()
        wall = time.time() - t0
        return wall, pipe.stats, len(pipe.writer.segments)

    # warmup pays compile/cache-load once
    warm = os.path.join(tmp, "warm.pdf")
    make_test_book(warm, pages=8, seed=7)
    pw = VisualSegmentationPipeline(
        book_id="warm", pdf_path=warm, output_dir=os.path.join(tmp, "warm"),
        config=PipelineConfig(use_vision_llm=False), ocr=ocr, resume=False,
    )
    pw.process()

    base_wall, base_stats, base_segs = run("off", None)
    llm_wall, llm_stats, llm_segs = run(
        "on", DelayedFakeClient(args.delay, workers=args.workers)
    )
    out = {
        "pages": args.pages,
        "delay_s": args.delay,
        "workers": args.workers,
        "wall_off_s": round(base_wall, 2),
        "wall_on_s": round(llm_wall, 2),
        "overhead_pct": round(100 * (llm_wall - base_wall) / base_wall, 2),
        "segments_off": base_segs,
        "segments_on": llm_segs,
        "llm_patches": llm_stats.llm_patches,
        "llm_unpatched": llm_stats.llm_unpatched,
        "llm_drain_wait_s": llm_stats.llm_drain_wait_s,
        "errors_off": base_stats.errors,
        "errors_on": llm_stats.errors,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
