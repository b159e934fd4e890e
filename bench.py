"""End-to-end benchmark: pages/sec/chip on a synthetic textbook_001.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
Baseline target (BASELINE.md): a 1,000-page book in < 60 s/chip
== 16.67 pages/s; vs_baseline is measured_pages_per_s / 16.67.

The run is the full local pipeline — native PDF parse + metadata
extraction, two-pass detection, region rasterization, batched device
features + OCR, heuristic classification, per-type payloads, structured
text, caption re-detection, concept linking, JSONL+JSON+CSV+PNG outputs —
with the network vision-LLM disabled (it is off the critical path by
design and externally bound).
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

os.environ.setdefault("SYNAPTA_LOG_LEVEL", "WARNING")

BASELINE_PAGES_PER_S = 1000.0 / 60.0

def main() -> None:
    from synapta_tpu.utils.jaxsetup import setup_jax

    setup_jax()
    from synapta_tpu.config import PipelineConfig
    from synapta_tpu.io.pdf_writer import make_test_book
    from synapta_tpu.io.xlsx import write_xlsx
    from synapta_tpu.pipeline import VisualSegmentationPipeline

    # default = the BASELINE.md target size (1,000-page book, < 60s/chip).
    # Generation of the synthetic book takes ~2 min of host CPU, so the
    # fixture is cached across bench invocations keyed by (pages, seed).
    pages = int(os.environ.get("SYNAPTA_BENCH_PAGES", "1000"))
    tmp = tempfile.mkdtemp(prefix="synapta_bench_")
    cache_dir = os.path.join(tempfile.gettempdir(), "synapta_bench_books")
    os.makedirs(cache_dir, exist_ok=True)
    # cache key includes a hash of the generator source: editing
    # pdf_writer.py must invalidate cached books, or throughput numbers
    # silently compare runs over different input content
    import hashlib

    import synapta_tpu.io.pdf_writer as _pw

    gen_hash = hashlib.md5(open(_pw.__file__, "rb").read()).hexdigest()[:10]
    pdf_path = os.path.join(
        cache_dir, f"textbook_p{pages}_s42_{gen_hash}.pdf"
    )
    if not os.path.exists(pdf_path):
        gen_path = pdf_path + ".tmp"
        make_test_book(gen_path, pages=pages, seed=42)
        os.replace(gen_path, pdf_path)
    tax_path = os.path.join(tmp, "taxonomy.xlsx")
    write_xlsx(
        tax_path,
        [["Level", "Concept", "Tag(s)", "Rationale", "Page(s)"]]
        + [
            ["1", c, t, "", ""]
            for c, t in [
                ("Portfolio Diversification", "risk variance"),
                ("Expected Return", "mean"),
                ("Risk-Free Rate", "treasury"),
                ("Asset Allocation", "weights"),
                ("Utility Maximization", "preference"),
                ("Cumulative Performance", "stocks bonds"),
                ("Quarterly Returns", "periods"),
                ("Investment Decision Process", "screening approval"),
            ]
        ],
    )

    def run(book_id: str, pdf: str) -> float:
        cfg = PipelineConfig(use_vision_llm=False)
        pipe = VisualSegmentationPipeline(
            book_id=book_id,
            pdf_path=pdf,
            taxonomy_path=tax_path,
            output_dir=os.path.join(tmp, book_id),
            use_mermaid=False,
            config=cfg,
            resume=False,
        )
        t0 = time.time()
        pipe.process()
        return time.time() - t0

    # warmup: pays XLA compile / cache load on a tiny book
    warm_pdf = os.path.join(tmp, "warm.pdf")
    make_test_book(warm_pdf, pages=8, seed=7)
    run("warmup", warm_pdf)

    # best of N (default 3): the best run reflects steady-state
    # throughput; every run is reported beside it.
    runs = int(os.environ.get("SYNAPTA_BENCH_RUNS", "3"))
    walls = [
        run(f"textbook_{1 + i:03d}", pdf_path) for i in range(max(runs, 1))
    ]
    wall = min(walls)
    pages_per_s = pages / wall
    per_run = [round(pages / w, 3) for w in walls]
    print(
        json.dumps(
            {
                "metric": "pages_per_sec_per_chip_end_to_end_textbook_001",
                "value": round(pages_per_s, 3),
                "unit": "pages/s",
                "vs_baseline": round(pages_per_s / BASELINE_PAGES_PER_S, 3),
                # every rep's pages/s plus the spread (max-min)/max, so
                # a capture carries its own variance record
                "runs": per_run,
                "spread": round(
                    (max(per_run) - min(per_run)) / max(per_run), 3
                ),
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
