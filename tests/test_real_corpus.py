"""The REAL textbook crops, end to end (VERDICT r4 item 2).

/root/reference/investments_segmented/ holds 591 segment crops the
reference pipeline extracted from a real 1,000-page finance textbook —
genuinely out-of-distribution content this repo's synthetic generators
never produced. This test stitches a 30-crop subset into an
image-per-page PDF (the same path `scripts/real_corpus_r5.py` uses for
the full 591) and runs the full pipeline: every page must yield an
embedded-image segment, zero errors may be swallowed, and OCR /
classification must produce sane, non-degenerate output.

`scripts/real_corpus_r5.py` runs the full corpus; this is the
suite-sized guard that the real-data path stays green.
"""
import importlib.util
import os

import pytest

CORPUS = "/root/reference/investments_segmented"
SCRIPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "scripts", "real_corpus_r5.py",
)


def _load_script():
    spec = importlib.util.spec_from_file_location("real_corpus_r5", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_real_corpus_subset_end_to_end(tmp_path):
    if not os.path.isdir(CORPUS):
        pytest.skip("real corpus not present")
    mod = _load_script()
    pdf = str(tmp_path / "real30.pdf")
    n = mod.build_book(pdf, limit=30)
    assert n == 30
    res = mod.run(pdf, str(tmp_path / "out"), n)

    # every real crop page must surface as an embedded-image segment
    assert res["pages_with_embedded_segment"] == 30, res
    assert res["segments"] >= 30, res
    assert res["swallowed_errors"] == 0, res
    # classification must not be degenerate (measured r5: charts, images,
    # figures, flowcharts, diagrams across the first 30 crops)
    assert len(res["classification_histogram"]) >= 3, res
    # OCR must read real print: measured mean block confidence 0.88 on
    # this subset; bar set loose enough to absorb checkpoint drift
    assert res["segments_with_text"] >= 15, res
    assert res["mean_ocr_confidence"] >= 0.6, res
    assert res["ocr_blocks"] >= 150, res
    # real finance-textbook vocabulary must come through the OCR text
    assert res["finance_terms_found"] >= 2, res
