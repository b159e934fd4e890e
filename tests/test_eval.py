"""Accuracy-harness smoke test (small book, hermetic)."""
import os

import pytest

from synapta_tpu.models.train import WEIGHTS_PATH


@pytest.mark.skipif(
    not os.path.exists(WEIGHTS_PATH), reason="recognizer weights not trained"
)
def test_eval_harness_small():
    from synapta_tpu.eval import evaluate_book

    r = evaluate_book(pages=4, seed=5)
    assert r["detection_recall@0.5"] == 1.0
    assert r["mean_iou"] > 0.8
    assert r["n_detected"] >= r["n_truth_visuals"]
    # HARD bar, not a smoke bound: a round-3 recognizer retrain regressed
    # full-book clean CER 0.025 -> 0.095 (small-text confusions: fund->rud,
    # 25->2s) while the line-level train eval IMPROVED to 0.0029, and the
    # old `0 <= cer <= 1` assert let it land. Weights must clear the
    # BASELINE.md-parity bar on the BOOK eval, not just training batches.
    assert r["ocr_cer"] <= 0.06, r


@pytest.mark.skipif(
    not os.path.exists(WEIGHTS_PATH), reason="recognizer weights not trained"
)
def test_scanned_page_ocr():
    """Scanned-page fixture (VERDICT round-1 item 4): full-page noisy
    raster of real text must be detected and OCR'd with bounded CER."""
    from synapta_tpu.eval import evaluate_scanned

    r = evaluate_scanned(pages=1, seed=1)
    assert r["scanned_detected"] == 1
    # target bar (BASELINE.md): dense scanned-page lines split at
    # whitespace valleys so the CTC frame budget covers every character
    # (full 4-page eval measures 0.014; one page leaves margin for seed
    # variation)
    assert r["scanned_ocr_cer"] <= 0.05, r


def test_scanned_throughput_floor():
    """Dense-scan throughput gets a tested floor on the CPU backend the
    suite runs on, so a pathological regression (e.g. a per-crop
    recompile) cannot land silently. The accelerator's bar lives in
    chip_smoke.py, which runs the scanned book on the card."""
    from synapta_tpu.eval import evaluate_scanned

    pages = 4
    evaluate_scanned(pages=2, seed=3)  # warm the executables
    r = evaluate_scanned(pages=pages, seed=1)
    assert r["scanned_detected"] == pages
    assert r["scanned_ocr_cer"] <= 0.05, r
    assert r["scanned_pages_per_s"] >= 0.05, r
