"""On-device OCR stack: recognizer accuracy on synthetic tiles, processor
surface, junk gating, degradation paths."""
import os

import numpy as np
import pytest

from synapta_tpu.models.train import WEIGHTS_PATH


def _line_tile_reference(cfg, crop, box, ctx=None):
    """Python + Pillow reference for one OCR line tile: the recognizer was
    trained on tiles built exactly this way (integer luma, 1-99 percentile
    stretch, Pillow BILINEAR resize to the tile height, white padding).
    ``ctx`` = (hires_image, ratio) cuts the tile from the hires render."""
    from PIL import Image

    target_h = cfg.line_height - 4
    x0, y0, x1, y1 = box
    src = crop
    if ctx is not None:
        hires, ratio = ctx
        if hires is not None and ratio > 1.001:
            src = hires
            x0 = int(x0 * ratio)
            y0 = int(y0 * ratio)
            x1 = int(np.ceil(x1 * ratio))
            y1 = int(np.ceil(y1 * ratio))
    pad = 2
    yy0 = max(0, y0 - pad)
    xx0 = max(0, x0 - pad)
    # a fully-off-image box yields an EMPTY slice (white tile), not a
    # wrap-around through numpy's negative indexing
    yy1 = max(0, min(src.shape[0], y1 + pad))
    xx1 = max(0, min(src.shape[1], x1 + pad))
    sub = src[yy0:yy1, xx0:xx1]
    if sub.size == 0:
        sub = np.full((8, 8, 3), 255, np.uint8)
    s16 = sub.astype(np.uint16)
    gray = ((77 * s16[..., 0] + 150 * s16[..., 1] + 29 * s16[..., 2])
            >> 8).astype(np.uint8)
    cum = np.cumsum(np.bincount(gray.ravel(), minlength=256))
    n_px = cum[-1]
    lo = float(np.searchsorted(cum, 0.01 * n_px))
    hi = float(np.searchsorted(cum, 0.99 * n_px))
    if hi - lo > 30.0:
        gray = np.clip((gray.astype(np.float32) - lo) * (255.0 / (hi - lo)),
                       0.0, 255.0).astype(np.uint8)
    h, w = gray.shape
    new_w = max(1, min(int(w * target_h / max(h, 1)), cfg.line_max_width))
    img = Image.fromarray(gray).resize((new_w, target_h), Image.BILINEAR)
    tile = np.full((cfg.line_height, cfg.line_max_width), 255, np.uint8)
    tile[2:2 + target_h, :new_w] = np.asarray(img)
    return tile

needs_weights = pytest.mark.skipif(
    not os.path.exists(WEIGHTS_PATH), reason="weights not trained"
)


@pytest.fixture(scope="module")
def ocr():
    from synapta_tpu.ocr.processor import TPUOCR

    if not os.path.exists(WEIGHTS_PATH):
        pytest.skip("weights not trained")
    return TPUOCR()


@needs_weights
def test_recognize_synthetic_tiles(ocr):
    from synapta_tpu.models.synthdata import make_batch
    from synapta_tpu.models import charset
    from synapta_tpu.models.train import cer

    rng = np.random.default_rng(123)
    imgs, labels, lens = make_batch(rng, batch=32)
    recs = ocr.recognize_tiles(imgs[..., 0])
    total = 0.0
    for i, rec in enumerate(recs):
        ref = "".join(
            charset.ID_TO_CHAR.get(int(c), "") for c in labels[i][: lens[i]]
        )
        total += cer(ref, rec["text"])
    assert total / len(recs) < 0.05, f"CER {total / len(recs):.3f}"
    assert all(r["confidence"] > 60 for r in recs)


@needs_weights
def test_process_batch_blank_crops(ocr):
    blank = np.full((2, 512, 512, 3), 255, np.uint8)
    out = ocr.process_batch(blank)
    assert len(out) == 2
    assert all(o.raw_text == "" and o.confidence == 0.0 for o in out)


@needs_weights
def test_process_batch_schema(ocr):
    from synapta_tpu.io.ingest import open_pdf
    from synapta_tpu.io.pdf_writer import make_test_book

    make_test_book("/tmp/ocr_t.pdf", pages=3, seed=4)
    doc = open_pdf("/tmp/ocr_t.pdf")
    arr = doc.render(1, dpi=72 * 512 / 360, clip=[110, 180, 470, 437])
    cv = np.full((1, 512, 512, 3), 255, np.uint8)
    cv[0, : arr.shape[0], : arr.shape[1]] = arr[:512, :512]
    out = ocr.process_batch(cv, sizes=[(arr.shape[0], arr.shape[1])])
    o = out[0]
    assert o.blocks and o.raw_text
    for b in o.blocks:
        assert set(b) == {"text", "bbox", "confidence"}
        assert 0 <= b["confidence"] <= 100
        assert len(b["bbox"]) == 4
    assert 0.0 < o.confidence <= 1.0  # mean normalized to 0-1 (ref :1190)
    assert "Q1" in o.raw_text  # tick label
    assert any("Figure" in b["text"] for b in o.blocks)  # caption line


def test_ring_coverage_separates_pie_from_boxes():
    from synapta_tpu.io.ingest import open_pdf
    from synapta_tpu.io.pdf_writer import make_test_book
    from synapta_tpu.ops.features import extract_crop_features

    make_test_book("/tmp/ring_t.pdf", pages=8, seed=6)
    doc = open_pdf("/tmp/ring_t.pdf")
    crops, dims = [], []
    for page, clip in [(5, [130, 190, 450, 425]), (3, [140, 180, 460, 455])]:
        s = 512 / max(clip[2] - clip[0], clip[3] - clip[1])
        arr = doc.render(page, dpi=72 * s, clip=clip)
        cv = np.full((512, 512, 3), 255, np.uint8)
        cv[: arr.shape[0], : arr.shape[1]] = arr[:512, :512]
        crops.append(cv)
        dims.append((arr.shape[0], arr.shape[1]))
    f = extract_crop_features(np.stack(crops), sizes=np.array(dims, np.int32))
    pie_cov, flow_cov = float(f["ring_coverage"][0]), float(f["ring_coverage"][1])
    assert pie_cov > 0.8, pie_cov          # full circle covers all angles
    assert flow_cov < 0.8, flow_cov        # boxes/diamond don't


def test_old_algo_client_fallbacks():
    from synapta_tpu.llm.pixtral import PixtralClient
    from synapta_tpu.schema import VisualType

    c = PixtralClient(api_key="")
    vt, conf, method = c.classify_visual(np.zeros((4, 4, 3), np.uint8), None)
    assert (vt, conf, method) == (VisualType.FIGURE, 0.3, "fallback_heuristic")
    summary, sconf = c.generate_summary(
        np.zeros((4, 4, 3), np.uint8), VisualType.CHART, None, None
    )
    assert summary is None and sconf == 0.0


def test_native_line_tiles_bit_identical_to_python():
    """The native batched tile builder (io/ingest.line_tiles_native,
    native/src/api.cc spdf_line_tiles) must reproduce the Python/Pillow
    reference tile bit-for-bit: the recognizer was trained on such tiles,
    so any resampling drift is silent accuracy loss. Covers random noise,
    text-like strokes, off-image boxes, degenerate boxes, and hires-ratio
    scaled boxes."""
    from synapta_tpu.config import OCRConfig
    from synapta_tpu.io.ingest import line_tiles_native

    cfg = OCRConfig()
    rng = np.random.default_rng(7)
    for trial in range(60):
        H = int(rng.integers(8, 700))
        W = int(rng.integers(8, 1100))
        img = rng.integers(0, 256, (H, W, 3), np.uint8)
        if trial % 2 == 0:  # text-like: white bg, dark strokes
            img[:] = 255
            for _ in range(25):
                y = int(rng.integers(0, H))
                x = int(rng.integers(0, W))
                img[y:y + 2, x:x + int(rng.integers(2, 50))] = int(
                    rng.integers(0, 90))
        boxes = []
        for _ in range(6):
            x0 = int(rng.integers(-6, W))
            y0 = int(rng.integers(-6, H))
            boxes.append([x0, y0, x0 + int(rng.integers(1, 600)),
                          y0 + int(rng.integers(1, 70))])
        boxes.append([W + 5, H + 5, W + 9, H + 9])  # fully off-image
        arr = np.array(boxes, np.int32)
        res = line_tiles_native(img, arr, cfg.line_height,
                                cfg.line_max_width)
        assert res is not None, "native engine missing spdf_line_tiles"
        tiles, cw = res
        py = np.stack([_line_tile_reference(cfg, img, list(b))
                       for b in boxes])
        assert np.array_equal(py, tiles), f"tile drift on trial {trial}"
        assert (cw >= 1).all() and (cw <= cfg.line_max_width).all()


def test_crop_tiles_matches_line_tile_with_hires_ctx():
    """_crop_tiles (the batched call site) applies the same hires-ratio
    box scaling as the reference tile, so pixels are identical both with
    and without a render ctx."""
    from synapta_tpu.config import OCRConfig
    from synapta_tpu.ocr.processor import TPUOCR

    shim = TPUOCR.__new__(TPUOCR)
    shim.cfg = OCRConfig()
    rng = np.random.default_rng(11)
    crop = rng.integers(0, 256, (180, 260, 3), np.uint8)
    hires = rng.integers(0, 256, (360, 520, 3), np.uint8)
    segs = [[10, 20, 120, 40], [0, 0, 259, 25], [200, 150, 260, 180]]
    for ctx in (None, (hires, 2.0)):
        batched = TPUOCR._crop_tiles(shim, crop, segs, ctx)
        single = [_line_tile_reference(shim.cfg, crop, s, ctx) for s in segs]
        for b, s in zip(batched, single):
            assert np.array_equal(b, s)
