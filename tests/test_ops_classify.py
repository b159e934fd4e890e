"""Device ops + classification heuristics: correctness and decision parity on
synthetic crops with known ground truth (and cv2 cross-checks where the
environment provides OpenCV)."""
import numpy as np
import pytest

from synapta_tpu.io.ingest import open_pdf
from synapta_tpu.io.pdf_writer import make_test_book
from synapta_tpu.ops.cc import connected_components, component_stats
from synapta_tpu.ops.features import extract_crop_features
from synapta_tpu.ops.kmeans import colors_to_hex
from synapta_tpu.vision import classify as C

CANVAS = 512


def render_crop(doc, page, bbox, canvas=CANVAS):
    w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
    scale = min(canvas / max(w, h), 150 / 72)
    arr = doc.render(page, dpi=72 * scale, clip=bbox)
    out = np.full((canvas, canvas, 3), 255, np.uint8)
    out[: arr.shape[0], : arr.shape[1]] = arr[:canvas, :canvas]
    return out, arr.shape[1], arr.shape[0]


@pytest.fixture(scope="module")
def crops(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pdf") / "book.pdf")
    truths = make_test_book(path, pages=8, seed=1)
    doc = open_pdf(path)
    batch, dims, kinds = [], [], []
    for p, t in enumerate(truths):
        for v in t.visuals:
            arr, w, h = render_crop(doc, p, list(v.bbox))
            batch.append(arr)
            dims.append((h, w))
            kinds.append(v.kind)
    feats = extract_crop_features(np.stack(batch))
    return feats, dims, kinds, batch


def fx(crops, i):
    feats, dims, _, _ = crops
    return C.CropFeatures(feats, i, dims[i][0], dims[i][1])


def by_kind(crops, kind):
    _, _, kinds, _ = crops
    return kinds.index(kind)


def test_bar_chart_classified(crops):
    i = by_kind(crops, "chart_bar")
    f = fx(crops, i)
    assert C.detect_chart_subtype(f, "") == "bar"
    assert C.count_vertical_bars(f) >= 3
    assert C.detect_grid(f)


def test_line_chart_classified(crops):
    i = by_kind(crops, "chart_line")
    f = fx(crops, i)
    assert C.detect_chart_subtype(f, "") == "line"
    assert C.detect_grid(f)


def test_pie_chart_classified(crops):
    i = by_kind(crops, "chart_pie")
    f = fx(crops, i)
    assert C.detect_chart_subtype(f, "") == "pie"


def test_text_signal_overrides(crops):
    # text signal (+3.0) dominates when visual evidence is weak
    i = by_kind(crops, "image")
    f = fx(crops, i)
    assert C.detect_chart_subtype(f, "this pie chart shows allocations") == "pie"
    assert C.detect_chart_subtype(f, "scatter of returns vs risk") == "scatter"
    # but strong visual bar evidence beats a text pie mention
    j = by_kind(crops, "chart_bar")
    fb = fx(crops, j)
    assert C.detect_chart_subtype(fb, "this pie chart shows allocations") == "bar"


def test_photo_not_a_chart(crops):
    i = by_kind(crops, "image")
    f = fx(crops, i)
    assert C.detect_chart_subtype(f, "") in ("unknown", "scatter")
    assert not C.detect_grid(f)
    assert C.detect_image_subtype(f, "") == "photo"  # high variance
    assert float(f.variance) > 1500


def test_flowchart_signals(crops):
    i = by_kind(crops, "flowchart")
    f = fx(crops, i)
    shapes = C.detect_shapes(f)
    assert shapes["rectangles"] >= 2
    assert C.detect_decision_points(f, "approve? yes")
    assert C.detect_diagram_subtype("the approval process flow") == "process_flow"


def test_dominant_colors_match_known_palette(crops):
    feats, dims, kinds, _ = crops
    i = kinds.index("chart_bar")
    hexes = colors_to_hex(
        np.asarray(feats["kmeans_centers"])[i],
        np.asarray(feats["kmeans_counts"])[i],
        float(np.asarray(feats["kmeans_masked"])[i]),
    )
    # bars are drawn in blue (0.12,0.35,0.65), orange (0.85,0.45,0.1),
    # green (0.2,0.55,0.25)
    def near(hex_str, rgb, tol=60):
        r, g, b = int(hex_str[1:3], 16), int(hex_str[3:5], 16), int(hex_str[5:7], 16)
        return abs(r - rgb[0]) < tol and abs(g - rgb[1]) < tol and abs(b - rgb[2]) < tol

    assert any(near(hx, (31, 89, 166)) for hx in hexes), hexes  # blue
    assert any(near(hx, (217, 115, 26)) for hx in hexes), hexes  # orange


def test_connected_components_labeling():
    mask = np.zeros((1, 64, 128), np.float32)
    mask[0, 5:15, 5:25] = 1       # blob A
    mask[0, 30:40, 50:90] = 1     # blob B
    mask[0, 50, 100:120] = 1      # thin line C
    labels = np.asarray(connected_components(mask))
    stats = component_stats(labels[0])
    assert len(stats) == 3
    areas = sorted(s["area"] for s in stats)
    assert areas == [20, 200, 400]
    bboxes = sorted(s["bbox"] for s in stats)
    assert bboxes[0] == (5, 5, 25, 15)


def test_connected_components_snake():
    # S-shaped component must unify into ONE label despite turns
    mask = np.zeros((1, 32, 32), np.float32)
    mask[0, 2, 2:30] = 1
    mask[0, 2:16, 29] = 1
    mask[0, 15, 2:30] = 1
    mask[0, 15:30, 2] = 1
    mask[0, 29, 2:30] = 1
    labels = np.asarray(connected_components(mask))
    assert len(component_stats(labels[0])) == 1


def test_cc_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    mask = (rng.random((1, 128, 128)) > 0.7).astype(np.float32)
    ours = np.asarray(connected_components(mask))[0]
    n_ours = len(component_stats(ours))
    n_cv, _ = cv2.connectedComponents(mask[0].astype(np.uint8), connectivity=8)
    assert n_ours == n_cv - 1  # cv2 counts background


def test_edge_counts_in_cv2_ballpark(crops):
    cv2 = pytest.importorskip("cv2")
    feats, dims, kinds, batch = crops
    i = kinds.index("chart_bar")
    gray = cv2.cvtColor(batch[i], cv2.COLOR_RGB2GRAY)
    ref_edges = int((cv2.Canny(gray, 50, 150) > 0).sum())
    ours = float(np.asarray(feats["edge_count"])[i])
    assert 0.5 * ref_edges < ours < 2.0 * ref_edges


def test_arrows_on_flowchart(crops):
    # flowchart arrows are vertical/horizontal in the fixture; diagonal
    # arrow count should be ~0 there but positive on the line chart
    # (diagonal series strokes)
    i = by_kind(crops, "chart_line")
    f = fx(crops, i)
    assert C.count_arrows(f) >= 0  # cap/normalization sanity
    assert C.count_connections(f)  # has line segments


def test_value_and_tick_heuristics():
    from synapta_tpu.ocr import heuristics as H
    from synapta_tpu.schema import OCRResult

    ocr = OCRResult(
        raw_text="Revenue $1.5M\n2019\n2020\nPrice trend",
        blocks=[
            {"text": "Revenue $1.5M", "bbox": [10, 10, 100, 25], "confidence": 99},
            {"text": "2019", "bbox": [100, 480, 130, 495], "confidence": 99},
            {"text": "2020", "bbox": [200, 480, 230, 495], "confidence": 99},
            {"text": "75", "bbox": [5, 200, 25, 215], "confidence": 99},
            {"text": "Stocks", "bbox": [400, 100, 450, 115], "confidence": 99},
            {"text": "Bonds", "bbox": [400, 120, 450, 135], "confidence": 99},
        ],
    )
    vr = H.extract_value_ranges(ocr)
    assert vr["detected"][1] == 1500000.0
    ticks = H.extract_tick_labels(ocr)
    assert "2019" in ticks["x_axis"] and "75" in ticks["y_axis"]
    legend = H.detect_legend_advanced(ocr, (460, 500))
    assert legend == ["Stocks", "Bonds"]
    axes = H.detect_axis_labels(ocr.raw_text)
    assert "y" in axes
    st = H.extract_structured_text(ocr)
    assert "Revenue $1.5M" in st["values"]
