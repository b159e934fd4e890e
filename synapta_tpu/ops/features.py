"""Fused per-crop visual feature extraction — one jitted pass over a crop
batch replacing ~10 separate per-image OpenCV passes in the reference
(_detect_chart_subtype/_detect_grid/_count_arrows/_estimate_data_points/
_extract_dominant_colors/..., ref pdf_image_segmentation.py:1320-1617).

Input: (B, H, W, 3) uint8 RGB crop batch (padded to fixed shape, pad = white).
Output: dict of per-crop numeric features (device arrays) + CC label maps.
Decision logic (keyword regexes, threshold comparisons) stays host-side in
synapta_tpu/vision/classify.py — strings never touch the device.

Geometry note: crops are rendered so max(H, W) <= canvas (512); the
reference's adaptive kernel max(20, dim//20) lands in [20, 25] for that
range, so a fixed k=20 kernel is used (locked by decision-parity tests).
"""
from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp

from synapta_tpu.ops.cc import connected_components
from synapta_tpu.ops.color import rgb_to_gray
from synapta_tpu.ops.filters import (
    binarize_ink,
    box_count,
    diagonal_run_mask,
    dilate,
    erode,
    morph_open,
    sobel_edges,
)
from synapta_tpu.ops.kmeans import dominant_colors


def _open_iter2(img: jnp.ndarray, kh: int, kw: int) -> jnp.ndarray:
    """cv2 MORPH_OPEN with iterations=2 == erode twice then dilate twice,
    equivalent to one open with the (2k-1)-sized kernel."""
    ekh = 2 * kh - 1 if kh > 1 else 1
    ekw = 2 * kw - 1 if kw > 1 else 1
    return dilate(erode(img, ekh, ekw), ekh, ekw)


def _run_length_rows(mask: jnp.ndarray, min_len: int) -> jnp.ndarray:
    """Per-image count of pixels that belong to a horizontal run >= min_len."""
    runs = erode(mask, 1, min_len)  # survives only if min_len-window all set
    return box_count(runs > 0)


@functools.partial(jax.jit, static_argnames=("connectivity", "max_iters"))
def _cc_jit(mask, connectivity=8, max_iters=64):
    return connected_components(mask, max_iters=max_iters,
                                connectivity=connectivity)


def _enclosed_mask(ink: jnp.ndarray) -> jnp.ndarray:
    """Non-ink pixels with ink on all four sides (ray casting via
    directional cumulative max) — the interiors of outlined shapes.

    A cheap stand-in for labeling the ENTIRE background: the global
    background component snakes between text lines and needs tens of
    propagation iterations to converge, whereas shape interiors are small
    and convex-ish; four scans + a small CC find them directly."""
    from jax import lax

    def cmax(a, axis, rev):
        return lax.associative_scan(jnp.maximum, a, axis=axis, reverse=rev)

    left = cmax(ink, 2, False) > 0
    right = cmax(ink, 2, True) > 0
    top = cmax(ink, 1, False) > 0
    bottom = cmax(ink, 1, True) > 0
    return (left & right & top & bottom & (ink == 0)).astype(jnp.float32)


@jax.jit
def _component_censuses(ink, vink, bg, sizes):
    """Per-component censuses computed entirely on device (label maps never
    leave device memory: a host round-trip per crop would serialize the
    pass on transfers).

    sizes: (B, 2) int32 true (h, w) of each crop before padding.
    Returns (B,) scalars: blob_count, tall_bars, rect/circle/diamond counts.
    """
    from synapta_tpu.ops.cc import census_counts, component_stats_device
    from synapta_tpu.ops.filters import downsample2

    true_h = sizes[:, 0:1].astype(jnp.float32)
    true_w = sizes[:, 1:2].astype(jnp.float32)

    # ALL censuses run at HALF resolution: the per-bin segment reductions
    # (scatter at N=H*W+1 bins) dominate the analyze pass, and a 2x
    # max-pool quarters both the scatter updates and the bin table while
    # keeping every census-relevant structure (blobs >= 10px area, shapes
    # >= 12px side) connected. Area thresholds scale by 1/4, lengths by
    # 1/2; a max-pooled blob covers ceil(bbox/2) cells so the small-area
    # cutoffs round UP (e.g. 10px -> 3 cells), locked by the
    # decision-parity tests in tests/test_ops_classify.py.
    ink_h = downsample2(ink)
    # glyph/blob components converge in a handful of propagation rounds
    ink_stats = component_stats_device(_cc_jit(ink_h, max_iters=6), k=8)
    # SimpleBlobDetector-equivalent: small ink components (ref :1596-1617)
    blob_count = census_counts(
        ink_stats, lambda a, w, h, *_: (a >= 3) & (a <= 44)
    )
    # solid shapes (filled rects/diamonds/circles) from ink components.
    # Max-pooling RAISES fill ratios (outlines thicken, interiors close):
    # the rect band is unchanged, circle/diamond bands shift up slightly.
    def solid_pred(kind):
        def pred(a, w, h, x0, y0, x1, y1):
            fill = a / jnp.maximum(w * h, 1.0)
            base = (a >= 30) & (w >= 6) & (h >= 6)
            if kind == "rect":
                return base & (fill > 0.85)
            if kind == "circle":
                return base & (fill > 0.65) & (fill <= 0.85)
            return base & (fill > 0.35) & (fill <= 0.65)
        return pred

    ink_rect = census_counts(ink_stats, solid_pred("rect"))
    ink_circle = census_counts(ink_stats, solid_pred("circle"))
    ink_diamond = census_counts(ink_stats, solid_pred("diamond"))

    # filled-bar census (tall vertical ink components, ref :1403-1406).
    # MIN-pool here: adjacent bars are separated by gaps as thin as 1px,
    # which a max-pool would close (merging bars fails the h > 1.2w test);
    # min-pool keeps gaps and only erodes bar width by <= 1px.
    from synapta_tpu.ops.filters import downsample2_min

    vink_stats = component_stats_device(
        _cc_jit(downsample2_min(vink), max_iters=4), k=8
    )
    # tall_bars: reference-faithful 0.2*H fraction (0.1 at half-res,
    # ref :1403-1406) — feeds the bar-subtype census, where steep line-
    # chart strokes must NOT count.
    tall_bars = census_counts(
        vink_stats,
        lambda a, w, h, *_: (h > 0.1 * true_h) & (h > 1.2 * w) & (w >= 2.0),
    )
    # filled_bars: looser 0.12*H fraction (0.06 half-res), NO aspect test
    # — catches SQUAT bars (wider than tall; detected regions now include
    # the title/caption band so short bars sit under 0.2*H). Surviving the
    # 39px vertical ink erosion already proves a solid block: glyphs and
    # legend swatches are too short, series strokes too thin (w >= 4
    # half-px floor). Used as chart-vs-flowchart evidence only.
    filled_bars = census_counts(
        vink_stats,
        lambda a, w, h, *_: (h > 0.06 * true_h) & (w >= 4.0),
    )

    # outlined shapes via enclosed interiors (RETR_TREE analog): ray-cast
    # containment then a small CC at HALF resolution — never label the
    # global background (shape interiors are >=12px; 2x max-pool keeps them)
    from synapta_tpu.ops.filters import downsample2

    bg_stats = component_stats_device(
        _cc_jit(downsample2(_enclosed_mask(1.0 - bg)), connectivity=4,
                max_iters=6),
        k=8,
    )
    bg_scale = 2.0

    def bg_pred(kind):
        def pred(a, w, h, x0, y0, x1, y1):
            # stats are half-resolution: thresholds scale accordingly
            fill = a / jnp.maximum(w * h, 1.0)
            interior = (
                (x0 > 0) & (y0 > 0)
                & (x1.astype(jnp.float32) < true_w / bg_scale - 1)
                & (y1.astype(jnp.float32) < true_h / bg_scale - 1)
                & (a < 0.5 * true_h * true_w / (bg_scale * bg_scale))
            )
            base = interior & (a >= 120 / (bg_scale * bg_scale)) & (w >= 6) & (h >= 6)
            if kind == "rect":
                return base & (fill > 0.85)
            if kind == "circle":
                return base & (fill > 0.65) & (fill <= 0.85)
            return base & (fill > 0.35) & (fill <= 0.65)
        return pred

    return {
        "blob_count": blob_count,
        "tall_bars": tall_bars,
        "filled_bars": filled_bars,
        "shapes_rect": ink_rect + census_counts(bg_stats, bg_pred("rect")),
        "shapes_circle": ink_circle + census_counts(bg_stats, bg_pred("circle")),
        "shapes_diamond": ink_diamond + census_counts(bg_stats, bg_pred("diamond")),
    }


_SCALAR_KEYS = (
    "v_pixels", "h_pixels", "long_h_pixels", "grid_h", "grid_v",
    "diag_pixels", "line_pixels", "ring_score", "ring_radius",
    "circle_edge_density", "ring_coverage", "variance", "edge_count", "ink_count",
    "v_ink_pixels", "blob_count", "tall_bars", "filled_bars",
    "shapes_rect", "shapes_circle", "shapes_diamond", "kmeans_masked",
)


@jax.jit
def _pack(out: Dict[str, jnp.ndarray]) -> jnp.ndarray:
    """Pack every per-crop output into ONE (B, 20 + 5*3 + 5) f32 array so a
    single D2H transfer moves the whole feature batch (one transfer
    latency instead of 25)."""
    cols = [out[k].astype(jnp.float32)[:, None] for k in _SCALAR_KEYS]
    B = cols[0].shape[0]
    cols.append(out["kmeans_centers"].reshape(B, -1))
    cols.append(out["kmeans_counts"].reshape(B, -1))
    return jnp.concatenate(cols, axis=1)


def extract_crop_features(
    rgb: jnp.ndarray,
    sizes=None,
    line_kernel: int = 20,
    grid_kernel: int = 25,
) -> Dict[str, "np.ndarray"]:
    """The feature pass over a crop batch. rgb: (B, H, W, 3) uint8;
    sizes: optional (B, 2) [true_h, true_w] before padding.

    Composed of separately-jitted stages (shared CC executable). Every
    output is a compact per-crop value; the whole result crosses
    device->host as one packed array. Returns HOST numpy arrays."""
    import numpy as np

    B, H, W = rgb.shape[:3]
    if sizes is None:
        sizes = jnp.full((B, 2), jnp.array([H, W]), jnp.int32)
    else:
        sizes = jnp.asarray(sizes, jnp.int32)
    from synapta_tpu.ops.color import gray_quarter_host

    gray, rgb_q = gray_quarter_host(np.asarray(rgb))
    # eighth-res color, same diet as device_analyze_dispatch (k-means is
    # the only color consumer; ref sampled <= 5000 px, :1582)
    rgb_q = np.ascontiguousarray(rgb_q[:, ::2, ::2])
    out = dict(_core_features(gray, rgb_q, line_kernel, grid_kernel))
    out.update(
        _component_censuses(
            out.pop("_ink"), out.pop("_vink"), out.pop("_bg"), sizes
        )
    )
    out.pop("_vdet", None)
    packed = np.asarray(_pack(out))
    res: Dict[str, np.ndarray] = {
        k: packed[:, i] for i, k in enumerate(_SCALAR_KEYS)
    }
    n = len(_SCALAR_KEYS)
    res["kmeans_centers"] = packed[:, n : n + 15].reshape(B, 5, 3)
    res["kmeans_counts"] = packed[:, n + 15 : n + 20].reshape(B, 5)
    return res


@functools.partial(jax.jit, static_argnames=("line_kernel", "grid_kernel"))
def _core_features(
    gray_u8: jnp.ndarray,
    rgb_q: jnp.ndarray,
    line_kernel: int = 20,
    grid_kernel: int = 25,
) -> Dict[str, jnp.ndarray]:
    """Fused non-CC features.

    gray_u8: (B, H, W) uint8 luma (host-converted — H2D diet, see
    ops/color.gray_quarter_host). rgb_q: (B, H//2, W//2, 3) uint8 color
    subsample, used only by the k-means dominant-color pass."""
    B, H, W = gray_u8.shape
    gray = gray_u8.astype(jnp.float32)            # (B, H, W) 0..255
    edges, mag, theta = sobel_edges(gray)
    e = edges.astype(jnp.float32)

    # long horizontal lines for the line-chart bonus (ref :1387-1393):
    # pixels on h-runs of >= W/5 (between the ref's W/4 min length and
    # 0.2*W span test)
    long_h_pixels = _run_length_rows(e, max(8, W // 5))

    # diagonal structure for arrows (ref :1320-1341): pixels on >=24px
    # diagonal runs, both diagonals
    diag1 = diagonal_run_mask(edges, 24, anti=False)
    diag2 = diagonal_run_mask(edges, 24, anti=True)
    diag_pixels = box_count(diag1 | diag2)

    # chart structure signals (ref :1366-1409)
    v_detect = _open_iter2(e, line_kernel, 1)
    h_detect = _open_iter2(e, 1, line_kernel)
    v_pixels = box_count(v_detect > 0)
    h_pixels = box_count(h_detect > 0)

    # grid (ref :1546-1564)
    grid_h = box_count(_open_iter2(e, 1, grid_kernel) > 0)
    grid_v = box_count(_open_iter2(e, grid_kernel, 1) > 0)

    # overall line pixels for connection counting (ref :1695-1711)
    line_pixels = box_count((v_detect > 0) | (h_detect > 0)) + diag_pixels

    # circle / pie scoring (ref :1411-1448): radial histogram of edge
    # pixels around the ink centroid; a dominant ring at large radius with
    # interior edge density marks a pie.
    ink = binarize_ink(gray)
    ys = jax.lax.broadcasted_iota(jnp.float32, (B, H, W), 1)
    xs = jax.lax.broadcasted_iota(jnp.float32, (B, H, W), 2)
    ink_n = jnp.maximum(box_count(ink), 1.0)
    cy = jnp.sum(ys * ink, axis=(1, 2)) / ink_n
    cx = jnp.sum(xs * ink, axis=(1, 2)) / ink_n
    r = jnp.sqrt((ys - cy[:, None, None]) ** 2 + (xs - cx[:, None, None]) ** 2)
    NBINS = 48
    rmax = 0.5 * min(H, W)
    rbin = jnp.clip((r / rmax * NBINS).astype(jnp.int32), 0, NBINS - 1)
    # small-bin histogram as a fused one-hot masked reduce, not
    # segment_sum: the broadcast-compare-reduce fuses into one pass over
    # the crop where a scatter serializes its updates
    hist = jnp.sum(
        e[..., None] * (rbin[..., None] == jnp.arange(NBINS)), axis=(1, 2)
    )
    # normalize each bin by its circumference ~ r
    bin_r = (jnp.arange(NBINS, dtype=jnp.float32) + 0.5) * (rmax / NBINS)
    density = hist / (2 * jnp.pi * bin_r + 1e-6)[None, :]
    # ring = peak density bin in the "large radius" band [0.4, 0.95]*rmax
    lo, hi = int(NBINS * 0.4), int(NBINS * 0.95)
    band = density[:, lo:hi]
    ring_peak = jnp.max(band, axis=1)
    ring_bin = jnp.argmax(band, axis=1) + lo
    ring_radius = (ring_bin.astype(jnp.float32) + 0.5) * (rmax / NBINS)
    # mean edge coverage elsewhere in the band (ring must dominate)
    band_mean = jnp.mean(band, axis=1)
    ring_score = ring_peak / (band_mean + 1e-6)
    # edge density inside the ring circle (pie slice boundaries, ref :1439)
    inside = (r <= ring_radius[:, None, None]).astype(jnp.float32)
    inside_edges = jnp.sum(e * inside, axis=(1, 2))
    circle_edge_density = inside_edges / (
        jnp.pi * ring_radius * ring_radius + 1e-6
    )
    # angular coverage at the ring: a true circle has edge pixels at nearly
    # every angle around the centroid; box/diamond layouts only cross the
    # ring radius at a few angles (the HoughCircles-strictness analog,
    # ref :1426-1430 "exactly one large circle")
    ABINS = 36
    ang = jnp.arctan2(ys - cy[:, None, None], xs - cx[:, None, None])
    abin = jnp.clip(
        ((ang + jnp.pi) / (2 * jnp.pi) * ABINS).astype(jnp.int32), 0, ABINS - 1
    )
    on_ring = (
        jnp.abs(r - ring_radius[:, None, None]) < (rmax / NBINS) * 1.5
    ).astype(jnp.float32) * e
    # same fused one-hot reduce as the radial hist (scatter-free)
    ahist = jnp.sum(
        on_ring[..., None] * (abin[..., None] == jnp.arange(ABINS)),
        axis=(1, 2),
    )
    ring_coverage = jnp.mean((ahist > 0).astype(jnp.float32), axis=1)

    # stats
    variance = jnp.var(gray, axis=(1, 2))
    edge_count = box_count(edges)

    # masks handed to the shared CC executable by the composing wrapper:
    # filled-bar signal = vertically-opened INK (filled bars survive a tall
    # erosion; glyphs and thin horizontals do not); enclosed background
    # regions (4-conn complement) = interiors of outlined shapes — the
    # contour-hierarchy analog of cv2 RETR_TREE
    v_ink = morph_open(ink, 2 * line_kernel - 1, 1)
    v_ink_pixels = box_count(v_ink > 0)

    # quarter-res color sample: counts and the masked-pixel total scale by
    # 4 to stay in full-image pixel units (ratios downstream are invariant)
    centers, ccounts, n_masked = dominant_colors(rgb_q)
    ccounts = ccounts * 4.0
    n_masked = n_masked * 4.0

    return {
        "v_pixels": v_pixels,
        "h_pixels": h_pixels,
        "long_h_pixels": long_h_pixels,
        "grid_h": grid_h,
        "grid_v": grid_v,
        "diag_pixels": diag_pixels,
        "line_pixels": line_pixels,
        "ring_score": ring_score,
        "ring_radius": ring_radius,
        "circle_edge_density": circle_edge_density,
        "ring_coverage": ring_coverage,
        "variance": variance,
        "edge_count": edge_count,
        "ink_count": box_count(ink),
        "_ink": ink,
        "_vink": (v_ink > 0).astype(jnp.float32),
        "_bg": 1.0 - ink,
        "v_ink_pixels": v_ink_pixels,
        "kmeans_centers": centers,
        "kmeans_counts": ccounts,
        "kmeans_masked": n_masked,
    }


def _analyze_impl(gray_u8: jnp.ndarray, rgb_q: jnp.ndarray,
                  sizes: jnp.ndarray) -> jnp.ndarray:
    """ONE device dispatch for the whole per-crop analysis: visual features,
    component censuses, AND text-line boxes, packed into a single f32 array
    so exactly one D2H transfer happens per crop chunk (one dispatch and
    one transfer instead of 5 and 3)."""
    from synapta_tpu.ocr.linedet import line_boxes_from_ink

    out = dict(_core_features(gray_u8, rgb_q, 20, 25))
    cen = _component_censuses(
        out["_ink"], out["_vink"], out["_bg"], sizes
    )
    boxes = line_boxes_from_ink(out["_ink"])  # (B, MAX_LINES, 5)
    out.update(cen)
    for k in ("_ink", "_vdet", "_vink", "_bg"):
        out.pop(k, None)
    packed = _pack(out)
    B = packed.shape[0]
    return jnp.concatenate([packed, boxes.reshape(B, -1)], axis=1)


_analyze_jit = jax.jit(_analyze_impl)


@functools.lru_cache(maxsize=8)
def _analyze_fn_for(mesh):
    """jit the analyze pass with the crop batch sharded over the mesh's
    'data' axis (SURVEY §2.4: DP over crops is THE parallelism this
    workload needs). Every op is batch-parallel, so XLA runs each shard
    locally and only the packed result is reassembled."""
    if mesh is None:
        return _analyze_jit
    from jax.sharding import NamedSharding, PartitionSpec as P

    ds = NamedSharding(mesh, P("data"))
    return jax.jit(_analyze_impl, in_shardings=(ds, ds, ds), out_shardings=ds)


def device_analyze(rgb, sizes=None, mesh=None):
    """Crop batch -> (features dict of host numpy arrays, (B, 128, 5) line
    boxes). The fused single-dispatch path used by the pipeline. With a
    mesh, the batch dim shards across its 'data' axis."""
    import numpy as np

    packed = device_analyze_dispatch(rgb, sizes=sizes, mesh=mesh)
    return unpack_analysis(np.asarray(packed), rgb.shape[0])


def device_analyze_dispatch(rgb, sizes=None, mesh=None):
    """Async half of device_analyze: enqueue the fused pass and return the
    DEVICE packed array without materializing — callers can dispatch every
    chunk back-to-back (overlapping H2D/compute/D2H) and unpack later with
    unpack_analysis(np.asarray(packed), B).

    rgb: (B, H, W, 3) uint8 HOST numpy. The host converts it to
    (gray u8, eighth-res RGB) before transfer — the only color consumer
    is dominant_colors, whose reference sampled <= 5000 px anyway (ref
    :1582; 64x64 = 4096 here), so color crosses at 1/64 of full res."""
    import numpy as np

    from synapta_tpu.ops.color import gray_quarter_host

    B, H, W = rgb.shape[:3]
    if sizes is None:
        sizes = jnp.full((B, 2), jnp.array([H, W]), jnp.int32)
    else:
        sizes = jnp.asarray(sizes, jnp.int32)
    gray, rgb_q = gray_quarter_host(np.asarray(rgb))
    rgb_q = np.ascontiguousarray(rgb_q[:, ::2, ::2])
    return _analyze_fn_for(mesh)(gray, rgb_q, sizes)


def unpack_analysis(packed, B: int):
    """Host half: split the packed (B, n) result into the feature dict and
    the (B, MAX_LINES, 5) line-box tensor."""
    from synapta_tpu.ocr.linedet import MAX_LINES

    n = len(_SCALAR_KEYS)
    res = {k: packed[:, i] for i, k in enumerate(_SCALAR_KEYS)}
    res["kmeans_centers"] = packed[:, n : n + 15].reshape(B, 5, 3)
    res["kmeans_counts"] = packed[:, n + 15 : n + 20].reshape(B, 5)
    boxes = packed[:, n + 20 :].reshape(B, MAX_LINES, 5)
    return res, boxes
