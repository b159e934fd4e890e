"""Convolutional / windowed filters: Sobel edges and separable morphology.

Replaces cv2.Canny / cv2.morphologyEx(MORPH_OPEN) / cv2.getStructuringElement
call sites (ref pdf_image_segmentation.py:1366-1376, 1549-1563). Edge maps
use Sobel gradient magnitude with hysteresis-free double thresholding — the
decision heuristics downstream only consume pixel *counts* and densities, and
parity tests lock those decisions against the OpenCV reference path.

All functions are batched (B, H, W) float32 and jit-compatible; the 3x3
convs go through lax.conv, the morphology through reduce_window.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

def _shift(a: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Edge-replicating shift (B, H, W) — equivalent to SAME-padded conv
    taps but compiles to cheap pad+slice that XLA fuses."""
    B, H, W = a.shape
    p = jnp.pad(a, ((0, 0), (1, 1), (1, 1)), mode="edge")
    return lax.dynamic_slice(p, (0, 1 - dy, 1 - dx), (B, H, W))


def sobel_gradients(gray: jnp.ndarray):
    """-> (gx, gy) float32, same shape as input. Implemented with 8 shifted
    adds instead of lax.conv — identical result, far simpler HLO."""
    tl = _shift(gray, -1, -1)
    t = _shift(gray, -1, 0)
    tr = _shift(gray, -1, 1)
    l = _shift(gray, 0, -1)
    r = _shift(gray, 0, 1)
    bl = _shift(gray, 1, -1)
    b = _shift(gray, 1, 0)
    br = _shift(gray, 1, 1)
    gx = (tr + 2 * r + br) - (tl + 2 * l + bl)
    gy = (bl + 2 * b + br) - (tl + 2 * t + tr)
    return gx, gy


def sobel_edges(gray: jnp.ndarray, low: float = 50.0, high: float = 150.0):
    """Canny-equivalent edge map.

    Gradient magnitude with a weak non-maximum thinning (edge pixels must be
    a local max along the dominant gradient axis) and double threshold where
    weak edges survive only adjacent to strong ones.
    Returns (edges bool, magnitude, orientation_radians).
    """
    gx, gy = sobel_gradients(gray)
    mag = jnp.sqrt(gx * gx + gy * gy)
    theta = jnp.arctan2(gy, gx)

    # axis-aligned NMS: compare against the two neighbors along the
    # dominant gradient direction (quantized to h/v/diag)
    def shift(a, dy, dx):
        return jnp.roll(jnp.roll(a, dy, axis=1), dx, axis=2)

    adeg = (jnp.rad2deg(theta) + 180.0) % 180.0
    is_h = (adeg < 22.5) | (adeg >= 157.5)          # gradient horizontal
    is_d1 = (adeg >= 22.5) & (adeg < 67.5)
    is_v = (adeg >= 67.5) & (adeg < 112.5)
    n1 = jnp.where(
        is_h, shift(mag, 0, 1),
        jnp.where(is_d1, shift(mag, 1, 1),
                  jnp.where(is_v, shift(mag, 1, 0), shift(mag, 1, -1))),
    )
    n2 = jnp.where(
        is_h, shift(mag, 0, -1),
        jnp.where(is_d1, shift(mag, -1, -1),
                  jnp.where(is_v, shift(mag, -1, 0), shift(mag, -1, 1))),
    )
    local_max = (mag >= n1) & (mag >= n2)
    strong = local_max & (mag >= high)
    weak = local_max & (mag >= low)
    # one dilation round: weak pixels next to strong survive
    grown = dilate(strong.astype(jnp.float32), 3, 3) > 0
    edges = strong | (weak & grown)
    return edges, mag, theta


def erode(img: jnp.ndarray, kh: int, kw: int) -> jnp.ndarray:
    """(B, H, W) min-filter with a kh x kw window (SAME padding)."""
    return -lax.reduce_window(
        -img, -jnp.inf, lax.max, (1, kh, kw), (1, 1, 1), "SAME"
    )


def dilate(img: jnp.ndarray, kh: int, kw: int) -> jnp.ndarray:
    return lax.reduce_window(
        img, -jnp.inf, lax.max, (1, kh, kw), (1, 1, 1), "SAME"
    )


def morph_open(img: jnp.ndarray, kh: int, kw: int) -> jnp.ndarray:
    return dilate(erode(img, kh, kw), kh, kw)


def morph_open_h(img: jnp.ndarray, k: int) -> jnp.ndarray:
    """Open with a horizontal 1 x k structuring element — isolates long
    horizontal strokes (grid rows / line-chart signal, ref :1366-1372)."""
    return morph_open(img, 1, k)


def morph_open_v(img: jnp.ndarray, k: int) -> jnp.ndarray:
    """Open with a vertical k x 1 element (bars / grid columns)."""
    return morph_open(img, k, 1)


def binarize_ink(gray: jnp.ndarray, thresh: float = 200.0) -> jnp.ndarray:
    """Dark-ink mask for documents rendered on white (1.0 = ink)."""
    return (gray < thresh).astype(jnp.float32)


def diagonal_run_mask(edges: jnp.ndarray, length: int, anti: bool = False):
    """Pixels that sit on a diagonal run of at least ``length`` edge pixels.

    Used for HoughLinesP-style arrow counting (ref :1320-1341): the
    reference counts 20-70 / 110-160 degree line segments; a pixel-run
    erosion along each diagonal is the dense equivalent.
    """
    e = edges.astype(jnp.float32)
    # grow 1px so near-diagonal (anti-aliased) runs connect
    e = dilate(e, 2, 2)
    # log-doubling run-length erosion: acc_k[x] == 1 iff a run of length
    # run_k starts at x; AND-ing acc with itself shifted by run_k doubles
    # the run. O(log L) full-array passes instead of O(L).
    sign = -1 if anti else 1

    def shift(a, d):
        return jnp.roll(jnp.roll(a, d, axis=1), sign * d, axis=2)

    # acc_m[p] = AND_{k<m} e[p - k*delta]; doubling composes
    # acc_{m+n}[p] = acc_m[p] & acc_n[p - m*delta]. The largest power of
    # two <= L plus one remainder shift covers 0..L-1 contiguously,
    # reproducing the previous sequential-roll product exactly.
    acc = e
    run = 1
    target = max(int(length), 1)
    while run * 2 <= target:
        acc = acc * shift(acc, run)
        run *= 2
    if run < target:
        acc = acc * shift(acc, target - run)
    return acc > 0


def box_count(mask: jnp.ndarray) -> jnp.ndarray:
    """Per-image pixel count of a (B, H, W) mask."""
    return jnp.sum(mask.astype(jnp.float32), axis=(1, 2))


def downsample2(mask: jnp.ndarray) -> jnp.ndarray:
    """2x2 max-pool downsample of a (B, H, W) mask — halves connected-
    component propagation distances (and quarters per-iteration traffic)
    for structures larger than a couple of pixels."""
    return lax.reduce_window(
        mask, -jnp.inf, lax.max, (1, 2, 2), (1, 2, 2), "VALID"
    )


def downsample2_min(mask: jnp.ndarray) -> jnp.ndarray:
    """2x2 MIN-pool downsample — preserves 1px GAPS between components
    (max-pool closes them, merging e.g. adjacent chart bars into one
    component) at the price of eroding components by up to a pixel."""
    return -lax.reduce_window(
        -mask, -jnp.inf, lax.max, (1, 2, 2), (1, 2, 2), "VALID"
    )
