"""Text-line detection over crop batches.

The detection stage of the on-device OCR path (PaddleOCR's DBNet equivalent
for *rendered* documents): binarize ink, dilate horizontally to fuse glyphs
into line blobs, label with connected components, and reduce to per-line
AABBs — ALL on device. Only a compact (B, K, 5) box tensor crosses to the
host; label maps never do.

Output boxes are pixel AABBs in crop space, reading-ordered (top-to-bottom,
left-to-right), matching the reference's OCR block geometry
(ref pdf_image_segmentation.py:1128-1165).
"""
from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from synapta_tpu.ops.cc import component_stats_device, connected_components
from synapta_tpu.ops.color import rgb_to_gray
from synapta_tpu.ops.filters import (
    binarize_ink,
    diagonal_run_mask,
    dilate,
    downsample2,
    erode,
)

MAX_LINES = 128


def fuse_text_mask(ink: jnp.ndarray, merge_x: int = 7) -> jnp.ndarray:
    """Ink -> fused text-line mask (strokes/rules/solids erased, glyphs
    closed into line blobs). Shared by the standalone path below and the
    merged single-dispatch kernel in ops/features.py."""
    # Erase non-text strokes BEFORE labeling:
    # - long diagonal runs (diamond outlines, arrow shafts) fragment into
    #   digit-sized junk when half-converged;
    # - long horizontal/vertical RULES (axes, table borders, arrow shafts)
    #   fuse with adjacent words into sparse components that the fill
    #   filter then rejects wholesale, losing the text.
    # Glyph strokes never form 40px continuous runs, so text is untouched.
    diag = diagonal_run_mask(ink > 0, 12) | diagonal_run_mask(ink > 0, 12, anti=True)
    h_rule = dilate(erode(ink, 1, 41), 1, 45)
    v_rule = dilate(erode(ink, 41, 1), 45, 1)
    # solid regions (bars, legend color swatches, photo areas): glyph
    # strokes are 1-3px and never survive a 5x5 erosion
    solid = dilate(erode(ink, 5, 5), 9, 9)
    strokes = dilate(diag.astype(jnp.float32), 3, 3)
    kill = jnp.maximum(jnp.maximum(strokes, solid), jnp.maximum(h_rule, v_rule))
    ink = ink * (1.0 - kill)
    fused = erode(dilate(ink, 1, merge_x), 1, max(merge_x - 2, 1))
    fused = erode(dilate(fused, 2, 1), 1, 1)
    return fused


def line_boxes_from_ink(ink: jnp.ndarray, merge_x: int = 7,
                        k: int = MAX_LINES) -> jnp.ndarray:
    """Fused mask -> (B, k, 5) [x0, y0, x1, y1, area] float32, largest-first.

    Shallow diagonals (diamond sides are ~2.4:1, not 45 deg) need enough CC
    convergence to unify and fail the fill filter; the while_loop exits
    early on ordinary text pages."""
    fused = fuse_text_mask(ink, merge_x)
    # label at HALF resolution: text lines stay connected under 2x max-pool,
    # propagation distances halve (so do the shallow-diagonal worst cases),
    # and each CC iteration moves a quarter of the bytes.
    # 10 iterations: text lines unify in 2-3 (a row scan covers the whole
    # line per round); the budget covers snaking leftovers. Real pages
    # never early-exit the while_loop, so every extra iteration is paid —
    # the recognizer's confidence gate drops the rare half-converged
    # stroke fragment that slips through as a junk box.
    half = downsample2(fused)
    labels = connected_components(half, max_iters=10)
    stats = component_stats_device(labels, k=k)
    # stats are in half-res pixels: scale boxes x2, areas x4
    return jnp.stack(
        [
            stats["x0"].astype(jnp.float32) * 2.0,
            stats["y0"].astype(jnp.float32) * 2.0,
            (stats["x1"].astype(jnp.float32) + 1.0) * 2.0,
            (stats["y1"].astype(jnp.float32) + 1.0) * 2.0,
            stats["area"] * 4.0,
        ],
        axis=-1,
    )


@functools.partial(jax.jit, static_argnames=("merge_x", "ink_thresh", "k"))
def line_boxes_device(
    rgb: jnp.ndarray,
    merge_x: int = 7,
    ink_thresh: float = 200.0,
    k: int = MAX_LINES,
):
    """(B, H, W, 3) uint8 -> (B, k, 5) line boxes (standalone path)."""
    gray = rgb_to_gray(rgb)
    ink = binarize_ink(gray, ink_thresh)
    return line_boxes_from_ink(ink, merge_x, k)


def extract_line_boxes(
    boxes: np.ndarray,
    min_w: int = 6,
    min_h: int = 5,
    max_h: int = 64,
    min_area: int = 24,
) -> List[List[int]]:
    """One crop's (K, 5) device boxes -> reading-ordered [x0, y0, x1, y1]
    line boxes. Components taller than max_h (drawings, bars) and smaller
    than the minima (specks) are rejected; same-row fragments merge."""
    out = []
    for x0, y0, x1, y1, area in np.asarray(boxes):
        if area < min_area:
            continue
        w, h = x1 - x0, y1 - y0
        if w < min_w or h < min_h or h > max_h:
            continue
        if w < h * 0.6:  # text lines are wider than tall
            continue
        if area < 0.25 * w * h:  # reject sparse frames (outline boxes)
            continue
        out.append([int(x0), int(y0), int(x1), int(y1)])
    out.sort(key=lambda b: (b[1], b[0]))
    merged: List[List[int]] = []
    for b in out:
        if merged:
            m = merged[-1]
            same_row = abs(b[1] - m[1]) < 0.6 * (m[3] - m[1])
            close = b[0] - m[2] < 1.2 * (m[3] - m[1])
            if same_row and close and b[0] >= m[0]:
                m[2] = max(m[2], b[2])
                m[1] = min(m[1], b[1])
                m[3] = max(m[3], b[3])
                continue
        merged.append(list(b))
    merged.sort(key=lambda b: (b[1], b[0]))
    return merged


def detect_lines(rgb_batch: np.ndarray) -> List[List[List[int]]]:
    """Crop batch -> per-crop reading-ordered line boxes (one compact
    device->host transfer for the whole batch)."""
    boxes = np.asarray(line_boxes_device(jnp.asarray(rgb_batch)))
    return [extract_line_boxes(boxes[i]) for i in range(boxes.shape[0])]
