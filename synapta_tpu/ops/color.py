"""Color conversions (elementwise; XLA fuses these into consumers)."""
from __future__ import annotations

import jax.numpy as jnp


def gray_quarter_host(rgb):
    """HOST-side luma + 2x2-strided color subsample — the analyze
    pass's H2D diet: shipping (gray u8 + quarter-res RGB) instead of full
    RGB cuts the transfer 2.4x; gray uses
    the integer luma (77, 150, 29)/256 (max 0.7 gray-level deviation from
    the float weights below — decision thresholds are locked by tests).
    The strided subsample is itself a uniform spatial sample, so the
    k-means mask statistics survive (the reference sampled <= 5000 px
    anyway, ref pdf_image_segmentation.py:1582).

    (N, H, W, 3) uint8 batches go through the native engine (one
    memory-speed GIL-free pass); other inputs take the bit-identical numpy
    path."""
    import numpy as np

    if rgb.ndim == 4 and rgb.shape[-1] == 3 and rgb.dtype == np.uint8:
        from synapta_tpu.io.ingest import gray_quarter_native

        return gray_quarter_native(rgb)
    r = rgb[..., 0].astype(np.uint16)
    g = rgb[..., 1].astype(np.uint16)
    b = rgb[..., 2].astype(np.uint16)
    gray = ((77 * r + 150 * g + 29 * b + 128) >> 8).astype(np.uint8)
    rgb_q = np.ascontiguousarray(rgb[:, ::2, ::2])
    return gray, rgb_q


def rgb_to_gray(rgb: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) uint8/float -> (...) float32 luma in [0, 255].

    Matches OpenCV's BGR2GRAY weights (ref OCRProcessor channel handling,
    pdf_image_segmentation.py:1114-1122) for decision parity.
    """
    r = rgb[..., 0].astype(jnp.float32)
    g = rgb[..., 1].astype(jnp.float32)
    b = rgb[..., 2].astype(jnp.float32)
    return 0.299 * r + 0.587 * g + 0.114 * b
