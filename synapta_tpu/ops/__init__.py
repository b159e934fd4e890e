"""Device image-ops library (plain JAX, compiled by XLA).

Batched, fixed-shape, jit-compatible equivalents of the reference's
per-image OpenCV/sklearn calls (ref pdf_image_segmentation.py:1231-1838):
edge maps, separable morphology, oriented line counts, circle scoring,
connected components, masked k-means, and reduction stats. Everything
operates on crop *batches* resident in device memory — no per-image host
round-trips.
"""

from synapta_tpu.ops.color import rgb_to_gray  # noqa: F401
from synapta_tpu.ops.filters import (  # noqa: F401
    sobel_edges,
    erode,
    dilate,
    morph_open_h,
    morph_open_v,
)
from synapta_tpu.ops.cc import connected_components, component_stats  # noqa: F401
from synapta_tpu.ops.kmeans import dominant_colors  # noqa: F401
from synapta_tpu.ops.features import extract_crop_features  # noqa: F401
