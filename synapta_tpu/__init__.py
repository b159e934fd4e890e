"""synapta_tpu — textbook visual-segmentation framework on JAX.

A ground-up JAX/XLA rebuild of the capabilities of
``ashr2k/synapta-image-segmentation`` (SURVEY.md):
PDF textbooks -> detected/classified/enriched visual segments
(charts, diagrams, flowcharts, images, figures) emitted as
``{book_id}_visual_segments.json`` + ``{book_id}_visual_summary.csv``
plus per-segment PNG crops.

Architecture (accelerator-first, not a port):
  - native/       C++ PDF engine (parse + rasterize; replaces PyMuPDF)
  - io/           ingest bindings, output writers, xlsx taxonomy reader
  - ops/          device image ops in plain JAX (edges, morphology,
                  connected components, k-means, blobs, resize, stats)
  - models/       OCR models as JAX functions (text detector + CTC
                  recognizer) with .npz weights
  - ocr/          batched OCR driver emitting OCRResult schema
  - vision/       region detection engine + classification heuristics
  - llm/          async batched Pixtral client (+ fake for tests)
  - linker/       vectorized TF-IDF concept linker
  - parallel/     jax.sharding mesh helpers (DP over page/crop batches)
  - pipeline.py   streaming orchestrator (the public entry point)
"""

__version__ = "0.1.0"

from synapta_tpu.schema import (  # noqa: F401
    VisualType,
    BoundingBox,
    OCRResult,
    MermaidRepresentation,
    ChartSpecificData,
    DiagramSpecificData,
    ImageSpecificData,
    FigureSpecificData,
    VisualSegment,
)
from synapta_tpu.config import PipelineConfig  # noqa: F401
