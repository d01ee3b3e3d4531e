"""``repro_torch.serve``: the serving half of the GLM lifecycle.

Train -> export -> serve:

  * ``artifact``: versioned on-disk model artifacts (fp32 or shared-scale
    int8), the JAX package's format, and the immutable ``ServableModel``.
  * ``engine``: active-set-compacted batched scoring for dense rows and
    sparse feature-list requests, backed by the fused gather-dot-link
    kernel (``kernels/predict_tile.py``, K7), several outputs per launch.
  * ``batcher``: deadline-flushed micro-batching with a bounded
    shape-bucket set and p50/p99/rows-per-s instrumentation.
"""
from repro_torch.serve.artifact import (ServableModel, artifact_bytes,
                                        dequantize_int8, export,
                                        load_artifact, quantize_int8,
                                        save_artifact)
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.engine import ScoringEngine, coo_to_requests

__all__ = [
    "ServableModel", "ScoringEngine", "MicroBatcher", "coo_to_requests",
    "save_artifact", "load_artifact", "export", "artifact_bytes",
    "quantize_int8", "dequantize_int8",
]
