"""repro_torch: d-GLMNET (distributed coordinate descent for elastic-net
GLMs) in PyTorch, with hand-written CUDA kernels for the NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it and never imports ``jax``.  Entry point: ``repro_torch.core.solver.
GLMSolver``, which runs on the card unless the caller passes
``device="cpu"``.
"""
import torch  # noqa: F401  (the package's one hard dependency)

__all__ = ["core", "data", "kernels", "serve", "convert", "device", "timing"]
