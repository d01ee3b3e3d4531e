"""repro_torch: d-GLMNET (distributed coordinate descent for elastic-net
GLMs) in PyTorch, with hand-written CUDA kernels for the NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it and never imports ``jax``.  Entry points: the estimators of
``repro_torch.glm`` and the session ``repro_torch.core.solver.GLMSolver``
beneath them, which run on the card unless the caller passes
``device="cpu"``; ``python -m repro_torch.launch.serve_glm`` serves a saved
model.  ``repro_torch.obs`` traces a run (``REPRO_TRACE=dir``) and
``python -m repro_torch.launch.trace_report dir`` summarizes it.
``repro_torch.dist`` runs a session on a (data x model) mesh of processes
over ``torch.distributed`` (``GLMSolver(..., mesh=make_dist_mesh(D, M))``,
``python -m repro_torch.launch.dist_run``).
"""
import torch  # noqa: F401  (the package's one hard dependency)

__all__ = ["core", "data", "kernels", "serve", "checkpoint", "glm", "launch",
           "obs", "convert", "device", "timing", "dist", "sharding"]
