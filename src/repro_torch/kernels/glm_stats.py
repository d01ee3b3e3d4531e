"""K1 glm_stats: per-example link statistics (loss, s, w) in one pass.

The CUDA kernel is ``csrc/glm_stats.cu``; it replaces
``repro/kernels/glm_stats.py::glm_stats_pallas``.  ``plain`` is its plain
PyTorch version (``kernels/ref.py``).  The kernel moves 16 bytes a thread
where every vector is 16-byte aligned, and element by element otherwise
(a view that starts mid-vector), with the same results.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

FAMILY_CODES = {"logistic": 0, "squared": 1, "probit": 2, "poisson": 3}

_P = ctypes.c_void_p
KERNEL = build.CudaKernel(
    "glm_stats", "repro_glm_stats",
    [_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P])

THREADS = 256           # kThreads in the source

plain = ref.glm_stats


def grid(n: int, family: str = "logistic") -> int:
    """The blocks of the launch for n rows on the current card (THREADS
    threads each): one wave (the occupancy API times the SM count), at most
    one block per THREADS quads (4 rows) of rows: a quad a thread."""
    fn = build.library().repro_glm_stats_grid
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int]
    fn.restype = ctypes.c_int
    nb = fn(n, FAMILY_CODES[family])
    if nb < 1:
        raise RuntimeError(f"glm_stats: no grid for n {n}")
    return nb


def launch(y, xb, weights, family: str, offset=None):
    """(loss, s, w), each (n,) f32, from the CUDA kernel."""
    if family not in FAMILY_CODES:
        raise ValueError(f"glm_stats has no CUDA body for family {family!r}")
    build.check_cuda("glm_stats", torch.float32, y, xb, weights, offset)
    n = y.shape[0]
    for t in (xb, weights, offset):
        if t is not None and t.shape != (n,):
            raise ValueError(f"glm_stats: expected ({n},) vectors, "
                             f"got {tuple(t.shape)}")
    loss, s, w = (torch.empty_like(y) for _ in range(3))
    KERNEL(build.ptr(y), build.ptr(xb), build.ptr(weights),
           build.ptr(offset), build.ptr(loss), build.ptr(s), build.ptr(w),
           n, FAMILY_CODES[family], build.stream_of(y))
    return loss, s, w
