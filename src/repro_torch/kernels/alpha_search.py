"""K4 alpha_search: the line search's candidate losses in one pass.

The CUDA kernel is ``csrc/alpha_search.cu``; it replaces
``repro/kernels/alpha_search.py::alpha_search_pallas``.  ``plain`` is its
plain PyTorch version (``kernels/ref.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.glm_stats import FAMILY_CODES

_P = ctypes.c_void_p
KERNEL = build.CudaKernel(
    "alpha_search", "repro_alpha_search",
    [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P,
     ctypes.c_int, _P, ctypes.c_int, _P])

K_GROUP = 32          # candidates per block row (kKMax in the source)
THREADS = 256
MAX_BLOCKS = 132 * 4  # four blocks per SM of an H100

plain = ref.alpha_search


def launch(y, xb, xdb, weights, alphas, family: str, offset=None):
    """(K,) f32 losses from the CUDA kernel."""
    if family not in FAMILY_CODES:
        raise ValueError(
            f"alpha_search has no CUDA body for family {family!r}")
    build.check_cuda("alpha_search", torch.float32, y, xb, xdb, weights,
                     alphas, offset)
    n = y.shape[0]
    for t in (xb, xdb, weights, offset):
        if t is not None and t.shape != (n,):
            raise ValueError(f"alpha_search: expected ({n},) vectors, "
                             f"got {tuple(t.shape)}")
    if alphas.dim() != 1 or alphas.shape[0] == 0:
        raise ValueError("alpha_search: alphas must be a non-empty (K,)")
    K = alphas.shape[0]
    nblocks = max(1, min(-(-n // THREADS), MAX_BLOCKS))
    groups = -(-K // K_GROUP)
    partials = torch.empty(groups * nblocks * K_GROUP, dtype=torch.float32,
                           device=y.device)
    out = torch.empty(K, dtype=torch.float32, device=y.device)
    KERNEL(build.ptr(y), build.ptr(xb), build.ptr(xdb), build.ptr(weights),
           build.ptr(offset), build.ptr(alphas), K, n, build.ptr(partials),
           nblocks, build.ptr(out), FAMILY_CODES[family],
           build.stream_of(y))
    return out
