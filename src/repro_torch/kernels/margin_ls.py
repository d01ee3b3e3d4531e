"""K6 margin_ls: fused launch 2 of the Jacobi superstep (dense).

The CUDA kernel is ``csrc/margin_ls.cu``; it replaces
``repro/kernels/superstep_tile.py::margin_ls_pallas``.  ``plain`` is its
plain PyTorch version (``kernels/ref.py``).  One logical launch is two CUDA
launches: the streamed pass (fixed row ranges, one block an SM at a time)
and the fixed-order finishing sum over its blocks.  The bf16 mode
(``precision="bf16"``, the Pallas body's bf16 branch) rounds X and dbeta
to bfloat16 inside the pass; it counts its launches apart
(``KERNEL_BF16``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.glm_stats import FAMILY_CODES

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, ctypes.c_longlong, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
         _I, _I, _P]
KERNEL = build.CudaKernel("margin_ls", "repro_margin_ls", _ARGS)
KERNEL_BF16 = build.CudaKernel("margin_ls_bf16", "repro_margin_ls", _ARGS)

ROWS_PER_BLOCK = 1024     # kRowsPerBlock in the source: least rows a block

plain = ref.fused_ls_dense


def launch(X, dbeta, y, xb, weights, alphas, family: str, offset=None, *,
           precision: str = "fp32"):
    """(xdb (n,), losses (K,)) from the CUDA kernel; X (n, p) row-major with
    p a multiple of 4, read in place; ``precision`` "bf16" runs the bf16
    mode."""
    bf16 = ref.is_bf16(precision)
    if family not in FAMILY_CODES:
        raise ValueError(f"margin_ls has no CUDA body for family {family!r}")
    build.check_cuda("margin_ls", torch.float32, X, dbeta, y, xb, weights,
                     alphas, offset)
    n, p = X.shape
    if p % 4 or X.data_ptr() % 16 or dbeta.data_ptr() % 16 \
            or dbeta.shape != (p,) or n == 0 or any(
            t is not None and t.shape != (n,)
            for t in (y, xb, weights, offset)) \
            or alphas.dim() != 1 or alphas.shape[0] == 0:
        raise ValueError(
            f"margin_ls: bad shapes X {tuple(X.shape)} (p a multiple of 4; X "
            f"and dbeta 16-byte aligned), dbeta {tuple(dbeta.shape)}, alphas "
            f"{tuple(alphas.shape)}")
    K = alphas.shape[0]
    nblocks = -(-n // ROWS_PER_BLOCK)       # at least the pass's grid
    f32 = dict(dtype=torch.float32, device=X.device)
    xdb = torch.empty(n, **f32)
    partials = torch.empty(nblocks * K, **f32)
    losses = torch.empty(K, **f32)
    (KERNEL_BF16 if bf16 else KERNEL)(
        build.ptr(X), n, p, build.ptr(dbeta), build.ptr(y), build.ptr(xb),
        build.ptr(weights), build.ptr(offset), build.ptr(alphas), K,
        build.ptr(xdb), build.ptr(partials), build.ptr(losses),
        FAMILY_CODES[family], int(bf16), build.stream_of(X))
    return xdb, losses


def grid(n: int, p: int) -> int:
    """The blocks of the pass ``launch`` runs for n rows of p columns on the
    current card: four times the SM count times the blocks an SM holds, at
    most one per ``ROWS_PER_BLOCK`` rows."""
    fn = build.library().repro_margin_ls_grid
    fn.argtypes = [ctypes.c_longlong, _I]
    fn.restype = _I
    nb = fn(n, p)
    if nb < 1:
        raise RuntimeError(f"margin_ls: no grid for n {n}, p {p}")
    return nb
