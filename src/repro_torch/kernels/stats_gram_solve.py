"""K5 stats_gram_solve: fused launch 1 of the Jacobi superstep (dense).

The CUDA kernel is ``csrc/stats_gram_solve.cu``; it replaces
``repro/kernels/superstep_tile.py::stats_gram_solve_pallas``; its Gram
products run on the tensor cores with the 3xTF32 split of
``csrc/gram_tc.cuh``, or, in the bf16 mode (``precision="bf16"``, the
Pallas body's bf16 branch), as one bf16 product.  ``plain`` is its plain
PyTorch version (``kernels/ref.py``).  One logical launch is three CUDA
launches: the partial Gram with the stats inline, a fixed-order
reduction, and the tile solves.  The two modes count their launches apart
(``KERNEL``, ``KERNEL_BF16``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, gram_tc, ref
from repro_torch.kernels.glm_stats import FAMILY_CODES

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, ctypes.c_longlong, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
         _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P]
KERNEL = build.CudaKernel("stats_gram_solve", "repro_stats_gram_solve",
                          _ARGS)
KERNEL_BF16 = build.CudaKernel("stats_gram_solve_bf16",
                               "repro_stats_gram_solve", _ARGS)

SUB = 64              # T must be a multiple of it (the least block edge)

plain = ref.stats_gram_solve


def launch(X, y, xb, weights, offset, beta, penf, params, order, n_live: int,
           T: int, family: str, *, precision: str = "fp32"):
    """(loss, s, w (n,), G_all (nt, T, T), g_all (nt, T), dbeta (p,)) from
    the CUDA kernel.

    X (n, p) row-major, p = nt * T, read in place; ``params`` the device
    (4,) f32 [mu, nu, lam1, lam2]; ``order`` (nt,) int32 on the card, the
    live tiles first; ``n_live`` their count (a host int).  ``precision``
    "bf16" runs the bf16 mode (G is then not symmetric).
    """
    bf16 = ref.is_bf16(precision)
    if family not in FAMILY_CODES:
        raise ValueError(
            f"stats_gram_solve has no CUDA body for family {family!r}")
    build.check_cuda("stats_gram_solve", torch.float32, X, y, xb, weights,
                     offset, beta, penf, params)
    build.check_cuda("stats_gram_solve", torch.int32, order)
    n, p = X.shape
    nt = p // T if T > 0 else 0
    if T % SUB or T > 1024 or nt * T != p or order.shape != (nt,) \
            or params.shape != (4,) or not 0 <= n_live <= nt or any(
                t is not None and t.shape != (n,)
                for t in (y, xb, weights, offset)) \
            or beta.shape != (p,) or penf.shape != (p,):
        raise ValueError(
            f"stats_gram_solve: bad shapes X {tuple(X.shape)}, T {T}, order "
            f"{tuple(order.shape)}, n_live {n_live} (T a multiple of {SUB}, "
            "at most 1024)")
    if X.data_ptr() % 16:
        raise ValueError("stats_gram_solve: X must be 16-byte aligned")
    # row ranges of whole slabs: at most MAX_RANGE_ROWS rows, and enough
    # blocks (live tiles x upper blocks x ranges) for every SM
    bn, npairs = gram_tc.band(T), gram_tc.n_pairs(T, bf16)
    splits = gram_tc.ranges(max(n, 1), max(n_live, 1) * npairs,
                            gram_tc.MAX_RANGE_ROWS,
                            gram_tc.sm_count(X.device))
    per = -(-max(n, 1) // splits)
    per = -(-per // gram_tc.SLAB) * gram_tc.SLAB
    splits = -(-max(n, 1) // per)
    slots = splits * max(n_live, 1)
    dev = X.device
    f32 = dict(dtype=torch.float32, device=dev)
    Gp = torch.empty(slots * npairs * bn * bn, **f32)
    gp = torch.empty(slots * T, **f32)
    loss, s, w = (torch.empty(n, **f32) for _ in range(3))
    G = torch.empty((nt, T, T), **f32)
    g = torch.empty((nt, T), **f32)
    dbeta = torch.empty(p, **f32)
    (KERNEL_BF16 if bf16 else KERNEL)(
        build.ptr(X), n, p, T, build.ptr(y), build.ptr(xb),
        build.ptr(weights), build.ptr(offset), build.ptr(beta),
        build.ptr(penf), build.ptr(params), build.ptr(order), n_live,
        splits, per, bn, int(bf16), build.ptr(Gp), build.ptr(gp),
        build.ptr(loss), build.ptr(s), build.ptr(w), build.ptr(G),
        build.ptr(g), build.ptr(dbeta), FAMILY_CODES[family],
        build.stream_of(X))
    return loss, s, w, G, g, dbeta
