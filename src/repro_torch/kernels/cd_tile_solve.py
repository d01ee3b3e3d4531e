"""K2 cd_tile_solve: the exact sequential coordinate chain of one tile.

The CUDA kernel is ``csrc/cd_tile_solve.cu``; it replaces
``repro/kernels/cd_tile_solve.py::cd_tile_solve_pallas``.  ``plain`` is its
plain PyTorch version (``kernels/ref.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
KERNEL = build.CudaKernel(
    "cd_tile_solve", "repro_cd_tile_solve",
    [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, _P])

MAX_T = 1024          # one thread per coordinate, one block

plain = ref.cd_tile_solve


def launch(G, g, h, beta_t, dbeta_t, params, penf):
    """New (T,) step from the CUDA kernel.  ``params`` is a device (4,) f32
    tensor [mu, nu, lam1, lam2]; ``penf`` the (T,) penalty factors."""
    build.check_cuda("cd_tile_solve", torch.float32, G, g, h, beta_t,
                     dbeta_t, params, penf)
    T = g.shape[0]
    if G.shape != (T, T) or params.shape != (4,) or T > MAX_T or any(
            t.shape != (T,) for t in (h, beta_t, dbeta_t, penf)):
        raise ValueError(
            f"cd_tile_solve: bad shapes G {tuple(G.shape)}, g ({T},), "
            f"params {tuple(params.shape)} (T <= {MAX_T})")
    out = torch.empty_like(g)
    KERNEL(build.ptr(G), build.ptr(g), build.ptr(h), build.ptr(beta_t),
           build.ptr(dbeta_t), build.ptr(penf), build.ptr(params),
           build.ptr(out), T, build.stream_of(g))
    return out
