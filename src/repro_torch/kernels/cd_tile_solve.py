"""K2 cd_tile_solve: the exact sequential coordinate chain of a tile.

The CUDA kernel is ``csrc/cd_tile_solve.cu`` (the chain itself in
``csrc/cd_chain.cuh``); it replaces
``repro/kernels/cd_tile_solve.py::cd_tile_solve_pallas``.  ``launch``
solves one tile (Gauss-Seidel), ``launch_tiles`` every tile of a Jacobi
sweep in one launch; both count as launches of the one kernel.  ``plain``
is its plain PyTorch version (``kernels/ref.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.CudaKernel(
    "cd_tile_solve", "repro_cd_tile_solve",
    [_P, _P, _P, ctypes.c_longlong, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P])

MAX_T = 1024          # one thread per coordinate, one block a tile

plain = ref.cd_tile_solve


def _check_params(params, penf, n):
    if params.shape != (4,) or (penf is not None and penf.shape != (n,)):
        raise ValueError(
            f"cd_tile_solve: bad shapes params {tuple(params.shape)}, penf "
            f"{None if penf is None else tuple(penf.shape)} (want (4,), "
            f"({n},))")


def launch(G, g, h, beta_t, dbeta_t, params, penf):
    """New (T,) step of one tile from the CUDA kernel.  ``h`` may be any
    (T,) view, such as ``torch.diagonal(G)``; ``params`` is a device (4,)
    f32 tensor [mu, nu, lam1, lam2]; ``penf`` the (T,) penalty factors or
    None for all ones."""
    build.check_cuda("cd_tile_solve", torch.float32, G, g, beta_t, dbeta_t,
                     params, penf)
    T = g.shape[0]
    if G.shape != (T, T) or T > MAX_T or any(
            t.shape != (T,) for t in (h, beta_t, dbeta_t)):
        raise ValueError(
            f"cd_tile_solve: bad shapes G {tuple(G.shape)}, g ({T},) "
            f"(T <= {MAX_T})")
    _check_params(params, penf, T)
    if not h.is_cuda or h.dtype != torch.float32 or h.device != g.device:
        raise ValueError(f"cd_tile_solve: h must be a float32 CUDA tensor "
                         f"on {g.device}")
    out = torch.empty_like(g)
    KERNEL(build.ptr(G), build.ptr(g), build.ptr(h), h.stride(0),
           build.ptr(beta_t), build.ptr(dbeta_t), build.ptr(penf),
           build.ptr(params), None, 1, 1, T, build.ptr(out),
           build.stream_of(g))
    return out


def launch_tiles(G_all, g_all, beta, params, order, n_live: int, penf):
    """The (p,) Jacobi step in one launch: block z runs the chain of tile
    ``order[z]`` from a zero step with h = diag(G); blocks z >= ``n_live``
    write zeros.  G_all (nt, T, T), g_all (nt, T), beta and penf (p,)
    (``penf`` None for all ones), ``order`` (nt,) int32 on the card, live
    tiles first (``ops.tile_order``)."""
    build.check_cuda("cd_tile_solve", torch.float32, G_all, g_all, beta,
                     params, penf)
    build.check_cuda("cd_tile_solve", torch.int32, order)
    nt, T = g_all.shape
    if G_all.shape != (nt, T, T) or T > MAX_T or beta.shape != (nt * T,) \
            or order.shape != (nt,) or not 0 <= n_live <= nt:
        raise ValueError(
            f"cd_tile_solve: bad shapes G_all {tuple(G_all.shape)}, g_all "
            f"{tuple(g_all.shape)}, order {tuple(order.shape)}, n_live "
            f"{n_live} (T <= {MAX_T})")
    _check_params(params, penf, nt * T)
    out = torch.empty_like(beta)
    KERNEL(build.ptr(G_all), build.ptr(g_all), None, 0, build.ptr(beta),
           None, build.ptr(penf), build.ptr(params), build.ptr(order),
           n_live, nt, T, build.ptr(out), build.stream_of(beta))
    return out

