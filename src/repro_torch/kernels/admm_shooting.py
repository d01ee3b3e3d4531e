"""The ADMM x-update (Shooting) of every feature block, in one launch.

The CUDA kernel is ``csrc/admm_shooting.cu``.  It replaces no Pallas
kernel: it ports ``repro/baselines/admm.py::_shooting_pass``, a
``lax.fori_loop`` over a block's coordinates under a ``lax.scan`` over
passes and a ``jax.vmap`` over blocks, which XLA compiles into one loop.
``plain`` is its plain PyTorch version (``kernels/ref.py``).  The blocks
are held column-major, (M, p_block, n).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNEL = build.CudaKernel(
    "admm_shooting", "repro_admm_shooting",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_longlong, _I, _F, _F, _P])

MAX_CLUSTER = 16      # kMaxCluster in the source: the CTAs of one block

plain = ref.shooting_pass


def plan(n: int) -> tuple:
    """(cluster size, r in shared memory) of a launch over n rows on the
    current card."""
    fn = build.library().repro_admm_shooting_plan
    fn.argtypes = [ctypes.c_longlong, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    fn.restype = _I
    c, s = _I(0), _I(0)
    err = fn(n, ctypes.byref(c), ctypes.byref(s))
    if err != 0:
        raise RuntimeError(f"admm_shooting: no launch plan for n {n} "
                           f"(CUDA error {err})")
    return c.value, bool(s.value)


def launch(At, x, v, col_sq, lam1_eff: float, lam2_eff: float,
           passes: int):
    """The new (M, p_block) x from the CUDA kernel: ``passes`` Shooting
    passes of every block.  At (M, p_block, n), x and col_sq (M, p_block),
    v (M, n), all float32 on one card."""
    build.check_cuda("admm_shooting", torch.float32, At, x, v, col_sq)
    M, pb, n = At.shape
    if x.shape != (M, pb) or col_sq.shape != (M, pb) or v.shape != (M, n) \
            or min(M, pb, n) < 1 or passes < 0:
        raise ValueError(
            f"admm_shooting: bad shapes At {tuple(At.shape)}, x "
            f"{tuple(x.shape)}, v {tuple(v.shape)}, col_sq "
            f"{tuple(col_sq.shape)}, passes {passes}")
    x_out = torch.empty_like(x)
    x_cta = torch.empty((M, MAX_CLUSTER, pb), dtype=x.dtype, device=x.device)
    r = torch.empty_like(v)     # r's home where shared memory is too small
    KERNEL(build.ptr(At), build.ptr(v), build.ptr(col_sq), build.ptr(x),
           build.ptr(x_out), build.ptr(x_cta), build.ptr(r), M, pb, n,
           passes, lam1_eff, lam2_eff, build.stream_of(x))
    return x_out
