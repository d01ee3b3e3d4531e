"""One epoch of distributed online truncated gradient, every shard's pass
over its rows in one launch.

The CUDA kernel is ``csrc/online_tg.cu``.  It replaces no Pallas kernel:
it ports ``repro/baselines/online_tg.py::_epoch``, a ``lax.scan`` over a
shard's rows under a ``jax.vmap`` over shards, which XLA compiles into one
loop.  ``plain`` is its plain PyTorch version (``kernels/ref.py``).  The
family's statistics are K1's (``csrc/glm_family.cuh``), so its family set
is ``glm_stats.FAMILY_CODES``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.glm_stats import FAMILY_CODES

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNEL = build.CudaKernel(
    "online_tg", "repro_online_tg",
    [_P, _P, _P, _P, _I, ctypes.c_longlong, _I, _F, _F, _F, _F, _F, _I, _P])

plain = ref.online_tg_epoch


def smem_features() -> int:
    """The most features whose weights the kernel keeps in shared memory;
    past it they live in global memory."""
    fn = build.library().repro_online_tg_smem_features
    fn.argtypes = []
    fn.restype = _I
    return fn()


def launch(X_sh, y_sh, w0, t0, family: str, lr: float, power: float,
           lam1: float, lam2: float):
    """The shards' mean weight (p,) after one pass of each from w0 at
    global step t0.  X_sh (M, n_per, p), y_sh (M, n_per), w0 (p,), all
    float32 on one card."""
    if family not in FAMILY_CODES:
        raise ValueError(f"online_tg has no CUDA body for family {family!r}")
    build.check_cuda("online_tg", torch.float32, X_sh, y_sh, w0)
    M, n_per, p = X_sh.shape
    if y_sh.shape != (M, n_per) or w0.shape != (p,) or min(M, p) < 1:
        raise ValueError(
            f"online_tg: bad shapes X_sh {tuple(X_sh.shape)}, y_sh "
            f"{tuple(y_sh.shape)}, w0 {tuple(w0.shape)}")
    ws = torch.empty((M, p), dtype=w0.dtype, device=w0.device)
    KERNEL(build.ptr(X_sh), build.ptr(y_sh), build.ptr(w0), build.ptr(ws),
           M, n_per, p, float(np.float32(t0)), lr, power, lam1, lam2,
           FAMILY_CODES[family], build.stream_of(w0))
    return torch.mean(ws, dim=0)
