"""Mamba2's selective scan over a whole sequence, every (batch row, head)
in one launch.

The CUDA kernel is ``csrc/ssm_scan.cu``.  It replaces no Pallas kernel:
it ports ``repro/models/ssm.py::_ssm_scan``, a ``lax.scan`` over time
that XLA compiles into one loop.  ``plain`` is its plain PyTorch version
(``kernels/ref.py``).  Decode is the same launch at S = 1.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.CudaKernel("ssm_scan", "repro_ssm_scan",
                          [_P] * 9 + [_I] * 5 + [_P])

MAX_HEAD_DIM, MAX_STATE = 128, 128     # the source's template range

plain = ref.ssm_scan


def launch(xh, Bm, Cm, dt, A, D, state0, out=None):
    """(y (B, S, H, hd), the final state (B, H, hd, ds)) from the CUDA
    kernel.  xh (B, S, H, hd), Bm and Cm (B, S, ds), dt (B, S, H), A and
    D (H,), state0 (B, H, hd, ds), float32 on one card.  ``out``, a
    cache's state, takes the final state in place (it may be state0)."""
    xh, Bm, Cm, dt, A, D, state0 = (t.contiguous() for t in (
        xh, Bm, Cm, dt, A, D, state0))
    build.check_cuda("ssm_scan", torch.float32, xh, Bm, Cm, dt, A, D,
                     state0)
    B, S, H, hd = xh.shape
    ds = Bm.shape[-1]
    if Bm.shape != (B, S, ds) or Cm.shape != (B, S, ds) \
            or dt.shape != (B, S, H) or A.shape != (H,) or D.shape != (H,) \
            or state0.shape != (B, H, hd, ds) or min(B, S, H, hd, ds) < 1 \
            or hd > MAX_HEAD_DIM or ds > MAX_STATE:
        raise ValueError(
            f"ssm_scan: bad shapes x {tuple(xh.shape)}, B "
            f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}, dt {tuple(dt.shape)},"
            f" A {tuple(A.shape)}, D {tuple(D.shape)}, state "
            f"{tuple(state0.shape)}")
    y = torch.empty_like(xh)
    state = build.out_buffer(out, state0.shape, xh)
    KERNEL(build.ptr(xh), build.ptr(Bm), build.ptr(Cm), build.ptr(dt),
           build.ptr(A), build.ptr(D), build.ptr(state0), build.ptr(y),
           build.ptr(state), B, S, H, hd, ds, build.stream_of(xh))
    return y, build.into(out, state)
