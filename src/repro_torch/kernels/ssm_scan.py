"""Mamba2's selective scan over a whole sequence, every (batch row, head)
in one launch.

The CUDA kernel is ``csrc/ssm_scan.cu``.  It replaces no Pallas kernel:
it ports ``repro/models/ssm.py::_ssm_scan``, a ``lax.scan`` over time
that XLA compiles into one loop.  ``plain`` is its plain PyTorch version
(``kernels/ref.py``).  Decode is the same launch at S = 1.  In its
training mode (``ckpt_every``) the forward also writes the state every L
steps; ``launch_bwd`` runs the backward kernel, ``csrc/ssm_scan_bwd.cu``
(the transpose of the same ``lax.scan``, ``plain_bwd``), from those
checkpoints.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.CudaKernel("ssm_scan", "repro_ssm_scan",
                          [_P] * 10 + [_I] * 6 + [_P])
KERNEL_BWD = build.CudaKernel("ssm_scan_bwd", "repro_ssm_scan_bwd",
                              [_P] * 20 + [_I] * 6 + [_P])

MAX_HEAD_DIM, MAX_STATE = 128, 128     # the source's template range

plain = ref.ssm_scan
plain_bwd = ref.ssm_scan_bwd


def launch(xh, Bm, Cm, dt, A, D, state0, out=None, ckpt_every: int = 0):
    """(y (B, S, H, hd), the final state (B, H, hd, ds)) from the CUDA
    kernel.  xh (B, S, H, hd), Bm and Cm (B, S, ds), dt (B, S, H), A and
    D (H,), state0 (B, H, hd, ds), float32 on one card.  ``out``, a
    cache's state, takes the final state in place (it may be state0).
    With ``ckpt_every`` L, also the states before steps 0, L, 2L, ...
    (ceil(S / L), B, H, hd, ds), as ``plain``'s."""
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
    ckpt = torch.empty((-(-S // ckpt_every), B, H, hd, ds),
                       dtype=torch.float32, device=xh.device) \
        if ckpt_every else None
    KERNEL(build.ptr(xh), build.ptr(Bm), build.ptr(Cm), build.ptr(dt),
           build.ptr(A), build.ptr(D), build.ptr(state0), build.ptr(y),
           build.ptr(state), build.ptr(ckpt), B, S, H, hd, ds, ckpt_every,
           build.stream_of(xh))
    if ckpt_every:
        return y, build.into(out, state), ckpt
    return y, build.into(out, state)


def launch_bwd(xh, Bm, Cm, dt, A, D, ckpt, dy, dh, ckpt_every: int):
    """(dxh, dBm, dCm, ddt, dA, dD, dstate0) from the backward kernel, as
    ``plain_bwd``'s: the forward's inputs, its checkpoints (``launch``'s
    with ``ckpt_every``), and the cotangents of y (dy) and of the final
    state (dh), float32 on one card.  The sums over heads (dBm, dCm) and
    over rows (dA, dD) go through per-(b, h) partials summed in a fixed
    order: two runs give the same bits."""
    xh, Bm, Cm, dt, A, D, ckpt, dy, dh = (t.contiguous() for t in (
        xh, Bm, Cm, dt, A, D, ckpt, dy, dh))
    build.check_cuda("ssm_scan_bwd", torch.float32, xh, Bm, Cm, dt, A, D,
                     ckpt, dy, dh)
    B, S, H, hd = xh.shape
    ds = Bm.shape[-1]
    L = ckpt_every
    if L < 1 or ckpt.shape != (-(-S // L), B, H, hd, ds) \
            or dy.shape != xh.shape or dh.shape != (B, H, hd, ds) \
            or hd > MAX_HEAD_DIM or ds > MAX_STATE:
        raise ValueError(
            f"ssm_scan_bwd: bad shapes x {tuple(xh.shape)}, checkpoints "
            f"{tuple(ckpt.shape)} every {L}, dy {tuple(dy.shape)}, dh "
            f"{tuple(dh.shape)}")
    f32 = dict(dtype=torch.float32, device=xh.device)
    dx, ddt = torch.empty_like(xh), torch.empty_like(dt)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    ds0 = torch.empty_like(dh)
    dBp = torch.empty((B, S, H, ds), **f32)
    dCp = torch.empty((B, S, H, ds), **f32)
    dADp = torch.empty((2, B, H), **f32)
    scratch = torch.empty((B * H, L + 1, hd * ds), **f32)
    KERNEL_BWD(*map(build.ptr, (xh, Bm, Cm, dt, A, D, ckpt, dy, dh, dx, dB,
                                dC, ddt, dA, dD, ds0, dBp, dCp, dADp,
                                scratch)),
               B, S, H, hd, ds, L, build.stream_of(xh))
    return dx, dB, dC, ddt, dA, dD, ds0
