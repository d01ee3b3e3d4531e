"""The mLSTM step scan over a whole sequence, every (batch row, head) in
one launch.

The CUDA kernel is ``csrc/mlstm_scan.cu``.  It replaces no Pallas kernel:
it ports ``repro/models/xlstm.py::_mlstm_core``, a ``lax.scan`` of
``_mlstm_step`` over time that XLA compiles into one loop.  ``plain`` is
its plain PyTorch version (``kernels/ref.py``).  Decode is the same
launch at S = 1.  The keys' head dim may exceed the values' (a block of
hd on a model axis past 1).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.CudaKernel("mlstm_scan", "repro_mlstm_scan",
                          [_P] * 12 + [_I] * 5 + [_P])

MAX_HEAD_DIM = 512      # kMaxHdK in the source: q, k and n in shared memory

plain = ref.mlstm_scan


def launch(q, k, v, i_pre, f_pre, state, out=None):
    """(h (B, S, H, hd_v), (C, n, m)) from the CUDA kernel.  q, k (B, S,
    H, hd_k), k scaled by 1/sqrt(hd); v (B, S, H, hd_v); gates (B, S, H);
    state (C (B, H, hd_k, hd_v), n (B, H, hd_k), m (B, H)), float32 on
    one card.  ``out``: (C, n, m), each a cache's leaf or None; a given
    leaf takes the final state in place (C may be the state's own; n and
    m are read by every block, so the kernel reads a copy where they are
    the state's)."""
    q, k, v, i_pre, f_pre = (t.contiguous() for t in (q, k, v, i_pre,
                                                      f_pre))
    C0, n0, m0 = (t.contiguous() for t in state)
    build.check_cuda("mlstm_scan", torch.float32, q, k, v, i_pre, f_pre, C0,
                     n0, m0)
    B, S, H, hd_k = q.shape
    hd_v = v.shape[-1]
    if k.shape != q.shape or v.shape[:3] != (B, S, H) \
            or i_pre.shape != (B, S, H) or f_pre.shape != (B, S, H) \
            or C0.shape != (B, H, hd_k, hd_v) or n0.shape != (B, H, hd_k) \
            or m0.shape != (B, H) or min(B, S, H, hd_k, hd_v) < 1 \
            or hd_k > MAX_HEAD_DIM:
        raise ValueError(
            f"mlstm_scan: bad shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, gates "
            f"{tuple(i_pre.shape)} {tuple(f_pre.shape)}, state "
            f"{tuple(C0.shape)} {tuple(n0.shape)} {tuple(m0.shape)}")
    out = (None,) * 3 if out is None else tuple(out)
    C, n, m = (build.out_buffer(o, s.shape, q)
               for o, s in zip(out, (C0, n0, m0)))
    if n.data_ptr() == n0.data_ptr():
        n0 = n0.clone()
    if m.data_ptr() == m0.data_ptr():
        m0 = m0.clone()
    hs = torch.empty((B, S, H, hd_v), dtype=torch.float32, device=q.device)
    KERNEL(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(i_pre),
           build.ptr(f_pre), build.ptr(C0), build.ptr(n0), build.ptr(m0),
           build.ptr(hs), build.ptr(C), build.ptr(n), build.ptr(m), B, S, H,
           hd_k, hd_v, build.stream_of(q))
    return hs, tuple(build.into(o, s) for o, s in zip(out, (C, n, m)))
