"""The mLSTM step scan over a whole sequence, every (batch row, head) in
one launch.

The CUDA kernel is ``csrc/mlstm_scan.cu``.  It replaces no Pallas kernel:
it ports ``repro/models/xlstm.py::_mlstm_core``, a ``lax.scan`` of
``_mlstm_step`` over time that XLA compiles into one loop.  ``plain`` is
its plain PyTorch version (``kernels/ref.py``).  Decode is the same
launch at S = 1.  The keys' head dim may exceed the values' (a block of
hd on a model axis past 1).  In its training mode (``ckpt_every``) the
forward also writes (C, n) every L steps and every step's m and q.n;
``launch_bwd`` runs the backward kernels, ``csrc/mlstm_scan_bwd.cu`` (the
transpose of the same ``lax.scan``, ``plain_bwd``), from those.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.CudaKernel("mlstm_scan", "repro_mlstm_scan",
                          [_P] * 16 + [_I] * 6 + [_P])
KERNEL_BWD = build.CudaKernel("mlstm_scan_bwd", "repro_mlstm_scan_bwd",
                              [_P] * 26 + [_I] * 6 + [_P])

MAX_HEAD_DIM = 512      # kMaxHdK in the source: q, k and n in shared memory
BWD_ROWS = 32           # kRows in csrc/mlstm_scan_bwd.cu: rows of C a block

plain = ref.mlstm_scan
plain_bwd = ref.mlstm_scan_bwd


def launch(q, k, v, i_pre, f_pre, state, out=None, ckpt_every: int = 0):
    """(h (B, S, H, hd_v), (C, n, m)) from the CUDA kernel.  q, k (B, S,
    H, hd_k), k scaled by 1/sqrt(hd); v (B, S, H, hd_v); gates (B, S, H);
    state (C (B, H, hd_k, hd_v), n (B, H, hd_k), m (B, H)), float32 on
    one card.  ``out``: (C, n, m), each a cache's leaf or None; a given
    leaf takes the final state in place (C may be the state's own; n and
    m are read by every block, so the kernel reads a copy where they are
    the state's).  With ``ckpt_every`` L, also (C and n before steps 0,
    L, 2L, ..., every step's m and q.n (B, S, H)), as ``plain``'s."""
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
    f32 = dict(dtype=torch.float32, device=q.device)
    hs = torch.empty((B, S, H, hd_v), **f32)
    saved = (None,) * 4
    if ckpt_every:
        n_seg = -(-S // ckpt_every)
        saved = (torch.empty((n_seg, B, H, hd_k, hd_v), **f32),
                 torch.empty((n_seg, B, H, hd_k), **f32),
                 torch.empty((B, S, H), **f32), torch.empty((B, S, H), **f32))
    KERNEL(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(i_pre),
           build.ptr(f_pre), build.ptr(C0), build.ptr(n0), build.ptr(m0),
           build.ptr(hs), build.ptr(C), build.ptr(n), build.ptr(m),
           *map(build.ptr, saved), B, S, H, hd_k, hd_v, ckpt_every,
           build.stream_of(q))
    st = tuple(build.into(o, s) for o, s in zip(out, (C, n, m)))
    return (hs, st, saved) if ckpt_every else (hs, st)


def launch_bwd(q, k, v, i_pre, f_pre, m0, saved, hs, dhs, dC, dn, dm,
               ckpt_every: int):
    """(dq, dk, dv, di_pre, df_pre, dC0, dn0, dm0) from the backward
    kernels, as ``plain_bwd``'s: the forward's inputs, m0, ``saved``
    (``launch``'s with ``ckpt_every``), its output hs, and the
    cotangents of hs and of the final (C, n, m), float32 on one card.
    dv's sum over the blocks of rows and the gates' sums over C go
    through per-block partials summed in a fixed order: two runs give the
    same bits."""
    q, k, v, i_pre, f_pre, m0, hs, dhs, dC, dn, dm = (
        t.contiguous() for t in (q, k, v, i_pre, f_pre, m0, hs, dhs, dC, dn,
                                 dm))
    C_ck, n_ck, ms, qns = (t.contiguous() for t in saved)
    build.check_cuda("mlstm_scan_bwd", torch.float32, q, k, v, i_pre, f_pre,
                     m0, C_ck, n_ck, ms, qns, hs, dhs, dC, dn, dm)
    B, S, H, hd_k = q.shape
    hd_v = v.shape[-1]
    L = ckpt_every
    n_seg = -(-S // max(L, 1))
    if L < 1 or C_ck.shape != (n_seg, B, H, hd_k, hd_v) \
            or n_ck.shape != (n_seg, B, H, hd_k) or ms.shape != (B, S, H) \
            or qns.shape != (B, S, H) or hs.shape != (B, S, H, hd_v) \
            or dhs.shape != hs.shape or dC.shape != (B, H, hd_k, hd_v) \
            or dn.shape != (B, H, hd_k) or dm.shape != (B, H) \
            or hd_k > MAX_HEAD_DIM or hd_v > MAX_HEAD_DIM:
        raise ValueError(
            f"mlstm_scan_bwd: bad shapes q {tuple(q.shape)}, v "
            f"{tuple(v.shape)}, checkpoints {tuple(C_ck.shape)} every {L}, "
            f"dh {tuple(dhs.shape)}, dC {tuple(dC.shape)}")
    f32 = dict(dtype=torch.float32, device=q.device)
    n_blk = -(-hd_k // BWD_ROWS)
    outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(i_pre), torch.empty_like(f_pre),
            torch.empty_like(dC), torch.empty_like(dn), torch.empty_like(dm))
    dvp = torch.empty((n_blk, B, S, H, hd_v), **f32)
    gp = torch.empty((B * H, S, 2 * n_blk + 1), **f32)
    scratch = torch.empty((B * H * n_blk, L + 1, BWD_ROWS * hd_v), **f32)
    KERNEL_BWD(*map(build.ptr, (q, k, v, i_pre, f_pre, m0, C_ck, n_ck, ms,
                                qns, hs, dhs, dC, dn, dm, *outs, dvp, gp,
                                scratch)),
               B, S, H, hd_k, hd_v, L, build.stream_of(q))
    return outs
