"""The sLSTM scan over a whole sequence, every (batch row, head) in one
launch (a thread block cluster a head).

The CUDA kernel is ``csrc/slstm_scan.cu``.  It replaces no Pallas kernel:
it ports the ``lax.scan`` of ``repro/models/xlstm.py::_slstm_step`` in
``slstm_apply``, which XLA compiles into one loop.  ``plain`` is its plain
PyTorch version (``kernels/ref.py``).  Decode is the same launch at one
step.  On a model axis past 1 every step needs the whole h of the step
before, gathered over ranks: there the caller launches one step at a
time around that gather, with the head-level stabilizers' sums over the
whole hd given (``sc``).  In its training mode (``save``) the forward
also writes every step's gate pre-activations, c, n and m;
``launch_bwd`` runs the backward kernel, ``csrc/slstm_scan_bwd.cu`` (the
transpose of the same ``lax.scan``, ``plain_bwd``), from those.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.CudaKernel("slstm_scan", "repro_slstm_scan",
                          [_P] * 16 + [_I] * 6 + [_P])
KERNEL_BWD = build.CudaKernel("slstm_scan_bwd", "repro_slstm_scan_bwd",
                              [_P] * 21 + [_I] * 5 + [_P])

MAX_HEAD_DIM = 512      # kMaxHdK in the source: the whole h in shared memory

plain = ref.slstm_scan
plain_bwd = ref.slstm_scan_bwd


def plan(hd_v: int) -> tuple:
    """(columns a block, blocks a cluster) of a launch over hd_v columns
    on the current card."""
    fn = build.library().repro_slstm_scan_plan
    fn.argtypes = [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    fn.restype = _I
    w, c = _I(0), _I(0)
    err = fn(hd_v, ctypes.byref(w), ctypes.byref(c))
    if err != 0:
        raise RuntimeError(f"slstm_scan: no launch plan for hd {hd_v} "
                           f"(CUDA error {err})")
    return w.value, c.value


def launch(r, state, gates_in, steps: int, sc=None, out=None,
           save: bool = False):
    """(h (B, steps, H, hd_v), (c, n, h, m)) from the CUDA kernel over the
    first ``steps`` positions of gates_in (B, S, 4, H, hd_v), with r (H,
    4, hd_k, hd_v) and state (c, n (B, H, hd_v), h (B, H, hd_k), m (B,
    H)), float32 on one card; ``sc`` (B, 2, H) as ``ref.slstm_scan``'s.
    ``out``: (c, n, h, m), each a cache's leaf or None; a given leaf takes
    the final state in place (it may be the state's own).  With ``save``,
    also every step's (gate pre-activations (B, steps, 4, H, hd_v), c, n
    (B, steps, H, hd_v), m (B, steps, H)), as ``plain``'s."""
    r, gates_in = r.contiguous(), gates_in.contiguous()
    c0, n0, h0, m0 = (t.contiguous() for t in state)
    sc = None if sc is None else sc.contiguous()
    build.check_cuda("slstm_scan", torch.float32, r, gates_in, c0, n0, h0,
                     m0, sc)
    B, S, _, H, hd_v = gates_in.shape
    hd_k = r.shape[2]
    if r.shape != (H, 4, hd_k, hd_v) or gates_in.shape[2] != 4 \
            or c0.shape != (B, H, hd_v) or n0.shape != (B, H, hd_v) \
            or h0.shape != (B, H, hd_k) or m0.shape != (B, H) \
            or not 1 <= steps <= S or min(B, H, hd_v) < 1 \
            or hd_k > MAX_HEAD_DIM \
            or (sc is None and hd_k != hd_v) \
            or (sc is not None and (sc.shape != (B, 2, H) or steps != 1)):
        raise ValueError(
            f"slstm_scan: bad shapes r {tuple(r.shape)}, gates "
            f"{tuple(gates_in.shape)}, state {tuple(c0.shape)} "
            f"{tuple(n0.shape)} {tuple(h0.shape)} {tuple(m0.shape)}, "
            f"steps {steps}, sc {None if sc is None else tuple(sc.shape)}")
    out = (None,) * 4 if out is None else tuple(out)
    c, n, h, m = (build.out_buffer(o, shp, r) for o, shp in zip(
        out, (c0.shape, n0.shape, (B, H, hd_v), m0.shape)))
    f32 = dict(dtype=torch.float32, device=r.device)
    hs = torch.empty((B, steps, H, hd_v), **f32)
    saved = (torch.empty((B, steps, 4, H, hd_v), **f32),
             torch.empty((B, steps, H, hd_v), **f32),
             torch.empty((B, steps, H, hd_v), **f32),
             torch.empty((B, steps, H), **f32)) if save else (None,) * 4
    KERNEL(build.ptr(gates_in), build.ptr(r), build.ptr(c0), build.ptr(n0),
           build.ptr(h0), build.ptr(m0), build.ptr(sc), build.ptr(hs),
           build.ptr(c), build.ptr(n), build.ptr(h), build.ptr(m),
           *map(build.ptr, saved), B, S, steps, H, hd_k, hd_v,
           build.stream_of(r))
    st = tuple(build.into(o, s) for o, s in zip(out, (c, n, h, m)))
    return (hs, st, saved) if save else (hs, st)


def launch_bwd(r, state0, sc, saved, hs, dhs, dc, dn, dh, dm):
    """(dpre (B, steps, 4, H, hd_v), dr, (dc0, dn0, dh0, dm0), dsc or
    None), as ``plain_bwd``'s: r, the initial state, sc, ``saved``
    (``launch``'s with ``save``), the output hs and the cotangents of hs
    and of the final (c, n, h, m), float32 on one card.  The kernel gives
    dpre, the initial state's gradients and dsc; dr = sum over rows and
    steps of h_{t-1} dpre_t is one product after it."""
    c0, n0, h0, m0 = (t.contiguous() for t in state0)
    pre, cs, ns, ms = (t.contiguous() for t in saved)
    r, hs, dhs, dc, dn, dh, dm = (t.contiguous() for t in (
        r, hs, dhs, dc, dn, dh, dm))
    sc = None if sc is None else sc.contiguous()
    build.check_cuda("slstm_scan_bwd", torch.float32, r, c0, n0, h0, m0, sc,
                     pre, cs, ns, ms, hs, dhs, dc, dn, dh, dm)
    B, steps, _, H, hd_v = pre.shape
    hd_k = r.shape[2]
    if r.shape != (H, 4, hd_k, hd_v) or cs.shape != (B, steps, H, hd_v) \
            or ns.shape != cs.shape or ms.shape != (B, steps, H) \
            or hs.shape != cs.shape or dhs.shape != cs.shape \
            or h0.shape != (B, H, hd_k) or dh.shape != (B, H, hd_v) \
            or hd_k > MAX_HEAD_DIM or (sc is None and hd_k != hd_v) \
            or (sc is not None and (sc.shape != (B, 2, H) or steps != 1)):
        raise ValueError(
            f"slstm_scan_bwd: bad shapes r {tuple(r.shape)}, pre "
            f"{tuple(pre.shape)}, h0 {tuple(h0.shape)}, dh "
            f"{tuple(dh.shape)}, sc {None if sc is None else tuple(sc.shape)}")
    dpre = torch.empty_like(pre)
    dst = (torch.empty_like(dc), torch.empty_like(dn), torch.empty_like(h0),
           torch.empty_like(dm))
    dsc = None if sc is None else torch.empty_like(sc)
    KERNEL_BWD(*map(build.ptr, (r, c0, n0, m0, sc, pre, cs, ns, ms, hs, dhs,
                                dc, dn, dh, dm, dpre, *dst, dsc)),
               B, steps, H, hd_k, hd_v, build.stream_of(r))
    return dpre, ref.slstm_dr(h0, hs, dpre), dst, dsc
