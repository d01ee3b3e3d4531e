"""xLSTM blocks: mLSTM (matrix memory, exponential gating) and sLSTM
(scalar memory with recurrent gate connections), per Beck et al. 2024.

A port of the JAX package's ``repro.models.xlstm``.  Heads come from
``d_model // n_heads`` (not ``head_dim``).  mLSTM state: C (B, H, hd, hd)
matrix memory, n (B, H, hd) normalizer, m (B, H) gate stabilizer, which
starts at -1e30; sLSTM state: c, n, h (B, H, hd), m (B, H).  Both are
O(1) per decoded token.

The full-sequence forms run the recurrence through ``ops.mlstm_scan`` and
``ops.slstm_scan`` (the reference's ``lax.scan``: one kernel launch on the
card, the plain loop on the CPU and for a training step); decode is the
same scan over one step.  The mLSTM's chunkwise-parallel form runs where
``ssm_chunk > 0``, ``S % ssm_chunk == 0`` and ``S > ssm_chunk``, as the
reference's does.  Each form starts from the cache's state when there is
a cache, writes the final state into it in place, and returns it.

Tensor parallelism (``layout``, a ``model`` axis past 1) splits the head
dim ``hd``, as the reference's specs do (``P(None, None, "model")`` on
``wq``/``wk``/``wv``, the last dim of ``w_gates`` and ``r_gates``), so a
rank holds a block of every head.  mLSTM: ``q`` and ``k`` are gathered
over ``hd`` (``tensor_parallel.gather``: its backward reduce-scatters), so
``q.k``, ``q.n`` and the normalizer are whole on every rank, while ``v``,
``C`` and the numerator keep this rank's ``hd_v`` block.  sLSTM: each
step gathers the whole ``h_{t-1}`` for ``r_gates``' block; the
head-level means of ``i_pre``/``f_pre`` over ``hd`` are sums over
``model`` whose replicated results feed split work, so their gradients
are summed too (``reduce`` then ``copy``): by linearity, once a forward
over the input gates and ``r_gates``' rows, not once a step
(``_head_sums``).  Either way the output
``(B, S, H, hd_v / M)`` is a block of every head, while ``wo``'s columns
and ``w_out``'s rows expect a contiguous block of ``d``: it is gathered
and sliced (``_d_block``).  ``w_out`` gives a partial sum, summed by the
caller; ``wi``/``wf`` are whole, their gradients partial on each rank
(``lm.reduce_grads`` sums them).  The decode state follows the caches'
specs: mLSTM's ``C`` on its last dim and ``n`` on ``hd`` (gathered when
read, since the recurrence keeps ``n`` whole, and this rank's block
written back), sLSTM's ``c``, ``n`` and ``h`` on ``hd``, ``m`` whole.  The widths are read from the
parameters, so the same code runs a block or the whole.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ParamDef, matmul
from repro_torch.sharding import tensor_parallel as tp

_NEG = -1e30


def _heads(cfg):
    return cfg.n_heads, cfg.d_model // cfg.n_heads


def _log_sigmoid(x):
    """log sigmoid(x) as the reference writes it, -softplus(-x)."""
    return -F.softplus(-x)


# whole leaves used inside the mLSTM's tensor-parallel region: each rank's
# gradient covers only its block of hd (summed over ``model`` by
# ``lm.reduce_grads``)
REGION_WHOLE = ("wi", "wf")


def mlstm_defs(cfg):
    d = cfg.d_model
    H, hd = _heads(cfg)
    return {
        "wq": ParamDef((d, H, hd), (None, None, "model")),
        "wk": ParamDef((d, H, hd), (None, None, "model")),
        "wv": ParamDef((d, H, hd), (None, None, "model")),
        "wi": ParamDef((d, H), (None, None), init_scale=0.1),
        "wf": ParamDef((d, H), (None, None), init_scale=0.1),
        "wo": ParamDef((d, d), (None, "model")),
        "w_out": ParamDef((d, d), ("model", None)),
    }


def mlstm_cache_defs(cfg, batch):
    H, hd = _heads(cfg)
    return {
        "C": ParamDef((batch, H, hd, hd), ("data", None, None, "model")),
        "n": ParamDef((batch, H, hd), ("data", None, "model")),
        "m": ParamDef((batch, H), ("data", None)),
    }


def _mlstm_core(q, k, v, i_pre, f_pre, state, out=None):
    """The step recurrence over time (``ops.mlstm_scan``).  q/k: (B,S,H,
    hd); v: (B,S,H,hd_v); gates (B,S,H).  ``out``: the cache's leaves
    that take the final state in place."""
    k = k / math.sqrt(q.shape[-1])
    return ops.mlstm_scan(q, k, v, i_pre, f_pre, state, out=out)


def _mlstm_chunkwise(q, k, v, i_pre, f_pre, state, chunk: int):
    """The chunkwise-parallel mLSTM of the reference: the same per-position
    stabilizer m_t as the step recurrence.  With b_j the within-chunk
    cumulative sum of log sigmoid(f):
      m_j   = b_j + max(m_in, cummax_j(i - b))
      h_j   = [e^{b_j+m_in-m_j} q_j C_in + sum_{l<=j} S_jl v_l] / den_j
      S_jl  = (q_j . k_l) e^{b_j-b_l+i_l-m_j}
      den_j = max(|e^{b_j+m_in-m_j} q_j n_in + sum_l S_jl|, e^{-m_j})
    and the chunk-final (C, n, m) from the same weights at j = L."""
    B, S, H, hd = q.shape
    hd_v = v.shape[-1]
    k = k / math.sqrt(hd)
    nc = S // chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    C_in, n_in, m_in = state
    hs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qb, kb, vb, ib, fb = q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl], \
            f_pre[:, sl]
        b = torch.cumsum(_log_sigmoid(fb), dim=1)          # (B,L,H)
        run = torch.cummax(ib - b, dim=1).values           # cummax_j(i-b)
        m = b + torch.maximum(m_in[:, None, :], run)       # == scan m_t
        inter = torch.exp(b + m_in[:, None, :] - m)        # (B,L,H)
        logD = (b[:, :, None, :] - b[:, None, :, :] + ib[:, None, :, :]
                - m[:, :, None, :])                        # (B,j,l,H)
        logD = torch.where(tri[None, :, :, None], logD, _NEG)
        S_mat = torch.einsum("bjhd,blhd->bjlh", qb, kb) * torch.exp(logD)
        num = (inter[..., None] * torch.einsum("bjhd,bhdv->bjhv", qb, C_in)
               + torch.einsum("bjlh,blhv->bjhv", S_mat, vb))
        qn = (inter * torch.einsum("bjhd,bhd->bjh", qb, n_in)
              + S_mat.sum(dim=2))
        den = torch.maximum(qn.abs(), torch.exp(-m))
        hs.append(num / den[..., None])                    # (B,L,H,hd_v)
        b_tot = b[:, -1, :]                                # (B,H)
        m_out = b_tot + torch.maximum(m_in, run[:, -1, :])
        w_state = torch.exp(b_tot[:, None, :] - b + ib - m_out[:, None, :])
        carry = torch.exp(b_tot + m_in - m_out)
        C_in = (carry[..., None, None] * C_in
                + torch.einsum("blh,blhd,blhv->bhdv", w_state, kb, vb))
        n_in = (carry[..., None] * n_in
                + torch.einsum("blh,blhd->bhd", w_state, kb))
        m_in = m_out
    return torch.cat(hs, dim=1).reshape(B, S, H, hd_v), (C_in, n_in, m_in)


def _state(cache, names, zeros):
    """The recurrence's float32 state: the cache's, or ``zeros``."""
    if cache is None:
        return zeros
    return tuple(cache[k].float() for k in names)


def _write(cache, names, state):
    """The final state into the cache, but the leaves the scan wrote in
    place."""
    if cache is not None:
        for k, s in zip(names, state):
            if s is not cache[k]:
                cache[k].copy_(s)
    return cache


def _d_block(hs, layout):
    """hs (B, S, H, hd_v): each head's block on a ``layout`` -> (B, S, d
    / M), this rank's contiguous block of the flattened ``d`` (gathered
    over ``model`` and sliced: the backward reduce-scatters what every
    rank's slice needs); without one, (B, S, d)."""
    B, S = hs.shape[:2]
    if layout is None:
        return hs.reshape(B, S, -1)
    full = tp.gather(hs, layout.model, -1).reshape(B, S, -1)
    w = full.shape[-1] // layout.M
    return full[..., layout.m * w:(layout.m + 1) * w]


def mlstm_apply(p, x, cfg, cache=None, decode=False, layout=None):
    B, S, d = x.shape
    H, hd = _heads(cfg)
    hl = p["wv"].shape[-1]            # this rank's block of hd
    f32, dev = torch.float32, x.device

    def proj(w):
        return matmul(x, w.reshape(d, H * hl)).reshape(B, S, H, hl).float()
    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if layout is not None:
        q = tp.gather(q, layout.model, -1)
        k = tp.gather(k, layout.model, -1)
    i_pre = matmul(x, p["wi"]).float()
    f_pre = matmul(x, p["wf"]).float()
    state = _state(cache, ("C", "n", "m"), (
        torch.zeros((B, H, hd, hl), dtype=f32, device=dev),
        torch.zeros((B, H, hd), dtype=f32, device=dev),
        torch.full((B, H), _NEG, dtype=f32, device=dev)))
    if cache is not None and layout is not None:
        # the cache holds this rank's block of n's hd (its spec); the
        # recurrence keeps n whole, as it does q and k
        state = (state[0], tp.all_gather(state[1], layout.model, -1),
                 state[2])
    # the cache's leaves the scan writes in place (on a layout n is
    # whole in the recurrence and a block in the cache)
    dst = None if cache is None else (
        cache["C"], cache["n"] if layout is None else None, cache["m"])
    cw = getattr(cfg, "ssm_chunk", 0)
    if not decode and cw and S % cw == 0 and S > cw:
        hs, state = _mlstm_chunkwise(q, k, v, i_pre, f_pre, state, cw)
    else:           # decode: the same scan over one step
        hs, state = _mlstm_core(q, k, v, i_pre, f_pre, state, dst)
    hs = _d_block(hs, layout).to(x.dtype)
    out = matmul(hs * torch.sigmoid(matmul(x, p["wo"])), p["w_out"])
    if cache is not None and layout is not None:
        n = state[1]
        state = (state[0], n[..., layout.m * hl:(layout.m + 1) * hl],
                 state[2])
    return out, _write(cache, ("C", "n", "m"), state)


def slstm_defs(cfg):
    d = cfg.d_model
    H, hd = _heads(cfg)
    return {
        "w_gates": ParamDef((d, 4, H, hd), (None, None, None, "model")),
        "r_gates": ParamDef((H, 4, hd, hd), (None, None, None, "model"),
                            init_scale=0.3),
        "w_out": ParamDef((d, d), ("model", None)),
    }


def slstm_cache_defs(cfg, batch):
    H, hd = _heads(cfg)
    return {
        "c": ParamDef((batch, H, hd), ("data", None, "model")),
        "n": ParamDef((batch, H, hd), ("data", None, "model")),
        "h": ParamDef((batch, H, hd), ("data", None, "model")),
        "m": ParamDef((batch, H), ("data", None)),
    }


def _head_sums(p_r, gates_in, layout):
    """The sums over the whole hd that the head-level means of ``i_pre``
    and ``f_pre`` need, hoisted out of the time loop by linearity
    (``i_pre = g_in + h r``): of the input gates (B, S, 2, H) and of
    ``r_gates``' rows (H, 2, hd), each summed over ``model`` forward and
    its gradient backward (replicated, then used by split work)."""
    g = layout.model
    g_sum = tp.copy(tp.reduce(gates_in[:, :, 1:3].sum(dim=-1), g), g)
    r_sum = tp.copy(tp.reduce(p_r[:, 1:3].sum(dim=-1), g), g)
    return g_sum, r_sum


def _slstm_scan(p_r, state, gates_in, steps: int, layout=None, out=None):
    """The first ``steps`` positions of gates_in (B,S,4,H,hd) through
    ``ops.slstm_scan``.  Returns (hs (B,steps,H,hd), state).  On a
    ``layout`` every step gathers the whole ``h_{t-1}`` for ``r_gates``'
    block (p_r (H, 4, hd, hd_v)), so the scan runs one step at a time,
    its head-level means from ``_head_sums`` (no collective a step but
    the gather).  ``out``: the cache's leaves that take the final state
    in place."""
    if layout is None:
        return ops.slstm_scan(p_r, state, gates_in, steps, out=out)
    g_sum, r_sum = _head_sums(p_r, gates_in, layout)
    hs = []
    for t in range(steps):
        c, n, h, m = state
        h = tp.gather(h, layout.model, -1)                # the whole h
        # the means over the whole hd
        tot = g_sum[:, t] + torch.einsum("bhk,hgk->bgh", h, r_sum)
        h_t, state = ops.slstm_scan(
            p_r, (c, n, h, m), gates_in[:, t:t + 1], 1,
            sc=tot / p_r.shape[2], out=out if t == steps - 1 else None)
        hs.append(h_t)
    return torch.cat(hs, dim=1), state


def slstm_apply(p, x, cfg, cache=None, decode=False, layout=None):
    B, S, d = x.shape
    H, _ = _heads(cfg)
    hl = p["w_gates"].shape[-1]       # this rank's block of hd
    f32, dev = torch.float32, x.device
    gates_in = matmul(x, p["w_gates"].reshape(d, 4 * H * hl)).reshape(
        B, S, 4, H, hl).float()
    zeros = torch.zeros((B, H, hl), dtype=f32, device=dev)
    names = ("c", "n", "h", "m")
    state = _state(cache, names, (
        zeros, zeros, zeros, torch.full((B, H), _NEG, dtype=f32,
                                        device=dev)))
    steps = 1 if decode else S
    hs, state = _slstm_scan(
        p["r_gates"].float(), state, gates_in, steps, layout,
        None if cache is None else tuple(cache[k] for k in names))
    out = matmul(_d_block(hs, layout).to(x.dtype), p["w_out"])
    return out, _write(cache, names, state)
