"""Mamba2-style selective SSM block (zamba2 hybrid's recurrent core).

A port of the JAX package's ``repro.models.ssm``.  Structure per block:
{z, x, B, C, dt} projections, a causal depthwise conv on x, the selective
state-space recurrence (a scalar A per head, Mamba2) in float32 with
``exp(-dt A)`` decay and the ``D`` skip term, SiLU(z) gating, the output
projection.

The full-sequence form runs the recurrence through ``ops.ssm_scan`` (the
reference's ``lax.scan``: one kernel launch on the card, the plain loop
on the CPU and for a training step), always from a zero state and an
empty conv history whatever the cache holds; it leaves the last ``K - 1``
pre-activation inputs as the conv state.  Decode is the same scan over
one step from the cache's state.  Each form writes the cache in place,
when there is one, and returns it.

State cache: {"conv": (B, K-1, d_inner), "state": (B, H, hd, ds)}.

On a tensor-parallel mesh the block holds this rank's whole heads: the
leaves split on ``d_inner`` or on heads (``w_z``, ``w_x``, ``conv_w``,
``w_dt``, ``dt_bias``, ``A_log``, ``D``) give it ``d_inner / M`` channels,
``H / M`` heads of ``ssm_head_dim`` each, and ``w_out``'s row block a
partial sum; ``w_B`` and ``w_C`` are whole.  The widths are read from the
parameters, so the same code runs a block or the whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ParamDef, matmul


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads


def _local_dims(p):
    """(d_inner, heads) of the block ``p`` holds: the whole, or this
    rank's."""
    return p["w_x"].shape[1], p["A_log"].shape[0]


# whole leaves used inside the Mamba2 mixer's tensor-parallel region: each
# rank's gradient covers only its heads (summed over ``model`` by
# ``lm.reduce_grads``)
REGION_WHOLE = ("w_B", "w_C")


def mamba_defs(cfg):
    d = cfg.d_model
    d_inner, H = ssm_dims(cfg)
    ds, K = cfg.ssm_state, cfg.ssm_conv
    return {
        "w_z": ParamDef((d, d_inner), (None, "model")),
        "w_x": ParamDef((d, d_inner), (None, "model")),
        "w_B": ParamDef((d, ds), (None, None)),
        "w_C": ParamDef((d, ds), (None, None)),
        "w_dt": ParamDef((d, H), (None, "model")),
        "dt_bias": ParamDef((H,), ("model",), init_scale=0.0),
        "conv_w": ParamDef((K, d_inner), (None, "model")),
        "A_log": ParamDef((H,), ("model",), init_scale=1.0),
        "D": ParamDef((H,), ("model",), init_scale=1.0),
        "w_out": ParamDef((d_inner, d), ("model", None)),
    }


def mamba_cache_defs(cfg, batch):
    d_inner, H = ssm_dims(cfg)
    return {
        "conv": ParamDef((batch, cfg.ssm_conv - 1, d_inner),
                         ("data", None, "model")),
        "state": ParamDef((batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                          ("data", "model", None, None)),
    }


def _conv_causal(x, conv_w, conv_state=None):
    """Depthwise causal conv; x: (B, S, d_inner); conv_w: (K, d_inner)."""
    K = conv_w.shape[0]
    if conv_state is None:
        hist = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        hist = conv_state.to(x.dtype)
    xp = torch.cat([hist, x], dim=1)
    out = 0
    for i in range(K):            # the reference's sum(), in its order
        out = out + xp[:, i:i + x.shape[1]] * conv_w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else hist
    return F.silu(out), new_state


def _inputs(p, x, cfg, conv_state):
    z = matmul(x, p["w_z"])
    xin = matmul(x, p["w_x"])
    xc, conv_state = _conv_causal(xin, p["conv_w"], conv_state)
    Bm = matmul(x, p["w_B"])
    Cm = matmul(x, p["w_C"])
    dt = F.softplus(matmul(x, p["w_dt"]) + p["dt_bias"])
    A = torch.exp(p["A_log"].float())
    return z, xc, conv_state, Bm, Cm, dt, A


def _write(cache, conv_state):
    """The conv state into the cache (the scan writes its state there
    itself)."""
    if cache is not None:
        cache["conv"].copy_(conv_state)
    return cache


def mamba_full(p, x, cfg, cache=None):
    """x: (B, S, d).  Returns (y, cache)."""
    B, S, d = x.shape
    d_inner, H = _local_dims(p)
    hd, ds = cfg.ssm_head_dim, cfg.ssm_state
    # full-sequence mode always starts from an empty history (train / fresh
    # prefill); the conv state it leaves serves the decode steps after it
    z, xc, conv_state, Bm, Cm, dt, A = _inputs(p, x, cfg, None)
    xh = xc.reshape(B, S, H, hd)
    state0 = torch.zeros((B, H, hd, ds), dtype=torch.float32,
                         device=x.device)
    y, _ = ops.ssm_scan(xh.float(), Bm.float(), Cm.float(), dt.float(), A,
                        p["D"].float(), state0,
                        out=None if cache is None else cache["state"])
    y = y.reshape(B, S, d_inner).to(x.dtype) * F.silu(z)
    return matmul(y, p["w_out"]), _write(cache, conv_state)


def mamba_decode(p, x, cfg, cache):
    """x: (B, 1, d); cache: {"conv", "state"}.  O(1) per token."""
    B, _, d = x.shape
    d_inner, H = _local_dims(p)
    hd = cfg.ssm_head_dim
    z, xc, conv_state, Bm, Cm, dt, A = _inputs(p, x, cfg, cache["conv"])
    xh = xc.reshape(B, 1, H, hd).float()
    y, _ = ops.ssm_scan(xh, Bm.float(), Cm.float(), dt.float(), A,
                        p["D"].float(), cache["state"].float(),
                        out=cache["state"])
    y = y.reshape(B, 1, d_inner).to(x.dtype) * F.silu(z)
    return matmul(y, p["w_out"]), _write(cache, conv_state)
