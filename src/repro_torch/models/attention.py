"""Attention blocks: GQA with RoPE, a sliding window, a softcap and QKV
bias, for full sequences (train / prefill) and single-token decode.

A port of the GQA part of the JAX package's ``repro.models.attention``.
Its MLA (DeepSeek-V2) and cross-attention blocks wait for the families
that use them (ROADMAP Queue 1 item 6).  The decode cache is updated in
place: ``gqa_full`` with a cache writes k and v over its first S
positions and zeros the rest (the reference pads them into a new cache),
``gqa_decode`` writes position ``cache_len``; both return the same cache.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import (ParamDef, chunked_attention,
                                       decode_attention, matmul, rope)


def gqa_defs(cfg):
    d, H, Hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    defs = {
        "wq": ParamDef((d, H, hd), (None, "model", None)),
        "wk": ParamDef((d, Hkv, hd), (None, "model", None)),
        "wv": ParamDef((d, Hkv, hd), (None, "model", None)),
        "wo": ParamDef((H, hd, d), ("model", None, None)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, hd), ("model", None), init_scale=0.0)
        defs["bk"] = ParamDef((Hkv, hd), ("model", None), init_scale=0.0)
        defs["bv"] = ParamDef((Hkv, hd), ("model", None), init_scale=0.0)
    return defs


def gqa_cache_defs(cfg, batch, s_max):
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": ParamDef((batch, s_max, Hkv, hd), ("data", None, "model", None)),
        "v": ParamDef((batch, s_max, Hkv, hd), ("data", None, "model", None)),
    }


def _proj(x, w):
    """einsum("bsd,dhk->bshk", x, w) as one matrix product."""
    d, h, k = w.shape
    return matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _out(o, wo):
    """einsum("bshk,hkd->bsd", o, wo) as one matrix product."""
    h, k, d = wo.shape
    return matmul(o.reshape(*o.shape[:-2], h * k), wo.reshape(h * k, d))


def _qkv(p, x, cfg):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def gqa_full(p, x, cfg, *, window=None, theta=None, cache=None,
             positions=None):
    """Train / prefill.  x: (B, S, d).  Returns (out, cache)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    th = theta if theta is not None else cfg.rope_theta
    q = rope(q, positions, th)
    k = rope(k, positions, th)
    out = chunked_attention(q, k, v, causal=True, window=window,
                            chunk=cfg.attn_chunk, softcap=cfg.attn_softcap,
                            impl=getattr(cfg, "attn_impl", "flash"))
    y = _out(out, p["wo"])
    if cache is not None:
        s_max = cache["k"].shape[1]
        if S > s_max:
            raise ValueError(f"{S} positions do not fit a cache of {s_max}")
        for name, t in (("k", k), ("v", v)):
            cache[name][:, :S] = t
            cache[name][:, S:] = 0
    return y, cache


def gqa_decode(p, x, cfg, cache, cache_len: int, *, window=None,
               theta=None):
    """x: (B, 1, d); ``cache_len``: the valid length so far, a host int
    (the decode loop knows it: no read of the card).  Returns (out,
    cache)."""
    q, k, v = _qkv(p, x, cfg)
    pos = torch.full((x.shape[0], 1), cache_len, device=x.device)
    th = theta if theta is not None else cfg.rope_theta
    q = rope(q, pos, th)
    k = rope(k, pos, th)
    for name, t in (("k", k), ("v", v)):
        cache[name][:, cache_len] = t[:, 0]
    out = decode_attention(q, cache["k"], cache["v"], cache_len + 1,
                           window=window, softcap=cfg.attn_softcap)
    return _out(out, p["wo"]), cache
