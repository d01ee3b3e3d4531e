"""Attention blocks: GQA with RoPE, a sliding window, a softcap and QKV
bias; DeepSeek-V2's MLA with its compressed-latent cache; and
cross-attention (the VLM's image layers, whisper's decoder).  Full
sequences (train / prefill) and single-token decode.

A port of the JAX package's ``repro.models.attention``.  The decode cache
is updated in place: the full forms with a cache write their keys and
values (MLA: the latent and the rotated key channel) over its first S
positions and zero the rest (the reference pads them into a new cache),
the decode forms write position ``cache_len``; each returns the same
cache.

On a mesh each rank holds its block of every cache as its spec lays it
out (``models.lm.init_cache``): GQA's on its KV heads over ``model``
(the rank's heads are those of its ``wk``/``wv`` blocks, so the code is
the same), MLA's latent and rotated key channel whole over ``model``
(each rank computes them from the whole ``w_dkv``).  Where a decode's
batch is below the data extent the KV caches' sequence is split over
``data`` instead of the batch (``seq``, the rank's ``Layout``): the full
forms write the rank's block of the prompt's positions, a decode step
writes its new position only on the rank whose block holds it, and each
rank attends over its block of positions, merged over ``data``
(``common.decode_attention``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import (ParamDef, chunked_attention,
                                       decode_attention, matmul, rms_norm,
                                       rope)


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
             positions=None, seq=None):
    """Train / prefill.  x: (B, S, d).  Returns (out, cache); ``seq``:
    the cache's sequence split over ``data`` (module docstring)."""
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
        _write_prefix(cache, {"k": k, "v": v}, seq)
    return y, cache


def gqa_decode(p, x, cfg, cache, cache_len: int, *, window=None,
               theta=None, seq=None):
    """x: (B, 1, d); ``cache_len``: the valid length so far, a host int
    (the decode loop knows it: no read of the card).  Returns (out,
    cache); ``seq``: the cache's sequence split over ``data``."""
    q, k, v = _qkv(p, x, cfg)
    pos = torch.full((x.shape[0], 1), cache_len, device=x.device)
    th = theta if theta is not None else cfg.rope_theta
    q = rope(q, pos, th)
    k = rope(k, pos, th)
    _write_position(cache, {"k": k, "v": v}, cache_len, seq)
    out = decode_attention(q, cache["k"], cache["v"], cache_len + 1,
                           window=window, softcap=cfg.attn_softcap,
                           **_seq_block(cache["k"], seq))
    return _out(out, p["wo"]), cache


def _seq_block(leaf, seq) -> dict:
    """``decode_attention``'s ``offset`` and ``group`` of a cache ``leaf``
    (B, S_block, ...) whose sequence is split over ``data`` on ``seq`` (a
    ``Layout``): the first position of this rank's block and the group
    that merges the blocks; nothing without a split."""
    if seq is None:
        return {}
    return {"offset": seq.d * leaf.shape[1], "group": seq.data}


def _write_position(cache: dict, new: dict, cache_len: int, seq) -> None:
    """Each ``new[name]`` (B, 1, ...) at position ``cache_len`` of
    ``cache[name]``, in place: on a sequence split (``seq``) only the rank
    whose block holds that position writes."""
    for name, t in new.items():
        blk = cache[name].shape[1]
        if seq is None:
            cache[name][:, cache_len] = t[:, 0]
            continue
        if not 0 <= cache_len < blk * seq.D:
            raise IndexError(f"position {cache_len} is outside a cache of "
                             f"{blk * seq.D}")
        i = cache_len - _seq_block(cache[name], seq)["offset"]
        if 0 <= i < blk:
            cache[name][:, i] = t[:, 0]


def _write_prefix(cache: dict, new: dict, seq=None) -> dict:
    """Each ``new[name]`` (B, S, ...) over the first S positions of
    ``cache[name]``, zeros after them (in place); on a sequence split
    (``seq``) the positions of this rank's block of them."""
    for name, t in new.items():
        blk = cache[name].shape[1]
        s_max = blk * (seq.D if seq is not None else 1)
        if t.shape[1] > s_max:
            raise ValueError(f"{t.shape[1]} positions do not fit a cache of "
                             f"{s_max}")
        off = _seq_block(cache[name], seq).get("offset", 0)
        part = t[:, off:off + blk]
        cache[name][:, :part.shape[1]] = part
        cache[name][:, part.shape[1]:] = 0
    return cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV latent; the cache stores the
# latent and the rotated key channel, re-expanded to per-head K/V at every
# decode step as the reference does.
# ---------------------------------------------------------------------------

# whole leaves of MLA used inside its tensor-parallel region: the latent
# and the shared key channel are computed whole on every rank, so each
# rank's gradient of these covers only its heads (summed over ``model``
# by ``lm.reduce_grads``)
MLA_REGION_WHOLE = ("w_dkv", "kv_norm")


def mla_defs(cfg):
    d, H = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    return {
        "wq": ParamDef((d, H, dn + dr), (None, "model", None)),
        "w_dkv": ParamDef((d, r + dr), (None, None)),
        "kv_norm": ParamDef((r,), (None,), init_scale=0.0),
        "w_uk": ParamDef((r, H, dn), (None, "model", None)),
        "w_uv": ParamDef((r, H, dv), (None, "model", None)),
        "wo": ParamDef((H, dv, d), ("model", None, None)),
    }


def mla_cache_defs(cfg, batch, s_max):
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    return {"ckv": ParamDef((batch, s_max, r), ("data", None, None)),
            "kpe": ParamDef((batch, s_max, dr), ("data", None, None))}


def _mla_qkv(p, x, cfg, positions):
    dn, r = cfg.qk_nope_dim, cfg.kv_lora_rank
    q = _proj(x, p["wq"])
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = rope(q_pe, positions, cfg.rope_theta)
    dkv = matmul(x, p["w_dkv"])                   # (B, S, r + dr)
    ckv, kpe = dkv[..., :r], dkv[..., r:]
    ckv = rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    # the shared rope channel, rotated with a singleton head axis
    kpe = rope(kpe[..., None, :], positions, cfg.rope_theta)[..., 0, :]
    return q_nope, q_pe, ckv, kpe


def _mla_attend(p, q_nope, q_pe, ckv, kpe, cfg):
    """The latent expanded to per-head K/V, the rope channel appended to
    every head (decoupled RoPE); the scale is 1/sqrt(dn + dr)."""
    k_nope = _proj(ckv, p["w_uk"])
    v = _proj(ckv, p["w_uv"])
    H = k_nope.shape[2]
    kpe_h = kpe[:, :, None, :].expand(*kpe.shape[:2], H, kpe.shape[-1])
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    k_full = torch.cat([k_nope, kpe_h.to(k_nope.dtype)], dim=-1)
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    return q_full, k_full, v, scale


def mla_full(p, x, cfg, *, cache=None, positions=None, seq=None, **_):
    """Train / prefill (any window is ignored, as the reference does)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_pe, ckv, kpe = _mla_qkv(p, x, cfg, positions)
    q_full, k_full, v, scale = _mla_attend(p, q_nope, q_pe, ckv, kpe, cfg)
    out = chunked_attention(q_full, k_full, v, causal=True,
                            chunk=cfg.attn_chunk, scale=scale,
                            impl=getattr(cfg, "attn_impl", "flash"))
    y = _out(out, p["wo"])
    if cache is not None:
        _write_prefix(cache, {"ckv": ckv, "kpe": kpe}, seq)
    return y, cache


def mla_decode(p, x, cfg, cache, cache_len: int, seq=None, **_):
    """x: (B, 1, d); ``cache_len`` a host int.  Writes the latent at
    ``cache_len``, then re-expands the whole cache (on a sequence split,
    this rank's block of it)."""
    pos = torch.full((x.shape[0], 1), cache_len, device=x.device)
    q_nope, q_pe, ckv, kpe = _mla_qkv(p, x, cfg, pos)
    _write_position(cache, {"ckv": ckv, "kpe": kpe}, cache_len, seq)
    q_full, k_full, v, scale = _mla_attend(
        p, q_nope, q_pe, cache["ckv"].to(x.dtype), cache["kpe"].to(x.dtype),
        cfg)
    out = decode_attention(q_full, k_full, v, cache_len + 1, scale=scale,
                           **_seq_block(cache["ckv"], seq))
    return _out(out, p["wo"]), cache


# ---------------------------------------------------------------------------
# cross-attention (VLM image layers, whisper decoder)
# ---------------------------------------------------------------------------

def cross_defs(cfg, kv_dim=None):
    d, H, Hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    kd = kv_dim or d
    return {
        "wq": ParamDef((d, H, hd), (None, "model", None)),
        "wk": ParamDef((kd, Hkv, hd), (None, "model", None)),
        "wv": ParamDef((kd, Hkv, hd), (None, "model", None)),
        "wo": ParamDef((H, hd, d), ("model", None, None)),
    }


def cross_apply(p, x, kv_src, cfg):
    """kv_src: (B, S_kv, kd) encoder or image states.  No mask, no rope,
    no cache."""
    q = _proj(x, p["wq"])
    k = _proj(kv_src, p["wk"])
    v = _proj(kv_src, p["wv"])
    out = chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk,
                            impl=getattr(cfg, "attn_impl", "flash"))
    return _out(out, p["wo"])
