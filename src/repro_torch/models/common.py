"""Shared model machinery of the LM template: parameter definitions, norms,
rotary embeddings and chunked online-softmax attention with its
flash-style backward.

A port of the JAX package's ``repro.models.common``, function for function
and in its layouts and dtypes.  Every parameter is a ``ParamDef(shape,
spec)``: ``spec`` keeps the reference's PartitionSpec as a plain tuple of
axis names (a mesh's placement reads it); ``init_params`` draws random
tensors from an explicit ``torch.Generator`` on its device (a rank of a
mesh keeps its block of each leaf as it is drawn); ``abstract_params``
makes meta tensors carrying their specs for the dry-run, and
``shard_shape`` gives one card's block of a spec.  JAX's PRNG
cannot be reproduced here, so tests carry the JAX package's weights across
as numpy arrays (``repro_torch.convert.lm_params_from_numpy``).

Matrix products promote their operands as JAX does (bf16 with f32 gives
f32; ``torch.matmul`` refuses mixed dtypes), and each function ends in the
dtype JAX gives.

``chunked_attention(impl="flash")`` is a ``torch.autograd.Function``
(``FlashAttention``), the reference's ``custom_vjp``: its forward saves
only the raw q, k and v, and its backward recomputes the output and the
log-sum-exp, then runs over the KV chunks (``_flash_bwd``), so what a
layer keeps for the backward is O(S), remat or not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    spec: tuple = ()             # axis name (or None) a dim, as in the mesh
    dtype: Any = torch.float32
    init_scale: float = 1.0      # stddev multiplier over 1/sqrt(fan_in)


def tree_defs_map(fn, defs):
    """``fn`` over every ParamDef of a nested dict, keeping its keys."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: tree_defs_map(fn, v) for k, v in defs.items()}


def flatten(tree, prefix: str = "") -> dict:
    """{"a.b.c": leaf} of a nested dict, in sorted key order (the order
    of ``jax.tree.leaves``)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "."))
        else:
            out[name] = v
    return out


def unflatten(flat: dict) -> dict:
    """The nested dict of ``flatten``'s {"a.b.c": leaf}."""
    out: dict = {}
    for name, v in flat.items():
        *path, last = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def init_params(defs, generator: torch.Generator, dtype=None, keep=None):
    """Random tensors for ``defs`` from ``generator``, on its device:
    normal with std ``init_scale / sqrt(fan_in)``, ``fan_in`` the
    second-to-last dim (the last one of a vector); zeros where
    ``init_scale`` is 0.  ``keep(d, t)``, when given, returns what is kept
    of each leaf as it is drawn (a rank's block of it: every rank draws
    the same full leaves in turn and holds one full leaf at a time)."""
    dev = generator.device

    def mk(d: ParamDef):
        dt = dtype or d.dtype
        if d.init_scale == 0.0:
            t = torch.zeros(d.shape, dtype=dt, device=dev)
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 \
                else max(d.shape[-1], 1)
            std = d.init_scale / math.sqrt(max(fan_in, 1))
            t = torch.randn(d.shape, generator=generator,
                            dtype=torch.float32, device=dev).mul_(std)
            t = t if dt == torch.float32 else t.to(dt)
        return t if keep is None else keep(d, t)

    return tree_defs_map(mk, defs)


def spec_axes(spec, i: int) -> tuple:
    """The mesh axes that split dim ``i`` under ``spec`` (an axis name, a
    tuple of them, or None a dim; a spec shorter than the shape leaves
    the rest whole)."""
    axes = spec[i] if i < len(spec) else None
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def shard_shape(shape, spec, mesh) -> tuple:
    """One card's block of a ``shape`` tensor laid out by ``spec`` on
    ``mesh`` (anything with a ``shape`` {axis: size}):
    ``NamedSharding(mesh, P(*spec)).shard_shape(shape)``; a dim its axes
    do not divide raises ``ValueError``, as that does."""
    out = []
    for i, n in enumerate(shape):
        ext = math.prod(mesh.shape[a] for a in spec_axes(spec, i))
        if n % ext:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {spec_axes(spec, i)} ({ext} cards)")
        out.append(n // ext)
    return tuple(out)


def abstract_params(defs, mesh, dtype=None):
    """``defs`` as meta-device tensors (nothing allocated), each carrying
    its ``ParamDef.spec`` as ``.spec``: the dry-run's stand-ins, the
    reference's ``ShapeDtypeStruct``s with their shardings.  ``mesh`` is
    checked: a spec its axes do not divide raises ``ValueError``."""
    def mk(d: ParamDef):
        shard_shape(d.shape, d.spec, mesh)
        t = torch.empty(d.shape, dtype=dtype or d.dtype, device="meta")
        t.spec = tuple(d.spec)
        return t
    return tree_defs_map(mk, defs)


def param_count(defs) -> int:
    return int(sum(math.prod(d.shape) for d in flatten(defs).values()))


class ParamTree(nn.Module):
    """Parameters (and sub-trees) under the reference's names, read as
    ``p["wq"]`` like the reference's dicts; the tensors are adopted as
    they are (no copy), frozen until ``lm.make_train_step``."""

    def __init__(self, tensors: dict):
        super().__init__()
        for k, v in tensors.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)


def promoted(*ts):
    """The tensors in their common dtype, as JAX promotes a product's
    operands."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def matmul(a, b):
    """``a @ b`` with JAX's dtype promotion."""
    a, b = promoted(a, b)
    return a @ b


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) \
        * (1.0 + scale.to(x.dtype))


def swiglu(x, w_gate, w_up, w_down):
    return matmul(F.silu(matmul(x, w_gate)) * matmul(x, w_up), w_down)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x, positions, theta=10000.0):
    """x: (..., S, H, hd); positions: (..., S) integers.  Rotates the two
    halves of hd (not interleaved pairs), angles in float32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., :, None].float() * freqs    # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# chunked online-softmax attention (flash-style forward and backward)
# ---------------------------------------------------------------------------

_BIG_WINDOW = 2**30
_F32_MIN = torch.finfo(torch.float32).min


def _mask_bias_arr(q_pos, k_pos, *, causal, window):
    """(Sq, Sk) additive float32 bias: 0 where a query sees a key, the
    float32 minimum (not -inf) where it does not."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    ok &= k_pos[None, :] > q_pos[:, None] - window
    return torch.where(ok, 0.0, _F32_MIN)


def _repeat_kv(k, rep: int):
    """GQA: each kv head serves ``rep`` consecutive query heads
    (``jnp.repeat(axis=2)``)."""
    return k.repeat_interleave(rep, dim=2) if rep > 1 else k


def _flash_inputs(q_raw, k_raw, v_raw, scale, chunk):
    """float32 q (scaled), k and v (GQA heads repeated, keys padded with
    zeros to a whole number of chunks), the key count and the chunk
    count."""
    rep = q_raw.shape[2] // k_raw.shape[2]
    q = (q_raw * scale).float()
    k = _repeat_kv(k_raw.float(), rep)
    v = _repeat_kv(v_raw.float(), rep)
    Sk = k.shape[1]
    n_chunks = max(1, -(-Sk // chunk))
    pad = n_chunks * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return q, k, v, Sk, n_chunks


def _chunk_bias(q_pos, c, chunk, Sk, *, causal, window):
    """The (Sq, chunk) bias of KV chunk ``c``: the mask, and the padded
    keys past ``Sk`` masked."""
    k_pos = c * chunk + torch.arange(chunk, device=q_pos.device)
    bias = _mask_bias_arr(q_pos, k_pos, causal=causal, window=window)
    return torch.where((k_pos < Sk)[None, :], bias, _F32_MIN)


def _flash_fwd(causal, q_offset, chunk, softcap, scale, q_raw, k_raw, v_raw,
               window):
    """Online-softmax forward over KV chunks of ``chunk`` keys; the last
    chunk is padded with zero keys masked by ``k_pos < Sk``.  Returns the
    float32 output (B, H, Sq, hd_v) and the log-sum-exp (B, H, Sq)."""
    q, k, v, Sk, n_chunks = _flash_inputs(q_raw, k_raw, v_raw, scale, chunk)
    B, Sq, H, _ = q.shape
    hd_v = v.shape[-1]
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, hd_v), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        kb = k[:, c * chunk:(c + 1) * chunk]
        vb = v[:, c * chunk:(c + 1) * chunk]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, kb)
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        bias = _chunk_bias(q_pos, c, chunk, Sk, causal=causal, window=window)
        logits = logits + bias[None, None, :, :]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    return acc / l_safe[..., None], m + torch.log(l_safe)


def _flash_bwd(causal, q_offset, chunk, softcap, scale, q_raw, k_raw, v_raw,
               window, dout, out, lse):
    """The flash backward from the forward's float32 ``out`` (B, H, Sq,
    hd_v) and ``lse`` (B, H, Sq): per KV chunk the probabilities from the
    recomputed logits, dv, dp, ds (times the softcap's 1 - t^2), dq summed
    over the chunks, dk and dv a chunk.  Returns (dq, dk, dv) in the raw
    inputs' dtypes, dk and dv summed back over each GQA group."""
    q, k, v, Sk, n_chunks = _flash_inputs(q_raw, k_raw, v_raw, scale, chunk)
    B, Sq, H, hd = q.shape
    hd_v = v.shape[-1]
    Hkv = k_raw.shape[2]
    rep = H // Hkv
    dout = dout.float()
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    delta = (dout * out).sum(dim=-1)                    # (B, H, Sq)
    dq = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for c in range(n_chunks):
        kb = k[:, c * chunk:(c + 1) * chunk]
        vb = v[:, c * chunk:(c + 1) * chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", q, kb)
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        bias = _chunk_bias(q_pos, c, chunk, Sk, causal=causal, window=window)
        p = torch.exp(s + bias[None, None] - lse[..., None])
        dvs.append(torch.einsum("bhqk,bhqd->bkhd", p, dout))
        dp = torch.einsum("bhqd,bkhd->bhqk", dout, vb)
        ds = p * (dp - delta[..., None])
        if softcap is not None:
            ds = ds * (1.0 - t * t)
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kb)
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, q))
    dk = torch.cat(dks, dim=1)[:, :Sk]
    dv = torch.cat(dvs, dim=1)[:, :Sk]
    if rep > 1:
        dk = dk.reshape(B, Sk, Hkv, rep, hd).sum(dim=3)
        dv = dv.reshape(B, Sk, Hkv, rep, hd_v).sum(dim=3)
    return ((dq * scale).to(q_raw.dtype), dk.to(k_raw.dtype),
            dv.to(v_raw.dtype))


class FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_attn`` (a ``custom_vjp``): the output (B,
    H, Sq, hd_v) in v's dtype; only the raw q, k, v are saved, and the
    backward recomputes the output and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q_raw, k_raw, v_raw, causal, q_offset, chunk, softcap,
                scale, window):
        out, _ = _flash_fwd(causal, q_offset, chunk, softcap, scale, q_raw,
                            k_raw, v_raw, window)
        ctx.save_for_backward(q_raw, k_raw, v_raw)
        ctx.static = (causal, q_offset, chunk, softcap, scale, window)
        return out.to(v_raw.dtype)

    @staticmethod
    def backward(ctx, dout):
        q_raw, k_raw, v_raw = ctx.saved_tensors
        causal, q_offset, chunk, softcap, scale, window = ctx.static
        out, lse = _flash_fwd(causal, q_offset, chunk, softcap, scale,
                              q_raw, k_raw, v_raw, window)
        dq, dk, dv = _flash_bwd(causal, q_offset, chunk, softcap, scale,
                                q_raw, k_raw, v_raw, window, dout, out, lse)
        return dq, dk, dv, None, None, None, None, None, None


def naive_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    softcap=None, scale=None):
    """Materialized-logits attention: (B, Sq, H, hd) from q (B, Sq, H, hd)
    and k, v (B, Sk, Hkv, hd)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf, vf = _repeat_kv(k, rep), _repeat_kv(v, rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", *promoted(q * scale, kf))
    logits = logits.float()
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    win = _BIG_WINDOW if window is None else window
    bias = _mask_bias_arr(q_pos, k_pos, causal=causal, window=win)
    p = torch.softmax(logits + bias[None, None], dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(vf.dtype), vf)
    return out.to(v.dtype)


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      chunk=1024, softcap=None, scale=None, impl="flash"):
    """Memory-O(S) attention by an online softmax over KV chunks, with the
    flash backward (``FlashAttention``); ``impl="naive"`` materializes the
    logits instead (plain autograd).

    q: (B, Sq, H, hd);  k, v: (B, Sk, Hkv, hd[_v]) with H % Hkv == 0.
    ``window`` may be None or an int (a per-layer value of a local:global
    stack).  ``q_offset``: absolute position of q[0].
    """
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, softcap=softcap,
                               scale=scale)
    hd = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    win = _BIG_WINDOW if window is None else window
    out = FlashAttention.apply(q, k, v, causal, q_offset, chunk, softcap,
                               scale, win)
    return out.transpose(1, 2)                  # (B, Sq, H, hd_v)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None,
                     softcap=None, scale=None, offset=0, group=None):
    """Single-token decode: q (B, 1, H, hd) against a cache (B, S_max, Hkv,
    hd).  ``cache_len``: the number of valid cache entries, a host int or
    an integer tensor () or (B,).

    With a ``group`` the cache is this rank's block of a sequence split
    over it, from position ``offset``: the rank masks its block by the
    absolute positions (the window too), and the blocks' partial softmax
    statistics are merged over the group (the max by an all-reduce of
    max, then the sums of exp and of the exp-weighted values in one
    all-reduce of sum): every rank gets the attention over the whole
    cache."""
    B, _, H, hd = q.shape
    S_max, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = (q[:, 0] * scale).float()                        # (B, H, hd)
    kf = _repeat_kv(k_cache.float(), rep)
    vf = _repeat_kv(v_cache.float(), rep)
    logits = torch.einsum("bhd,bshd->bhs", qf, kf)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = offset + torch.arange(S_max, device=q.device)
    n = cache_len.reshape(-1, 1) if torch.is_tensor(cache_len) else cache_len
    valid = pos[None, :] < n
    if window is not None:
        valid &= pos[None, :] > n - 1 - window
    logits = torch.where(valid[:, None, :], logits, _F32_MIN)
    if group is None:
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhs,bshd->bhd", p, vf)
    else:
        from repro_torch.sharding import tensor_parallel as tp
        mx = tp.all_reduce(logits.amax(dim=-1), group, "max")
        e = torch.exp(logits - mx[..., None])              # 0 where masked
        part = torch.cat([torch.einsum("bhs,bshd->bhd", e, vf),
                          e.sum(dim=-1)[..., None]], dim=-1)
        part = tp.all_reduce(part, group)
        out = part[..., :-1] / part[..., -1:]
    return out[:, None].to(v_cache.dtype)                 # (B, 1, H, hd)

