"""Decoder-only model assembly for the dense, moe, hybrid, ssm and vlm
families.

A port of the JAX package's ``repro.models.transformer``.  ``DecoderModel``
is an ``nn.Module`` whose parameters keep the reference's layouts
(``wq (d, H, hd)``, ``wo (H, hd, d)``, ``w_gate (d, f)``, ``embed (V,
d)``); where the reference scans over stacked ``(L, ...)`` leaves, the
port holds one ``nn.ModuleList`` entry a layer (``STACKED`` names those
subtrees).  ``param_defs`` and ``cache_defs`` return the reference's
stacked trees, so counts and shapes compare leaf for leaf; the caches stay
stacked, and each layer reads and writes its own slice of them in place.

Heterogeneous stacks run in the reference's order: deepseek's leading
dense layers before its MoE layers (MLA only in the MoE layers); zamba's
one shared attention block, the same weights at every application with a
KV cache each, before every segment of ``shared_attn_every`` Mamba
layers; xlstm's groups of ``slstm_period - 1`` mLSTM layers and one
sLSTM layer; llama-vision's cross-attention block before every segment of
``cross_attn_period`` self layers, only when ``image_embeds`` is given.

On a (data, model) mesh (``layout``, a ``sharding.tensor_parallel.Layout``)
the model holds this rank's block of each parameter, as its ``ParamDef``
spec lays it out.  A ``model`` axis of 1 is data parallelism alone, and
the model is the single-card one.  Past 1, every family runs Megatron's
tensor parallelism, what GSPMD makes of the reference's specs: the
embedding and the head split on the vocab (a masked lookup, summed over
``model``), attention split on heads (``wq``/``wk``/``wv`` and their
biases by column, ``wo`` by row; MLA's latent ``w_dkv`` and ``kv_norm``
whole, its ``w_uk``/``w_uv`` on heads), the MLP by column then by row,
the MoE on experts (E >= 16: each rank runs its E/M experts) or inside
each expert (``f``), Mamba2 on whole heads of ``d_inner``, xLSTM on the
head dim (``models.xlstm``), the vlm's ``img_proj`` by column (its output
gathered for the cross attention's whole ``kd``), the norms whole.  The
reference's activation constraint ``_shard_h`` becomes the boundary of
sequence parallelism (``Layout.seq_parallel``): where it shards the
sequence over ``model`` the residual stream between blocks is this rank's
block of the sequence, gathered on entering a block (the recurrent
mixers' scans run along the whole sequence) and reduce-scattered on
leaving it; elsewhere the stream is whole on every rank and each block's
output is all-reduced (``tensor_parallel.enter`` and ``leave``).  GQA
keeps its head map only where ``model`` divides the KV heads
(``check_layout`` holds every family to the reference's divisibility).

Serving (prefill and decode) runs on the same layouts: each rank holds
its block of every cache as the cache's spec lays it out
(``models.lm.init_cache``; each leaf carries its spec as ``.spec``, which
the forward reads, as GSPMD reads an input's sharding).  A prefill is
sequence-parallel where training would be, and writes each head block's
whole sequence into the cache; a decode step (S = 1) never is.  The
logits' vocab blocks are gathered over ``model`` (``unembed``), so each
rank gets the full logits of its rows.  Where the caches' batch is split
over ``data`` a rank serves its rows (the MoE gathers a decode's rows
over ``data`` where they are not whole token groups,
``moe.moe_apply``); where the KV caches' sequence is split over ``data``
instead (a batch below the data extent, the reference's
``_reshard_cache_seq``) every rank serves every row and attends over its
block of positions (``models.attention``).

Remat, as the reference's ``jax.checkpoint`` around each layer body: in
train mode with ``cfg.remat`` and gradients on, each layer (attention and
MoE, Mamba, mLSTM and sLSTM layers; whisper's encoder and decoder layers)
runs under ``torch.utils.checkpoint`` (non-reentrant), which keeps only
its input for the backward and runs it again there; an attention stack
with ``cfg.remat_group = G > 1`` dividing its layer count keeps the
residual stream every G layers instead.  The forward draws no random
numbers, so the recomputation is exact and the RNG state is not
preserved.  The parameters are frozen (``requires_grad=False``) as built:
serving stays gradient-free, and ``lm.make_train_step`` turns them on.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, mlp, moe, ssm, xlstm
from repro_torch.models.common import (ParamDef, ParamTree, flatten,
                                       matmul, rms_norm, shard_shape,
                                       spec_axes, unflatten)
from repro_torch.sharding import tensor_parallel as tp

# the subtrees the reference stacks over layers (a leading (L, ...) dim)
STACKED = ("layers", "dense_layers", "cross", "slstm", "enc_layers",
           "dec_layers")


def segment_bounds(n_layers: int, every: int):
    """[(lo, hi)] covering all layers in chunks of ``every`` (last
    ragged)."""
    return [(lo, min(lo + every, n_layers))
            for lo in range(0, n_layers, every)]


def stack_defs(defs, n: int):
    def bump(d: ParamDef):
        return ParamDef((n,) + d.shape, (None, *d.spec), d.dtype,
                        d.init_scale)
    return {k: bump(v) if isinstance(v, ParamDef) else stack_defs(v, n)
            for k, v in defs.items()}


def _norm_def(cfg):
    return ParamDef((cfg.d_model,), (None,), init_scale=0.0)


# ---------------------------------------------------------------------------
# per-family layer definitions
# ---------------------------------------------------------------------------

def dense_layer_defs(cfg):
    return {"ln1": _norm_def(cfg), "attn": attention.gqa_defs(cfg),
            "ln2": _norm_def(cfg), "ffn": mlp.swiglu_defs(cfg)}


def moe_layer_defs(cfg):
    return {"ln1": _norm_def(cfg),
            "attn": (attention.mla_defs(cfg) if cfg.kv_lora_rank
                     else attention.gqa_defs(cfg)),
            "ln2": _norm_def(cfg), "ffn": moe.moe_defs(cfg)}


def mamba_layer_defs(cfg):
    return {"ln": _norm_def(cfg), "mixer": ssm.mamba_defs(cfg)}


def mlstm_layer_defs(cfg):
    return {"ln": _norm_def(cfg), "mixer": xlstm.mlstm_defs(cfg)}


def slstm_layer_defs(cfg):
    return {"ln": _norm_def(cfg), "mixer": xlstm.slstm_defs(cfg)}


def attn_block_defs(cfg):
    """Standalone attention(+MLP) block (zamba's shared block)."""
    return {"ln1": _norm_def(cfg), "attn": attention.gqa_defs(cfg),
            "ln2": _norm_def(cfg), "ffn": mlp.swiglu_defs(cfg)}


def cross_block_defs(cfg):
    return {"ln1": _norm_def(cfg), "attn": attention.cross_defs(cfg),
            "ln2": _norm_def(cfg), "ffn": mlp.swiglu_defs(cfg)}


def param_defs(cfg):
    """The reference's parameter tree (stacked layers) of the decoder of
    ``cfg``; an unknown family (or "audio", ``whisper.param_defs``)
    raises ``ValueError``."""
    d = {"embed": ParamDef((cfg.vocab_size, cfg.d_model), ("model", None)),
         "final_norm": _norm_def(cfg)}
    if not cfg.tie_embeddings:
        d["head"] = ParamDef((cfg.d_model, cfg.vocab_size), (None, "model"))
    fam = cfg.family
    if fam in ("dense", "vlm"):
        d["layers"] = stack_defs(dense_layer_defs(cfg), cfg.n_layers)
        if fam == "vlm":
            n_cross = cfg.n_layers // cfg.cross_attn_period
            d["cross"] = stack_defs(cross_block_defs(cfg), n_cross)
            d["img_proj"] = ParamDef((cfg.d_model, cfg.d_model),
                                     (None, "model"))
    elif fam == "moe":
        if cfg.first_dense_layers:
            d["dense_layers"] = stack_defs(dense_layer_defs(cfg),
                                           cfg.first_dense_layers)
        d["layers"] = stack_defs(moe_layer_defs(cfg),
                                 cfg.n_layers - cfg.first_dense_layers)
    elif fam == "hybrid":
        d["layers"] = stack_defs(mamba_layer_defs(cfg), cfg.n_layers)
        d["shared_attn"] = attn_block_defs(cfg)
    elif fam == "ssm":   # xlstm
        period = cfg.slstm_period
        n_groups = cfg.n_layers // period
        d["layers"] = stack_defs(mlstm_layer_defs(cfg),
                                 n_groups * (period - 1))
        d["slstm"] = stack_defs(slstm_layer_defs(cfg), n_groups)
    else:
        raise ValueError(f"family {fam} not handled by DecoderModel")
    return d


def unstack(defs, tree) -> dict:
    """A model state ({name: tensor} as the model's ``state_dict`` names
    it) from a tree in the reference's layout with the stacked layers of
    ``defs``: each ``(L, ...)`` leaf of a ``STACKED`` subtree becomes L
    views, one a layer (no copy)."""
    state = {}
    for key in sorted(tree):
        sub = tree[key]
        if key not in STACKED:
            state.update(flatten({key: sub}))
            continue
        n = next(iter(flatten(defs[key]).values())).shape[0]
        for name, leaf in flatten(sub).items():
            if leaf.shape[0] != n:
                raise ValueError(f"{key}.{name}: {leaf.shape[0]} layers, "
                                 f"the config has {n}")
            for i in range(n):
                state[f"{key}.{i}.{name}"] = leaf[i]
    return state


def restack(defs, state: dict, layout=None) -> dict:
    """The tree in the reference's layout of a model state over the
    stacked ``defs`` (``unstack``'s inverse, without a copy): each leaf of
    a ``STACKED`` subtree a ``checkpoint.Stacked`` of its layers'
    tensors, the other leaves as they are.  With a tensor-parallel
    ``layout`` the state holds this rank's blocks, and each leaf is a
    restore template of its block of the full array (``checkpoint.Block``,
    or a ``Stacked`` with its ``index``)."""
    from repro_torch.checkpoint import Block, Stacked

    def index(d: ParamDef, stacked: bool):
        if layout is None:
            return None
        if stacked:
            return layout.block_index(d.spec[1:], d.shape[1:])
        return layout.block_index(d.spec, d.shape)

    def leaf(d: ParamDef, t):
        i = index(d, False)
        return t if i is None else Block(t, i)

    tree = {}
    for key in sorted(defs):
        sub = defs[key]
        if key in STACKED:
            n = next(iter(flatten(sub).values())).shape[0]
            tree[key] = unflatten({
                name: Stacked((state[f"{key}.{i}.{name}"] for i in range(n)),
                              index(d, True))
                for name, d in flatten(sub).items()})
        elif isinstance(sub, dict):
            tree[key] = unflatten({name: leaf(d, state[f"{key}.{name}"])
                                   for name, d in flatten(sub).items()})
        else:
            tree[key] = leaf(sub, state[key])
    return tree


def block_defs(defs, layout):
    """``defs`` with each shape this rank's block of it on ``layout``
    (``defs`` itself without one)."""
    if layout is None:
        return defs

    def blk(d: ParamDef):
        return ParamDef(shard_shape(d.shape, d.spec, layout), d.spec,
                        d.dtype, d.init_scale)
    return {k: blk(v) if isinstance(v, ParamDef) else block_defs(v, layout)
            for k, v in defs.items()}


def _split_dims(cfg) -> list:
    """[(what, size)] of every dimension ``cfg``'s specs split over
    ``model``, by family, as the reference's layouts divide them."""
    fam = cfg.family
    dense = fam in ("dense", "hybrid", "vlm", "audio") or (
        fam == "moe" and cfg.first_dense_layers)
    dims = [("vocab_size", cfg.vocab_size)]
    if fam != "ssm":
        dims.append(("n_heads", cfg.n_heads))
    if dense or (fam == "moe" and not cfg.kv_lora_rank):    # GQA runs
        dims.append(("n_kv_heads", cfg.n_kv_heads))
    if dense:
        dims.append(("d_ff", cfg.d_ff))
    if fam == "moe":
        f = cfg.moe_d_ff or cfg.d_ff
        dims.append(("n_experts", cfg.n_experts) if cfg.n_experts >= 16
                    else ("moe_d_ff", f))
        if cfg.n_shared_experts:
            dims.append(("moe_d_ff * n_shared_experts",
                         f * cfg.n_shared_experts))
    elif fam == "hybrid":
        dims.append(("Mamba2 heads (d_inner / ssm_head_dim)",
                     ssm.ssm_dims(cfg)[1]))
    elif fam == "ssm":
        dims.append(("d_model // n_heads (xLSTM's head dim)",
                     cfg.d_model // cfg.n_heads))
    return dims


def check_layout(cfg, layout) -> None:
    """Raise ``ValueError`` where ``layout``'s ``model`` axis does not
    divide a dimension ``cfg``'s specs split over it: the vocabulary, and
    by family GQA's heads and KV heads (where GQA runs: contiguous head
    blocks keep its map of query head q to KV head q // (H / Hkv)), the
    MLP's ``d_ff``, MLA's heads, the MoE's experts (E >= 16) or expert
    width, Mamba2's heads, xLSTM's head dim.  Heads, KV heads and the
    vocabulary are what ``configs.base.tp_pad_config`` pads.  The caches
    split over ``model`` only dims of these (GQA's KV heads, Mamba2's
    heads and their ``d_inner``, xLSTM's head dim; MLA's latent is
    whole), so a layout that passes places every cache too; over
    ``data`` a cache's split is dropped where it does not divide
    (``lm.cache_specs``)."""
    if layout is None or layout.M == 1:
        return
    for what, n in _split_dims(cfg):
        if n % layout.M:
            pad = what in ("vocab_size", "n_heads", "n_kv_heads")
            raise ValueError(
                f"{cfg.name}: {what} = {n} does not split over a model axis "
                f"of {layout.M}" + ("; pad it (configs.base.tp_pad_config)"
                                    if pad else ""))


def state_shapes(defs) -> dict:
    """{name: shape} of a model state over the stacked ``defs``, in the
    order of the reference's leaves (``flatten`` of the stacked tree),
    a stacked leaf's layers in turn."""
    shapes = {}
    for key in sorted(defs):
        sub = defs[key]
        if key not in STACKED:
            shapes.update({k: d.shape for k, d in flatten({key: sub}).items()})
            continue
        for name, d in flatten(sub).items():
            for i in range(d.shape[0]):
                shapes[f"{key}.{i}.{name}"] = d.shape[1:]
    return shapes


class StackedModel(nn.Module):
    """Parameters of ``defs`` over a state ({name: tensor}, adopted without
    a copy and frozen until ``lm.make_train_step``): top-level leaves as
    ``nn.Parameter``, a ``STACKED`` subtree as an ``nn.ModuleList`` of
    ``ParamTree`` (one a layer), any other subtree as one ``ParamTree``.
    Without a state the parameters lie on the meta device: shapes only,
    nothing allocated.  On a ``layout`` the state holds this rank's blocks
    (``block_defs``)."""

    def __init__(self, cfg, defs, state: Optional[dict] = None,
                 layout=None):
        super().__init__()
        self.cfg = cfg
        check_layout(cfg, layout)
        # the tensor-parallel layout; None on one card and for a model
        # axis of 1 (data parallelism runs the single-card model)
        self.layout = layout if layout is not None and layout.M > 1 \
            else None
        # the rank's place on the mesh, whatever its model axis (serving
        # reads its data axis: rows, sequence blocks)
        self.mesh_layout = layout
        shapes = state_shapes(block_defs(defs, layout))
        if state is None:
            state = {k: torch.empty(s, device="meta")
                     for k, s in shapes.items()}
        got = {k: tuple(v.shape) for k, v in state.items()}
        if got != shapes:
            bad = sorted(k for k in set(got) | set(shapes)
                         if got.get(k) != shapes.get(k))
            raise ValueError(f"{cfg.name}: state does not match the config "
                             f"at {bad[:8]}")
        for key, sub in unflatten(state).items():
            if key in STACKED:
                self.add_module(key, nn.ModuleList(
                    ParamTree(sub[str(i)]) for i in range(len(sub))))
            elif isinstance(sub, dict):
                self.add_module(key, ParamTree(sub))
            else:
                self.register_parameter(
                    key, nn.Parameter(sub, requires_grad=False))

    def _remat(self, mode, caches) -> bool:
        """Whether layers run under remat: train mode, no caches, gradients
        on and ``cfg.remat``."""
        return (mode == "train" and caches is None and self.cfg.remat
                and torch.is_grad_enabled())

    def cache_placement(self, caches):
        """(seq, data) of a serving forward over ``caches``: ``seq`` this
        rank's ``Layout`` where the KV caches' sequence is split over
        ``data`` (a stacked leaf's dim 2 in its ``.spec``), ``data`` where
        the rows are this rank's block of the batch over a data axis past
        1 (dim 1); each None otherwise.  Without caches (training), or
        without specs, the rows are split as training splits them."""
        lay = self.mesh_layout
        if lay is None or lay.D == 1:
            return None, None
        specs = [getattr(t, "spec", None)
                 for t in flatten(caches or {}).values()]
        if not specs or None in specs:
            return None, lay
        seq = any("data" in spec_axes(sp, 2) for sp in specs)
        rows = any("data" in spec_axes(sp, 1) for sp in specs)
        return (lay if seq else None), (lay if rows else None)

    def last_position(self, h, seq_len: int):
        """(B, 1, d): the last position of final hidden states ``h`` of a
        ``seq_len`` forward; on a sequence-parallel stream the last rank's
        block holds it (each rank's last positions gathered, the last
        kept)."""
        h = h[:, -1:]
        if self.layout is not None and \
                self.layout.seq_parallel(self.cfg, seq_len):
            h = tp.all_gather(h, self.layout.model, 1)[:, -1:]
        return h

    def _logits(self, h, w, transpose: bool):
        """float32 logits of ``h`` against the unembedding ``w``; on a
        tensor-parallel layout this rank's vocab block, gathered over
        ``model`` to the full vocabulary."""
        w = w.to(h.dtype)
        logits = matmul(h, w.T if transpose else w).float()
        if self.layout is not None:
            logits = tp.all_gather(logits, self.layout.model, -1)
        return logits

    def _run_layers(self, run, h, lo, hi, mode, caches, group: int = 1):
        """``run(h, a, b)`` (layers ``a:b`` from the residual stream ``h``)
        over layers ``lo:hi``; under remat a checkpoint each ``group``
        layers, which keeps only the stream entering the group."""
        if not self._remat(mode, caches):
            return run(h, lo, hi)
        for a in range(lo, hi, group):
            h = checkpoint(run, h, a, min(a + group, hi),
                           use_reentrant=False, preserve_rng_state=False)
        return h


def layer_cache(caches, name: str, i: int):
    """Layer ``i``'s slice of the stacked cache ``caches[name]`` (views:
    the layer writes through them in place); None without caches."""
    if caches is None:
        return None
    return {k: v[i] for k, v in caches[name].items()}


class DecoderModel(StackedModel):
    """The decoder of ``cfg`` over a state ({name: tensor}, adopted without
    a copy); on the meta device without one.  ``layout``: the rank's
    place on a mesh (module docstring)."""

    def __init__(self, cfg, state: Optional[dict] = None, layout=None):
        super().__init__(cfg, param_defs(cfg), state, layout)

    # ---------------- parameter / cache declarations

    def param_defs(self):
        return param_defs(self.cfg)

    def cache_defs(self, batch: int, s_max: int):
        cfg = self.cfg
        fam = cfg.family
        if fam in ("dense", "vlm"):
            return {"layers": stack_defs(
                attention.gqa_cache_defs(cfg, batch, s_max), cfg.n_layers)}
        if fam == "moe":
            base = (attention.mla_cache_defs(cfg, batch, s_max)
                    if cfg.kv_lora_rank
                    else attention.gqa_cache_defs(cfg, batch, s_max))
            c = {"layers": stack_defs(base,
                                      cfg.n_layers - cfg.first_dense_layers)}
            if cfg.first_dense_layers:
                c["dense_layers"] = stack_defs(
                    attention.gqa_cache_defs(cfg, batch, s_max),
                    cfg.first_dense_layers)
            return c
        if fam == "hybrid":
            n_apps = len(segment_bounds(cfg.n_layers, cfg.shared_attn_every))
            return {"layers": stack_defs(ssm.mamba_cache_defs(cfg, batch),
                                         cfg.n_layers),
                    "shared_attn": stack_defs(
                        attention.gqa_cache_defs(cfg, batch, s_max), n_apps)}
        if fam == "ssm":
            period = cfg.slstm_period
            n_groups = cfg.n_layers // period
            return {"layers": stack_defs(xlstm.mlstm_cache_defs(cfg, batch),
                                         n_groups * (period - 1)),
                    "slstm": stack_defs(xlstm.slstm_cache_defs(cfg, batch),
                                        n_groups)}
        raise ValueError(fam)

    def _gemma_flags(self):
        """(is_global, window, theta) per layer for local:global patterns.
        Layer i is global when (i % (ratio+1)) == ratio; local layers use
        the sliding window and the local rope theta."""
        cfg = self.cfg
        L, ratio = cfg.n_layers, cfg.local_global_ratio
        is_global = np.array([(i % (ratio + 1)) == ratio for i in range(L)])
        big = np.int32(2**30)
        win = np.where(is_global, big, np.int32(cfg.sliding_window or big))
        theta = np.where(is_global, cfg.rope_theta, cfg.local_rope_theta)
        return is_global, win.astype(np.int32), theta.astype(np.float32)

    def _layer_flags(self):
        """(window, theta) of each layer, as host numbers."""
        cfg = self.cfg
        if not cfg.local_global_ratio:
            return [(cfg.sliding_window, None)] * cfg.n_layers
        _, win, theta = self._gemma_flags()
        return [(int(w), float(t)) for w, t in zip(win, theta)]

    def _attn_layer_apply(self, lp, h, mode, cache, cache_len, window,
                          theta, is_moe=False, sp=False, place=(None, None)):
        """One attention layer; ``sp``: the stream is sequence-parallel
        (a tensor-parallel layout only); ``place``: ``cache_placement``'s
        (seq, data)."""
        cfg = self.cfg
        lay = self.layout
        seq, data = place
        ln_in = tp.enter(rms_norm(h, lp["ln1"], cfg.norm_eps), lay, sp)
        if cfg.kv_lora_rank and is_moe:
            if mode == "decode":
                a, cache = attention.mla_decode(lp["attn"], ln_in, cfg,
                                                cache, cache_len, seq=seq)
            else:
                a, cache = attention.mla_full(lp["attn"], ln_in, cfg,
                                              cache=cache, seq=seq)
        elif mode == "decode":
            a, cache = attention.gqa_decode(lp["attn"], ln_in, cfg, cache,
                                            cache_len, window=window,
                                            theta=theta, seq=seq)
        else:
            a, cache = attention.gqa_full(lp["attn"], ln_in, cfg,
                                          window=window, theta=theta,
                                          cache=cache, seq=seq)
        h = h + tp.leave(a, lay, sp)
        ln2 = tp.enter(rms_norm(h, lp["ln2"], cfg.norm_eps), lay, sp)
        if is_moe:
            # the routed and the shared experts' partial sums, left once
            y = moe.moe_apply(lp["ffn"], ln2, cfg, layout=lay, data=data)
        else:
            y = mlp.swiglu_apply(lp["ffn"], ln2)
        return h + tp.leave(y, lay, sp), cache

    def _attn_stack(self, name, h, mode, caches, cache_len, lo=0, hi=None,
                    flags=None, is_moe=False, sp=False, place=(None, None)):
        """Layers ``lo:hi`` of the stack ``name``."""
        cfg = self.cfg
        stack = getattr(self, name)
        hi = len(stack) if hi is None else hi

        def run(h, a, b):
            for i in range(a, b):
                win, theta = (cfg.sliding_window, None) if flags is None \
                    else flags[i]
                h, _ = self._attn_layer_apply(
                    stack[i], h, mode, layer_cache(caches, name, i),
                    cache_len, win, theta, is_moe, sp, place)
            return h

        # grouped remat where the group divides the stack, as the
        # reference's scan over (L / G, G) layers
        G = cfg.remat_group if cfg.remat_group > 1 \
            and (hi - lo) % cfg.remat_group == 0 else 1
        return self._run_layers(run, h, lo, hi, mode, caches, G)

    def _mamba_stack(self, h, mode, caches, lo, hi, sp=False):
        cfg = self.cfg
        lay = self.layout

        def run(h, a, b):
            for i in range(a, b):
                lp = self.layers[i]
                # the scan runs along the whole sequence: gathered under
                # sequence parallelism
                ln = tp.enter(rms_norm(h, lp["ln"], cfg.norm_eps), lay, sp)
                cache = layer_cache(caches, "layers", i)
                if mode == "decode":
                    y, _ = ssm.mamba_decode(lp["mixer"], ln, cfg, cache)
                else:
                    y, _ = ssm.mamba_full(lp["mixer"], ln, cfg, cache=cache)
                h = h + tp.leave(y, lay, sp)
            return h

        return self._run_layers(run, h, lo, hi, mode, caches)

    def _recurrent(self, name, apply_fn, h, mode, caches, lo, hi, sp=False):
        """Layers ``lo:hi`` of the xLSTM stack ``name`` (mLSTM or
        sLSTM)."""
        cfg = self.cfg
        stack = getattr(self, name)
        lay = self.layout

        def run(h, a, b):
            for i in range(a, b):
                lp = stack[i]
                ln = tp.enter(rms_norm(h, lp["ln"], cfg.norm_eps), lay, sp)
                y, _ = apply_fn(lp["mixer"], ln, cfg,
                                cache=layer_cache(caches, name, i),
                                decode=(mode == "decode"), layout=lay)
                h = h + tp.leave(y, lay, sp)
            return h

        return self._run_layers(run, h, lo, hi, mode, caches)

    # ---------------- forward

    def forward(self, tokens, *, mode="train", caches=None, cache_len=None,
                image_embeds=None, return_hidden=False):
        """tokens: (B, S) integers (S = 1 for decode); ``cache_len`` a host
        int.  Returns (logits, or the final hidden states with
        ``return_hidden``, and the caches, updated in place).  On a mesh
        ``tokens`` are the rows this rank serves (module docstring); the
        logits are over the full vocabulary, the hidden states this rank's
        block of the sequence where the stream is sequence-parallel."""
        cfg = self.cfg
        dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        lay = self.layout
        place = self.cache_placement(caches)
        sp = False
        if lay is None:
            h = F.embedding(tokens, self.embed).to(dt)
        else:
            sp = lay.seq_parallel(cfg, tokens.shape[1])
            h = tp.embed_lookup(tokens, self.embed, lay, sp).to(dt)
        if getattr(cfg, "embed_scale", False):   # gemma: h *= sqrt(d)
            # sqrt(d) rounded to h's dtype first, as the reference does
            h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
        fam = cfg.family
        if fam == "dense":
            h = self._attn_stack("layers", h, mode, caches, cache_len,
                                 flags=self._layer_flags(), sp=sp,
                                 place=place)
        elif fam == "moe":
            if cfg.first_dense_layers:
                h = self._attn_stack("dense_layers", h, mode, caches,
                                     cache_len, sp=sp, place=place)
            h = self._attn_stack("layers", h, mode, caches, cache_len,
                                 is_moe=True, sp=sp, place=place)
        elif fam == "hybrid":
            for a, (lo, hi) in enumerate(segment_bounds(
                    cfg.n_layers, cfg.shared_attn_every)):
                # the shared block: the same weights at every application,
                # a KV cache each
                h, _ = self._attn_layer_apply(
                    self.shared_attn, h, mode,
                    layer_cache(caches, "shared_attn", a), cache_len, None,
                    None, sp=sp, place=place)
                h = self._mamba_stack(h, mode, caches, lo, hi, sp)
        elif fam == "ssm":
            per_seg = cfg.slstm_period - 1
            for g in range(cfg.n_layers // cfg.slstm_period):
                h = self._recurrent("layers", xlstm.mlstm_apply, h, mode,
                                    caches, g * per_seg, (g + 1) * per_seg,
                                    sp)
                h = self._recurrent("slstm", xlstm.slstm_apply, h, mode,
                                    caches, g, g + 1, sp)
        elif fam == "vlm":
            period = cfg.cross_attn_period
            img = None
            if image_embeds is not None:
                # recomputed on every call, decode steps included
                img = matmul(image_embeds.to(h.dtype), self.img_proj)
                if lay is not None:
                    # img_proj's column block gives a block of d; the cross
                    # attention's wk/wv read d whole (the backward
                    # reduce-scatters every rank's heads' partial sums)
                    img = tp.gather(img, lay.model, -1)
            for ci in range(cfg.n_layers // period):
                if img is not None:
                    cp = self.cross[ci]
                    ln = tp.enter(rms_norm(h, cp["ln1"], cfg.norm_eps), lay,
                                  sp)
                    h = h + tp.leave(attention.cross_apply(cp["attn"], ln,
                                                           img, cfg),
                                     lay, sp)
                    ln2 = tp.enter(rms_norm(h, cp["ln2"], cfg.norm_eps), lay,
                                   sp)
                    h = h + tp.leave(mlp.swiglu_apply(cp["ffn"], ln2), lay,
                                     sp)
                h = self._attn_stack("layers", h, mode, caches, cache_len,
                                     ci * period, (ci + 1) * period, sp=sp,
                                     place=place)
        else:
            raise ValueError(fam)
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        if return_hidden:
            return h, caches
        return self.unembed(h), caches

    def unembed(self, h):
        """float32 logits of hidden states (B, S, d), over the full
        vocabulary (``_logits``)."""
        return self._logits(h, *self.unembed_weights())

    def unembed_weights(self):
        """(W, transpose) such that logits = h @ (W.T if transpose else
        W)."""
        if self.cfg.tie_embeddings:
            return self.embed, True
        return self.head, False
