"""Decoder-only model assembly, family ``"dense"``.

A port of the JAX package's ``repro.models.transformer`` for the dense
family (gemma3 with its local:global layers, qwen2.5, phi4-mini,
mistral-large).  ``DecoderModel`` is an ``nn.Module`` whose parameters keep
the reference's layouts (``wq (d, H, hd)``, ``wo (H, hd, d)``,
``w_gate (d, f)``, ``embed (V, d)``); where the reference scans over
stacked ``(L, ...)`` leaves, the port holds one ``nn.ModuleList`` entry a
layer.  ``param_defs`` and ``cache_defs`` return the reference's stacked
trees, so counts and shapes compare leaf for leaf.

The other families (moe, hybrid, ssm, vlm, and the audio enc-dec) raise
``NotImplementedError``: their serving path is ROADMAP Queue 1 item 6's
next slice.  The reference's activation-sharding constraint (``_shard_h``)
has no counterpart on one card; without a mesh it is a no-op there too.
Remat and the grouped-remat scan are training's, which waits likewise.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import attention, mlp
from repro_torch.models.common import (ParamDef, ParamTree, flatten,
                                       matmul, rms_norm, unflatten)

FAMILIES = ("dense",)
PENDING = ("ROADMAP Queue 1 item 6: the other families on the serving path "
           "(moe with MLA, hybrid, ssm, vlm cross-attention, audio)")


def check_family(cfg) -> None:
    """Raise for a family this port does not run yet (no substitute)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; see "
            f"{PENDING}")


def stack_defs(defs, n: int):
    def bump(d: ParamDef):
        return ParamDef((n,) + d.shape, (None, *d.spec), d.dtype,
                        d.init_scale)
    return {k: bump(v) if isinstance(v, ParamDef) else stack_defs(v, n)
            for k, v in defs.items()}


def _norm_def(cfg):
    return ParamDef((cfg.d_model,), (None,), init_scale=0.0)


def dense_layer_defs(cfg):
    return {"ln1": _norm_def(cfg), "attn": attention.gqa_defs(cfg),
            "ln2": _norm_def(cfg), "ffn": mlp.swiglu_defs(cfg)}


def param_defs(cfg):
    """The reference's parameter tree (stacked layers) of ``cfg``."""
    check_family(cfg)
    d = {"embed": ParamDef((cfg.vocab_size, cfg.d_model), ("model", None)),
         "final_norm": _norm_def(cfg)}
    if not cfg.tie_embeddings:
        d["head"] = ParamDef((cfg.d_model, cfg.vocab_size), (None, "model"))
    d["layers"] = stack_defs(dense_layer_defs(cfg), cfg.n_layers)
    return d


def unstack(cfg, tree) -> dict:
    """A model state ({name: tensor} as ``DecoderModel.state_dict`` names
    it) from a tree in the reference's layout: each stacked ``(L, ...)``
    leaf of ``tree["layers"]`` becomes L views, one a layer (no copy)."""
    state = {k: v for k, v in flatten(tree).items()
             if not k.startswith("layers.")}
    for name, leaf in flatten(tree["layers"]).items():
        if leaf.shape[0] != cfg.n_layers:
            raise ValueError(f"layers.{name}: {leaf.shape[0]} layers, the "
                             f"config has {cfg.n_layers}")
        for i in range(cfg.n_layers):
            state[f"layers.{i}.{name}"] = leaf[i]
    return state


def state_shapes(cfg) -> dict:
    """{name: shape} of a model state of ``cfg``."""
    shapes = {k: d.shape for k, d in flatten(param_defs(cfg)).items()
              if not k.startswith("layers.")}
    for name, d in flatten(dense_layer_defs(cfg)).items():
        for i in range(cfg.n_layers):
            shapes[f"layers.{i}.{name}"] = d.shape
    return shapes


class DecoderModel(nn.Module):
    """The decoder of ``cfg`` over a state ({name: tensor}, adopted without
    a copy and frozen).  Without a state its parameters lie on the meta
    device: shapes only, nothing allocated."""

    def __init__(self, cfg, state: Optional[dict] = None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        shapes = state_shapes(cfg)
        if state is None:
            state = {k: torch.empty(s, device="meta")
                     for k, s in shapes.items()}
        got = {k: tuple(v.shape) for k, v in state.items()}
        if got != shapes:
            bad = sorted(k for k in set(got) | set(shapes)
                         if got.get(k) != shapes.get(k))
            raise ValueError(f"{cfg.name}: state does not match the config "
                             f"at {bad[:8]}")
        tree = unflatten(state)
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        self.final_norm = nn.Parameter(tree["final_norm"],
                                       requires_grad=False)
        if "head" in tree:
            self.head = nn.Parameter(tree["head"], requires_grad=False)
        self.layers = nn.ModuleList(
            ParamTree(tree["layers"][str(i)]) for i in range(cfg.n_layers))

    # ---------------- parameter / cache declarations

    def param_defs(self):
        return param_defs(self.cfg)

    def cache_defs(self, batch: int, s_max: int):
        cfg = self.cfg
        return {"layers": stack_defs(
            attention.gqa_cache_defs(cfg, batch, s_max), cfg.n_layers)}

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
                          theta):
        cfg = self.cfg
        ln_in = rms_norm(h, lp["ln1"], cfg.norm_eps)
        if mode == "decode":
            a, cache = attention.gqa_decode(lp["attn"], ln_in, cfg, cache,
                                            cache_len, window=window,
                                            theta=theta)
        else:
            a, cache = attention.gqa_full(lp["attn"], ln_in, cfg,
                                          window=window, theta=theta,
                                          cache=cache)
        h = h + a
        ln2 = rms_norm(h, lp["ln2"], cfg.norm_eps)
        return h + mlp.swiglu_apply(lp["ffn"], ln2), cache

    # ---------------- forward

    def forward(self, tokens, *, mode="train", caches=None, cache_len=None,
                return_hidden=False):
        """tokens: (B, S) integers (S = 1 for decode).  Returns (logits,
        or the final hidden states with ``return_hidden``, and the caches,
        updated in place)."""
        cfg = self.cfg
        dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        h = F.embedding(tokens, self.embed).to(dt)
        if getattr(cfg, "embed_scale", False):   # gemma: h *= sqrt(d)
            # sqrt(d) rounded to h's dtype first, as the reference does
            h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
        layer_caches = None if caches is None else caches["layers"]
        for i, (lp, (win, theta)) in enumerate(zip(self.layers,
                                                   self._layer_flags())):
            cache = None if layer_caches is None else \
                {"k": layer_caches["k"][i], "v": layer_caches["v"][i]}
            h, _ = self._attn_layer_apply(lp, h, mode, cache, cache_len,
                                          win, theta)
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        if return_hidden:
            return h, caches
        return self.unembed(h), caches

    def unembed(self, h):
        """float32 logits of hidden states (B, S, d)."""
        w, transpose = self.unembed_weights()
        w = w.to(h.dtype)
        return matmul(h, w.T if transpose else w).float()

    def unembed_weights(self):
        """(W, transpose) such that logits = h @ (W.T if transpose else
        W)."""
        if self.cfg.tie_embeddings:
            return self.embed, True
        return self.head, False
