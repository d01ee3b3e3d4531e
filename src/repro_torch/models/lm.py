"""Serve-step builders over the model zoo.

A port of the serving part of the JAX package's ``repro.models.lm``:
``build_model`` maps an ArchConfig to its model (``EncDecModel`` for the
audio family, ``DecoderModel`` for the others), ``init_cache`` makes the
empty decode state, ``make_prefill_step`` and ``make_decode_step`` build
the two steps of greedy generation, passing ``image_embeds`` (vlm) and
``audio_embeds`` (audio) from the batch.  A model of the port holds its
weights, so the step builders take the built model where the reference
takes the config, and the steps drop the reference's ``params`` argument.
Training (``next_token_loss``, ``vocab_parallel_ce``, ``make_train_step``)
and the dry-run's abstract inputs wait for their slices (ROADMAP Queue 1
item 6).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import common, transformer, whisper


def param_defs(cfg):
    """The reference's parameter tree (stacked layers) of ``cfg``'s
    model."""
    if cfg.family == "audio":
        return whisper.param_defs(cfg)
    return transformer.param_defs(cfg)


def build_model(cfg, *, state: Optional[dict] = None,
                generator: Optional[torch.Generator] = None):
    """The model of ``cfg``: over ``state`` ({name: tensor}, adopted), or
    with weights drawn from ``generator`` on its device
    (``common.init_params`` over the stacked defs, then unstacked), or on
    the meta device (shapes only).  An unknown family raises
    ``ValueError``."""
    cls = whisper.EncDecModel if cfg.family == "audio" \
        else transformer.DecoderModel
    if generator is not None:
        if state is not None:
            raise ValueError("pass a state or a generator, not both")
        defs = param_defs(cfg)
        state = transformer.unstack(defs, common.init_params(defs,
                                                             generator))
    return cls(cfg, state)


def _modality(cfg, batch) -> dict:
    """The keyword inputs of the modality stubs that ``cfg``'s model
    reads from ``batch``."""
    if cfg.family == "vlm":
        return {"image_embeds": batch["image_embeds"]}
    if cfg.family == "audio":
        return {"audio_embeds": batch["audio_embeds"]}
    return {}


def init_cache(cfg, batch: int, s_max: int, dtype=torch.float32, *,
               device=None):
    """Concrete empty decode state on ``device`` (None: the CUDA card):
    zeros, but for the xLSTM gate stabilizers ``m``, which start at -1e30
    (an empty exponential-gated memory), as the blocks' own cache-less
    start does."""
    dev = resolve_device(device)
    defs = build_model(cfg).cache_defs(batch, s_max)

    def mk(tree):
        return {k: mk(v) if isinstance(v, dict) else (
            torch.full(v.shape, -1e30, dtype=dtype, device=dev)
            if k == "m" and cfg.family == "ssm"
            else torch.zeros(v.shape, dtype=dtype, device=dev))
            for k, v in tree.items()}

    return mk(defs)


def make_prefill_step(model):
    """``prefill_step(caches, batch) -> (logits (B, V), caches)``: the
    prompt through the model, unembedding only the last position."""

    def prefill_step(caches, batch):
        h, caches = model(batch["tokens"], mode="prefill", caches=caches,
                          cache_len=None, return_hidden=True,
                          **_modality(model.cfg, batch))
        # (B, 1, d) @ (d, V), not (B, S, V)
        return model.unembed(h[:, -1:])[:, 0], caches

    return prefill_step


def make_decode_step(model):
    """``decode_step(caches, token (B, 1), cache_len, batch=None) ->
    (logits (B, V), caches)``; ``batch`` carries the modality inputs."""

    def decode_step(caches, token, cache_len, batch=None):
        logits, caches = model(token, mode="decode", caches=caches,
                               cache_len=cache_len,
                               **_modality(model.cfg, batch or {}))
        return logits[:, -1], caches

    return decode_step
