"""Serve-step builders over the model zoo.

A port of the serving part of the JAX package's ``repro.models.lm``:
``build_model`` maps an ArchConfig to its model, ``init_cache`` makes the
empty decode state, ``make_prefill_step`` and ``make_decode_step`` build
the two steps of greedy generation.  A model of the port holds its
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
from repro_torch.models import common
from repro_torch.models.transformer import DecoderModel, check_family, \
    param_defs, unstack


def build_model(cfg, *, state: Optional[dict] = None,
                generator: Optional[torch.Generator] = None):
    """The model of ``cfg``: over ``state`` ({name: tensor}, adopted), or
    with weights drawn from ``generator`` on its device
    (``common.init_params``), or on the meta device (shapes only)."""
    check_family(cfg)
    if generator is not None:
        if state is not None:
            raise ValueError("pass a state or a generator, not both")
        state = unstack(cfg, common.init_params(param_defs(cfg), generator))
    return DecoderModel(cfg, state)


def init_cache(cfg, batch: int, s_max: int, dtype=torch.float32, *,
               device=None):
    """Concrete empty decode state (zeros) on ``device`` (None: the CUDA
    card)."""
    dev = resolve_device(device)
    defs = DecoderModel(cfg).cache_defs(batch, s_max)
    return common.tree_defs_map(
        lambda d: torch.zeros(d.shape, dtype=dtype, device=dev), defs)


def make_prefill_step(model):
    """``prefill_step(caches, batch) -> (logits (B, V), caches)``: the
    prompt through the model, unembedding only the last position."""

    def prefill_step(caches, batch):
        h, caches = model(batch["tokens"], mode="prefill", caches=caches,
                          cache_len=None, return_hidden=True)
        # (B, 1, d) @ (d, V), not (B, S, V)
        return model.unembed(h[:, -1:])[:, 0], caches

    return prefill_step


def make_decode_step(model):
    """``decode_step(caches, token (B, 1), cache_len, batch=None) ->
    (logits (B, V), caches)``."""

    def decode_step(caches, token, cache_len, batch=None):
        logits, caches = model(token, mode="decode", caches=caches,
                               cache_len=cache_len)
        return logits[:, -1], caches

    return decode_step
