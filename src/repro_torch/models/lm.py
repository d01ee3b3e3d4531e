"""Train and serve step builders over the model zoo.

A port of the JAX package's ``repro.models.lm``: ``build_model`` maps an
ArchConfig to its model (``EncDecModel`` for the audio family,
``DecoderModel`` for the others), ``init_cache`` makes the empty decode
state, ``make_prefill_step`` and ``make_decode_step`` build the two steps
of greedy generation, passing ``image_embeds`` (vlm) and ``audio_embeds``
(audio) from the batch.  A model of the port holds its weights, so the
step builders take the built model where the reference takes the config,
and the steps drop the reference's ``params`` argument.

Training: ``next_token_loss``; ``vocab_parallel_ce``, whose sharded
branch needs the model sharded over the port's mesh (the sharded-training
slice, ROADMAP Queue 1 item 6), so a mesh with a ``model`` axis past 1
raises; ``make_train_step`` on the built model, which turns its
parameters' gradients on and updates them in place (``optim.adamw``).
The reference's loss has no MoE auxiliary term, nor has the port's.  The
dry-run's abstract inputs and the sharding helpers wait for their slices.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import common, transformer, whisper
from repro_torch.optim import adamw


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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def trainable_params(model) -> dict:
    """{name: parameter} of ``model`` in the reference's leaf order (its
    stacked leaves in ``jax.tree.leaves`` order, a leaf's layers in turn):
    the order of the optimizer's sums."""
    named = dict(model.named_parameters())
    return {k: named[k] for k in transformer.state_shapes(
        param_defs(model.cfg))}


def next_token_loss(logits, targets, loss_mask):
    """Mean cross-entropy over the masked positions, in float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = (logz - tgt) * loss_mask
    return nll.sum() / torch.clamp_min(loss_mask.sum(), 1.0)


def _unembed_logits(h, w, transpose_w):
    w = w.to(h.dtype)
    return common.matmul(h, w.T if transpose_w else w)


def vocab_parallel_ce(h, w, transpose_w, targets, loss_mask, *, mesh=None):
    """The reference's vocab-parallel cross-entropy, logits = h @ (W.T if
    ``transpose_w`` else W).  Without a mesh, or on a mesh whose ``model``
    axis is 1, the plain loss over the full logits (the reference's branch
    on one device).  A ``model`` axis past 1 raises: the vocab-sharded
    branch comes with sharded training."""
    if mesh is not None and "model" in mesh.mesh_dim_names:
        tp = mesh.size(list(mesh.mesh_dim_names).index("model"))
        if tp > 1:
            raise NotImplementedError(
                f"vocab_parallel_ce over a model axis of {tp}: the "
                "vocab-sharded loss comes with sharded training (ROADMAP "
                "Queue 1 item 6, the slice after the scan kernels)")
    return next_token_loss(_unembed_logits(h, w, transpose_w), targets,
                           loss_mask)


def batch_to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors on ``device``: tokens and
    targets as int64, the rest float32."""
    out = {}
    for k, v in batch.items():
        dt = torch.int64 if k in ("tokens", "targets") else torch.float32
        t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        out[k] = t.to(device=device, dtype=dt)
    return out


def train_loss(model, batch):
    """The reference's training loss of ``batch`` (tensors on the model's
    device): the final hidden states unembedded, the next-token loss."""
    cfg = model.cfg
    h, _ = model(batch["tokens"], mode="train", return_hidden=True,
                 **_modality(cfg, batch))
    w, transpose_w = model.unembed_weights()
    if getattr(cfg, "parallelism", "tp") == "fsdp":
        # the reference's FSDP branch: the plain loss, as on one card
        return next_token_loss(_unembed_logits(h, w, transpose_w),
                               batch["targets"], batch["loss_mask"])
    return vocab_parallel_ce(h, w, transpose_w, batch["targets"],
                             batch["loss_mask"])


def loss_and_grads(model, params: dict, batch: dict):
    """(loss, {name: float32 gradient}) of ``batch`` with respect to
    ``params`` (``trainable_params``, gradients on), the loss detached;
    a parameter the loss does not reach gets zeros, as under
    ``jax.grad``."""
    for p in params.values():
        p.grad = None
    loss = train_loss(model, batch)
    loss.backward()
    grads = {k: p.grad.float() if p.grad is not None
             else torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    for p in params.values():
        p.grad = None
    return loss.detach(), grads


def make_train_step(model, opt_cfg: adamw.AdamWConfig, *,
                    microbatches: int = 1):
    """``train_step(opt_state, batch) -> (opt_state, {"loss", "grad_norm",
    "lr"})``: the next-token loss of ``batch`` (numpy arrays or tensors,
    put on the model's device), its gradients, and one AdamW update of the
    model's parameters in place; the metrics are 0-d tensors on the
    device.  With ``microbatches`` the batch is cut into that many row
    blocks, and the gradients (summed in float32) and the loss are
    averaged over them, as the reference's scan does.  Turns the model's
    parameters' gradients on."""
    model.requires_grad_(True)
    params = trainable_params(model)
    dev = next(iter(params.values())).device

    def train_step(opt_state, batch):
        batch = batch_to_device(batch, dev)
        if microbatches == 1:
            loss, grads = loss_and_grads(model, params, batch)
        else:
            n = batch["tokens"].shape[0] // microbatches
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = None
            for i in range(microbatches):
                l_i, g_i = loss_and_grads(model, params, {
                    k: v[i * n:(i + 1) * n] for k, v in batch.items()})
                loss = loss + l_i
                if grads is None:
                    grads = g_i
                else:
                    for k, g in g_i.items():
                        grads[k].add_(g)
            grads = {k: g.div_(microbatches) for k, g in grads.items()}
            loss = loss / microbatches
        _, opt_state, om = adamw.adamw_update(opt_cfg, grads, opt_state,
                                              params)
        return opt_state, {"loss": loss, **om}

    return train_step
