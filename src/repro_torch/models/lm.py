"""Train and serve step builders over the model zoo.

A port of the JAX package's ``repro.models.lm``: ``build_model`` maps an
ArchConfig to its model (``EncDecModel`` for the audio family,
``DecoderModel`` for the others), ``init_cache`` makes the empty decode
state, ``make_prefill_step`` and ``make_decode_step`` build the two steps
of greedy generation, passing ``image_embeds`` (vlm) and ``audio_embeds``
(audio) from the batch.  A model of the port holds its weights, so the
step builders take the built model where the reference takes the config,
and the steps drop the reference's ``params`` argument.  On a mesh
(``build_model(layout=)``) the steps serve a rank's rows
(``served_rows``) from its blocks of the caches (``init_cache(layout=)``,
placed by ``cache_specs`` as the dry-run places them) and return the
full-vocabulary logits of those rows.

Training: ``next_token_loss``; ``vocab_parallel_ce``, whose vocab-sharded
branch runs on a ``model`` axis past 1 (``sharding.tensor_parallel``);
``make_train_step`` on the built model, which turns its parameters'
gradients on and updates them in place (``optim.adamw``).  On a mesh
(``layout``) each rank holds its rows of the batch and its blocks of the
parameters: the loss is the mean over the global batch, the gradients are
summed over ``data`` (each rank's share of that mean), and the gradient
norm counts each block once.  The reference's loss has no MoE auxiliary
term, nor has the port's.

The dry-run's abstract inputs and the sharding helpers (``_dp_axes``,
``fsdp_param_sharding``, ``sanitize_specs``, ``_reshard_cache_seq``,
``zero1_sharding``, ``input_specs``, ``abstract_state``) work on specs
(tuples: an axis name, a tuple of them, or None a dim) and meta tensors
carrying them as ``.spec``, on any mesh with ``axis_names`` and ``shape``
({axis: size}; ``launch.mesh.AbstractMesh``).  They make the reference's
choices of dimension and axes, fallbacks included, and return a spec
where the reference returns a ``NamedSharding``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import (attention, common, moe, ssm, transformer,
                                 whisper, xlstm)
from repro_torch.optim import adamw
from repro_torch.sharding import collectives
from repro_torch.sharding import tensor_parallel as tp

# tokens a chunk of the vocab-sharded loss (the reference's chunk_t)
CE_CHUNK = 8192


def param_defs(cfg):
    """The reference's parameter tree (stacked layers) of ``cfg``'s
    model."""
    if cfg.family == "audio":
        return whisper.param_defs(cfg)
    return transformer.param_defs(cfg)


def build_model(cfg, *, state: Optional[dict] = None,
                generator: Optional[torch.Generator] = None, layout=None):
    """The model of ``cfg``: over ``state`` ({name: tensor}, adopted), or
    with weights drawn from ``generator`` on its device
    (``common.init_params`` over the stacked defs, then unstacked), or on
    the meta device (shapes only).  On a ``layout``
    (``tensor_parallel.Layout``) the state holds this rank's blocks; drawn
    from a generator, every rank draws the full weights of the
    single-device model and keeps its blocks.  An unknown family raises
    ``ValueError``."""
    cls = whisper.EncDecModel if cfg.family == "audio" \
        else transformer.DecoderModel
    if generator is not None:
        if state is not None:
            raise ValueError("pass a state or a generator, not both")
        transformer.check_layout(cfg, layout)
        defs = param_defs(cfg)
        keep = None if layout is None or layout.M == 1 else \
            (lambda d, t: layout.block(t, d.spec))
        state = transformer.unstack(defs, common.init_params(
            defs, generator, keep=keep))
    return cls(cfg, state, layout)


def _modality(cfg, batch) -> dict:
    """The keyword inputs of the modality stubs that ``cfg``'s model
    reads from ``batch``."""
    if cfg.family == "vlm":
        return {"image_embeds": batch["image_embeds"]}
    if cfg.family == "audio":
        return {"audio_embeds": batch["audio_embeds"]}
    return {}


def init_cache(cfg, batch: int, s_max: int, dtype=torch.float32, *,
               device=None, layout=None):
    """Concrete empty decode state on ``device`` (None: the CUDA card):
    zeros, but for the xLSTM gate stabilizers ``m``, which start at -1e30
    (an empty exponential-gated memory), as the blocks' own cache-less
    start does.

    On a mesh (``layout``: a ``DeviceMesh`` or a ``tensor_parallel.Layout``)
    this rank's block of every leaf of a ``batch``-row cache, laid out by
    ``cache_specs`` (the dry-run's placement); each leaf carries its spec
    as ``.spec``, which the model's serving forward reads
    (``transformer.DecoderModel.cache_placement``)."""
    dev = resolve_device(device)
    lay = _as_layout(layout)
    if lay is None:
        defs = build_model(cfg).cache_defs(batch, s_max)
    else:
        defs = cache_specs(cfg, batch, s_max, lay)

    def mk(name, d):
        shape = d.shape if lay is None else \
            common.shard_shape(d.shape, d.spec, lay)
        t = torch.full(shape, -1e30, dtype=dtype, device=dev) \
            if name == "m" and cfg.family == "ssm" \
            else torch.zeros(shape, dtype=dtype, device=dev)
        if lay is not None:
            t.spec = tuple(d.spec)
        return t

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else mk(k, v)
                for k, v in tree.items()}

    return walk(defs)


def cache_specs(cfg, batch: int, s_max: int, mesh, kind: str = "decode"):
    """The cache defs of a ``batch`` x ``s_max`` decode state with the
    specs they take on ``mesh``: the model's ``cache_defs``; for a
    ``kind="decode"`` cell with a batch below the data extent,
    ``_reshard_cache_seq`` (the KV caches' sequence over the data axes);
    then ``sanitize_specs``.  The dry-run's caches (``input_specs``; a
    prefill cell, as the reference's, without the resharding) and the
    run's (``init_cache``: a cache that serves decode steps) are placed by
    it."""
    defs = build_model(cfg).cache_defs(batch, s_max)
    if kind == "decode":
        dp = _dp_axes(mesh, cfg)
        if batch < _extent(mesh, dp):
            # long-context decode at a tiny batch: the caches' sequence
            # dim over the data axes instead of the batch dim
            defs = _reshard_cache_seq(defs, s_max, dp)
    return sanitize_specs(defs, mesh)


def served_rows(batch: int, layout) -> slice:
    """The rows of a ``batch``-row request that this rank serves on a mesh:
    its block where the data extent divides the batch (the reference's
    batch split), else all of them (each data rank serves every row)."""
    lay = _as_layout(layout)
    if lay is None or batch % lay.D:
        return slice(0, batch)
    n = batch // lay.D
    return slice(lay.d * n, (lay.d + 1) * n)


def make_prefill_step(model):
    """``prefill_step(caches, batch) -> (logits (B, V), caches)``: the
    prompt through the model, unembedding only the last position.  On a
    mesh ``batch`` holds the rows this rank serves (``served_rows``) and
    ``caches`` its blocks (``init_cache(layout=)``); the logits are over
    the full vocabulary (the padded one where ``tp_pad_config`` pads)."""

    def prefill_step(caches, batch):
        tokens = batch["tokens"]
        h, caches = model(tokens, mode="prefill", caches=caches,
                          cache_len=None, return_hidden=True,
                          **_modality(model.cfg, batch))
        # (B, 1, d) @ (d, V), not (B, S, V)
        h = model.last_position(h, tokens.shape[1])
        return model.unembed(h)[:, 0], caches

    return prefill_step


def make_decode_step(model):
    """``decode_step(caches, token (B, 1), cache_len, batch=None) ->
    (logits (B, V), caches)``; ``batch`` carries the modality inputs.  On
    a mesh as ``make_prefill_step``."""

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


def _as_layout(mesh):
    """The ``tensor_parallel.Layout`` of ``mesh`` (a ``DeviceMesh``, a
    Layout, or None)."""
    if mesh is None or isinstance(mesh, tp.Layout):
        return mesh
    return tp.Layout(mesh)


def _global_mean(loss_sum, loss_mask, lay):
    """``loss_sum`` (this rank's rows) over the global batch's mask count,
    summed over ``data`` forward (identity backward: each rank's gradient
    is its share of the global mean).  With ``data`` of 1 the operations
    of ``next_token_loss``, bit for bit."""
    count = tp.all_reduce(loss_mask.sum(), lay.data)
    return tp.reduce(loss_sum / torch.clamp_min(count, 1.0), lay.data)


def _plain_loss(h, w, transpose_w, targets, loss_mask, lay):
    """The plain loss over the whole unembed (gathered over ``model`` from
    this rank's block): every rank of a row computes the same loss."""
    if lay is None:
        return next_token_loss(_unembed_logits(h, w, transpose_w), targets,
                               loss_mask)
    if lay.M > 1:
        w = tp.gather_whole(w, lay.model, 0 if transpose_w else 1)
    logits = _unembed_logits(h, w, transpose_w).float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    return _global_mean(((logz - tgt) * loss_mask).sum(), loss_mask, lay)


def _ce_chunk(hb, w, tb, mb, transpose_w, v0, group):
    """Masked loss sum of one chunk of tokens against this rank's vocab
    block ``[v0, v0 + V/M)``: a stop-gradient max reduced by max, the
    summed exp by sum, the target logit from the block that owns it."""
    logits = _unembed_logits(hb, w, transpose_w).float()
    v_loc = logits.shape[-1]
    mx = tp.all_reduce(logits.detach().amax(dim=-1), group, "max")
    se = tp.reduce(torch.exp(logits - mx[:, None]).sum(dim=-1), group)
    lse = torch.log(se) + mx
    owned = (tb >= v0) & (tb < v0 + v_loc)
    idx = torch.clamp(tb - v0, 0, v_loc - 1)
    tgt_l = logits.gather(-1, idx[:, None])[:, 0]
    tgt = tp.reduce(torch.where(owned, tgt_l, torch.zeros_like(tgt_l)),
                    group)
    return ((lse - tgt) * mb).sum()


def vocab_parallel_ce(h, w, transpose_w, targets, loss_mask, *, mesh=None,
                      seq_sharded=False):
    """The reference's vocab-parallel cross-entropy, logits = h @ (W.T if
    ``transpose_w`` else W).  Without a mesh, the plain loss over the full
    logits.  On a mesh (a ``DeviceMesh`` or a ``tensor_parallel.Layout``)
    each rank passes its rows of ``targets`` and ``loss_mask`` (B, S), of
    ``h`` (its block of the sequence too with ``seq_sharded``) and its
    vocab block of ``w``; every rank gets the loss of the global batch.

    The vocab-sharded branch runs where the reference's does (its
    ``usable``: S and V divided by ``model``, the batch by the data axes,
    which the rows passed here already are) with a ``model`` axis past 1:
    tokens whole over ``model`` (``h`` gathered, or marked for the sum of
    its gradient), chunks of ``CE_CHUNK`` tokens each under
    ``torch.utils.checkpoint``, this rank's logits only.  Elsewhere the
    plain loss over the unembed gathered over ``model`` (a ``model`` axis
    of 1: the plain loss itself, whose math the sharded branch computes;
    so a mesh of one gives the single-device bits).
    """
    lay = _as_layout(mesh)
    if lay is None:
        return _plain_loss(h, w, transpose_w, targets, loss_mask, None)
    B, S = targets.shape
    V = (w.shape[0] if transpose_w else w.shape[1]) * lay.M
    if not (lay.M > 1 and S % lay.M == 0 and V % lay.M == 0):
        if seq_sharded:
            h = tp.gather(h, lay.model)
        return _plain_loss(h, w, transpose_w, targets, loss_mask, lay)
    h = tp.gather(h, lay.model) if seq_sharded else tp.copy(h, lay.model)
    T = B * S
    hf = h.reshape(T, h.shape[-1])
    tf = targets.reshape(T).long()
    mf = loss_mask.reshape(T)
    v0 = lay.m * (V // lay.M)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, T, CE_CHUNK):
        total = total + checkpoint(
            _ce_chunk, hf[c:c + CE_CHUNK], w, tf[c:c + CE_CHUNK],
            mf[c:c + CE_CHUNK], transpose_w, v0, lay.model,
            use_reentrant=False, preserve_rng_state=False)
    return _global_mean(total, loss_mask, lay)


def batch_to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors on ``device``: tokens and
    targets as int64, the rest float32."""
    out = {}
    for k, v in batch.items():
        dt = torch.int64 if k in ("tokens", "targets") else torch.float32
        t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        out[k] = t.to(device=device, dtype=dt)
    return out


def train_loss(model, batch, layout=None):
    """The reference's training loss of ``batch`` (tensors on the model's
    device; on a mesh, this rank's rows): the final hidden states
    unembedded, the next-token loss of the global batch."""
    cfg = model.cfg
    lay = _as_layout(layout)
    h, _ = model(batch["tokens"], mode="train", return_hidden=True,
                 **_modality(cfg, batch))
    w, transpose_w = model.unembed_weights()
    if getattr(cfg, "parallelism", "tp") == "fsdp":
        # the reference's FSDP branch: the plain loss, the unembed gathered
        return _plain_loss(h, w, transpose_w, batch["targets"],
                           batch["loss_mask"], lay)
    sp = lay is not None and lay.seq_parallel(cfg, batch["tokens"].shape[1])
    return vocab_parallel_ce(h, w, transpose_w, batch["targets"],
                             batch["loss_mask"], mesh=lay, seq_sharded=sp)


def loss_and_grads(model, params: dict, batch: dict, layout=None):
    """(loss, {name: float32 gradient}) of ``batch`` with respect to
    ``params`` (``trainable_params``, gradients on), the loss detached;
    a parameter the loss does not reach gets zeros, as under
    ``jax.grad``.  On a mesh the gradients are this rank's share (
    ``reduce_grads`` completes them)."""
    for p in params.values():
        p.grad = None
    loss = train_loss(model, batch, layout)
    loss.backward()
    grads = {k: p.grad.float() if p.grad is not None
             else torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    for p in params.values():
        p.grad = None
    return loss.detach(), grads


def split_leaves(cfg) -> set:
    """Names (the model state's) of the parameters whose spec splits
    them over ``model``."""
    defs = param_defs(cfg)
    split = {k for k, d in common.flatten(defs).items()
             if any("model" in common.spec_axes(d.spec, i)
                    for i in range(len(d.shape)))}
    return {name for name in transformer.state_shapes(defs)
            if _stacked_name(name) in split}


def _stacked_name(name: str) -> str:
    """The reference's leaf name of a model state's name (the layer index
    of a stacked subtree dropped)."""
    parts = name.split(".")
    if parts[0] in transformer.STACKED:
        del parts[1]
    return ".".join(parts)


# whole leaves used inside a tensor-parallel region (their stacked names'
# endings, each module naming its own): each rank's gradient covers only
# its heads, experts or block of hd, with or without sequence parallelism
REGION_LEAVES = tuple(f"{block}.{leaf}" for block, names in (
    ("attn", attention.MLA_REGION_WHOLE), ("ffn", moe.REGION_WHOLE),
    ("mixer", ssm.REGION_WHOLE), ("mixer", xlstm.REGION_WHOLE))
    for leaf in names)


def partial_leaves(cfg, layout, seq_len: int) -> list:
    """Names, in the model state's order (every rank calls the same
    collectives in turn), of the whole (unsplit) leaves whose gradient on a
    tensor-parallel ``layout`` is partial, to be summed over ``model``:
    those used inside a split region (``REGION_LEAVES``) always, and the
    others (norms, ``b_out``, ``pos_*``) where their stream is
    sequence-parallel (each rank saw its block of the sequence; whisper's
    encoder leaves by the frames, ``seq_len`` the tokens)."""
    lay = _as_layout(layout)
    if lay is None or lay.M == 1:
        return []
    split = split_leaves(cfg)
    sp = lay.seq_parallel(cfg, seq_len)
    enc_sp = cfg.family == "audio" and lay.seq_parallel(
        cfg, cfg.n_audio_frames)
    out = []
    for k in transformer.state_shapes(param_defs(cfg)):
        if k in split:
            continue
        enc = k.startswith(("enc_layers.", "enc_norm", "pos_enc"))
        if _stacked_name(k).endswith(REGION_LEAVES) or (enc_sp if enc
                                                        else sp):
            out.append(k)
    return out


def reduce_grads(grads: dict, cfg, layout, seq_len: int) -> dict:
    """This rank's gradients completed in place: summed over ``data``, and
    the whole leaves whose gradient is partial on a tensor-parallel mesh
    (``partial_leaves``: those inside a split region, and the others where
    their stream was sequence-parallel) summed over ``model``.  The split
    leaves' gradients are their blocks', complete as they are."""
    lay = _as_layout(layout)
    for g in grads.values():
        collectives.all_reduce(g, lay.data)
    for k in partial_leaves(cfg, lay, seq_len):
        collectives.all_reduce(grads[k], lay.model)
    return grads


def check_moe_groups(rows: int, seq_len: int, n_data: int) -> None:
    """Raise unless a rank's ``rows`` x ``seq_len`` tokens are whole token
    groups of the reference's MoE over the global batch (``moe.GROUP_SIZE``
    tokens, or all of them): a rank groups its own tokens, the reference
    the global ones, and the capacity (and so which tokens drop) is a
    group's."""
    local = rows * seq_len
    group = min(moe.GROUP_SIZE, local * n_data)
    if not moe.whole_groups(local, n_data):
        raise ValueError(
            f"MoE over {n_data} data ranks: a rank's {local} tokens are "
            f"not whole groups of the global batch's {group}; choose a "
            "batch whose rows a rank holds make whole groups")


def make_train_step(model, opt_cfg: adamw.AdamWConfig, *,
                    microbatches: int = 1, layout=None):
    """``train_step(opt_state, batch) -> (opt_state, {"loss", "grad_norm",
    "lr"})``: the next-token loss of ``batch`` (numpy arrays or tensors,
    put on the model's device), its gradients, and one AdamW update of the
    model's parameters in place; the metrics are 0-d tensors on the
    device.  With ``microbatches`` the batch is cut into that many row
    blocks, and the gradients (summed in float32) and the loss are
    averaged over them, as the reference's scan does.  Turns the model's
    parameters' gradients on.

    On a mesh (``layout``) ``batch`` holds this rank's rows (for
    microbatches, its rows of each microbatch in turn: ``Trainer`` cuts
    them so), the gradients are completed by ``reduce_grads`` and the
    norm sums each split leaf's squares over ``model``: every rank gets
    the same metrics."""
    model.requires_grad_(True)
    params = trainable_params(model)
    dev = next(iter(params.values())).device
    lay = _as_layout(layout)
    split = split_leaves(model.cfg) if lay is not None and lay.M > 1 \
        else set()

    def train_step(opt_state, batch):
        batch = batch_to_device(batch, dev)
        if lay is not None and model.cfg.family == "moe" and lay.D > 1:
            check_moe_groups(batch["tokens"].shape[0] // microbatches,
                             batch["tokens"].shape[1], lay.D)
        if microbatches == 1:
            loss, grads = loss_and_grads(model, params, batch, lay)
        else:
            n = batch["tokens"].shape[0] // microbatches
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = None
            for i in range(microbatches):
                l_i, g_i = loss_and_grads(model, params, {
                    k: v[i * n:(i + 1) * n] for k, v in batch.items()}, lay)
                loss = loss + l_i
                if grads is None:
                    grads = g_i
                else:
                    for k, g in g_i.items():
                        grads[k].add_(g)
            grads = {k: g.div_(microbatches) for k, g in grads.items()}
            loss = loss / microbatches
        if lay is not None:
            reduce_grads(grads, model.cfg, lay, batch["tokens"].shape[1])
        _, opt_state, om = adamw.adamw_update(
            opt_cfg, grads, opt_state, params,
            split=split, group=lay.model if split else None)
        return opt_state, {"loss": loss, **om}

    return train_step


# ---------------------------------------------------------------------------
# sharding helpers and abstract inputs for the dry-run
# ---------------------------------------------------------------------------

def _extent(mesh, axes) -> int:
    """Cards along ``axes`` (an axis name, a tuple of them, None: 1)."""
    if axes is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else axes
    return math.prod(mesh.shape[a] for a in axes if a is not None)


def _meta(shape, dtype, spec):
    t = torch.empty(shape, dtype=dtype, device="meta")
    t.spec = tuple(spec)
    return t


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _dp_axes(mesh, cfg=None) -> tuple:
    """Axes that carry the batch.  Under FSDP the ``model`` axis becomes a
    second data axis (parameters are gathered per use instead of
    activations split over ``model``)."""
    names = mesh.axis_names if mesh is not None else ("data",)
    axes = ("pod", "data", "model") \
        if (cfg is not None and getattr(cfg, "parallelism", "tp") == "fsdp") \
        else ("pod", "data")
    return tuple(a for a in axes if a in names) or (None,)


def fsdp_param_sharding(shape, mesh) -> tuple:
    """ZeRO-3's spec: the first dim divisible by the largest group of
    axes, cascading to smaller groups; whole where nothing divides."""
    full = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
    for k in range(len(full), 0, -1):
        axes = full[-k:]
        ext = _extent(mesh, axes)
        for i, dim in enumerate(shape):
            if dim % ext == 0 and dim >= ext:
                spec = [None] * len(shape)
                spec[i] = axes if len(axes) > 1 else axes[0]
                return tuple(spec)
    return ()


def input_specs(cfg, shape, mesh):
    """Meta-tensor stand-ins (``.spec`` each) for every model input of a
    cell: (batch dict, caches or None, cache_len or None, token or
    None)."""
    dp = _dp_axes(mesh, cfg)
    B, S = shape.global_batch, shape.seq_len
    # the batch's split: the largest suffix of the data axes dividing B
    dp_b = None
    for k in range(len(dp), 0, -1):
        axes = dp[-k:]
        ext = _extent(mesh, axes)
        if ext and B % ext == 0:
            dp_b = axes if len(axes) > 1 else axes[0]
            break

    def tok(shape_):
        return _meta(shape_, torch.int32, (dp_b, None))

    batch = {}
    if cfg.family == "vlm":
        batch["image_embeds"] = _meta((B, cfg.n_image_tokens, cfg.d_model),
                                      torch.float32, (dp_b, None, None))
    if cfg.family == "audio":
        batch["audio_embeds"] = _meta((B, cfg.n_audio_frames, cfg.d_model),
                                      torch.float32, (dp_b, None, None))
    if shape.kind == "train":
        batch["tokens"] = tok((B, S))
        batch["targets"] = tok((B, S))
        batch["loss_mask"] = _meta((B, S), torch.float32, (dp_b, None))
        return batch, None, None, None
    caches = common.abstract_params(cache_specs(cfg, B, S, mesh, shape.kind),
                                    mesh, dtype=torch.bfloat16)
    if shape.kind == "prefill":
        batch["tokens"] = tok((B, S))
        return batch, caches, None, None
    # decode: one new token against an S-long cache
    return batch, caches, _meta((), torch.int32, ()), tok((B, 1))


def _reshard_cache_seq(cache_defs, s_max: int, dp):
    """Move the ``data`` split from the batch dim to the ``s_max`` dim of
    every cache tensor that has one (KV caches; recurrent states are
    untouched)."""
    def rewrite(d: common.ParamDef):
        if s_max not in d.shape:
            return d
        i = d.shape.index(s_max)
        spec = list(d.spec) + [None] * (len(d.shape) - len(d.spec))
        spec = [None if s == "data" or s == dp else s for s in spec]
        spec[i] = dp
        return common.ParamDef(d.shape, tuple(spec), d.dtype, d.init_scale)
    return common.tree_defs_map(rewrite, cache_defs)


def sanitize_specs(defs, mesh):
    """Drop the split of any dim its axes do not divide (the batch dim of
    recurrent state caches when the global batch is below the data
    axis)."""
    def fix(d: common.ParamDef):
        spec = list(d.spec) + [None] * (len(d.shape) - len(d.spec))
        out = [None if (s is not None and dim % _extent(mesh, s) != 0)
               else s for dim, s in zip(d.shape, spec)]
        return common.ParamDef(d.shape, tuple(out), d.dtype, d.init_scale)
    return common.tree_defs_map(fix, defs)


def zero1_sharding(sds, mesh) -> tuple:
    """ZeRO-1: an optimizer moment (a meta tensor with ``.spec``) also
    split over the data axes, on its first free dim divisible by their
    extent; else over ``data`` alone where that divides; else as it
    was."""
    spec0 = tuple(getattr(sds, "spec", ()))
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if not dp:
        return spec0
    dp_size = _extent(mesh, dp)
    spec = list(spec0) + [None] * (len(sds.shape) - len(spec0))
    for i, (dim, s) in enumerate(zip(sds.shape, spec)):
        if s is None and dim % dp_size == 0 and dim > 1:
            spec[i] = dp
            return tuple(spec)
    d_size = mesh.shape.get("data", 1)
    for i, (dim, s) in enumerate(zip(sds.shape, spec)):
        if s is None and dim % d_size == 0 and dim > 1:
            spec[i] = "data"
            return tuple(spec)
    return spec0


def abstract_state(cfg, mesh, *, with_opt=True, dtype=None, zero1=True):
    """Abstract (params, opt_state) of a train step: meta tensors with
    their ``.spec``, in the reference's layout (stacked layers) and
    dtypes (parameters in bf16 for a bf16 config, float32 moments)."""
    defs = param_defs(cfg)
    pdt = dtype or (torch.bfloat16 if cfg.dtype == "bfloat16"
                    else torch.float32)
    fsdp = getattr(cfg, "parallelism", "tp") == "fsdp"
    if fsdp:
        params = common.tree_defs_map(
            lambda d: _meta(d.shape, pdt, fsdp_param_sharding(d.shape,
                                                              mesh)), defs)
    else:
        params = common.abstract_params(defs, mesh, dtype=pdt)
    if not with_opt:
        return params, None

    def moment_like(t):
        # fsdp params are split already: the moments keep their layout
        spec = t.spec if fsdp or not zero1 else zero1_sharding(t, mesh)
        return _meta(t.shape, torch.float32, spec)
    opt_state = adamw.AdamWState(m=_tree_map(moment_like, params),
                                 v=_tree_map(moment_like, params),
                                 count=_meta((), torch.int32, ()))
    return params, opt_state
