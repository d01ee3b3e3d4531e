"""LM training runtime: the train step on the card, checkpoints and
restart.

A port of the JAX package's ``repro.runtime.trainer``:
  * build the model and the optimizer state, or restore them from the
    latest checkpoint (crash or preemption recovery is running the same
    command again);
  * drive ``models.lm.make_train_step`` over the deterministic
    ``TokenPipeline`` (a pure function of the step, so a resumed run reads
    the same batches);
  * checkpoint every ``ckpt_every`` steps and at the last one;
  * a JSONL log of loss, gradient norm, learning rate and step seconds.

Weights are drawn on the device from a ``torch.Generator`` seeded with
``seed`` (``common.init_params``: float32, as the reference's trainer
draws them).  The model holds its parameters and the step updates them in
place, so ``init_state`` and ``restore_or_init`` return the model's
parameters ({name: parameter}, ``lm.trainable_params``).  A checkpoint
keeps the reference's layout, ``{"params", "opt": AdamWState(m, v,
count)}`` with the layers stacked ``(L, ...)`` (``transformer.restack``),
so a checkpoint of either package's trainer resumes in the other's; a
restore fills the parameters and moments in place.  Each step makes one
batched device-to-host read (loss, gradient norm, learning rate).

On a mesh (``mesh=``: a (data, model) ``DeviceMesh`` of
``dist.bootstrap.make_dist_mesh``, one process a rank) the trainer runs
the reference's step as GSPMD runs it on its mesh: the parameters and the
moments in the layout of their ``ParamDef`` specs (every rank draws the
full weights from the same generator and keeps its blocks, so a sharded
run starts from the single-device run's weights), the batch's rows split
over ``data`` and whole over ``model``, the gradients summed over
``data``, the vocab-sharded loss under ``parallelism="tp"`` and the plain
loss over the gathered unembed under ``"fsdp"`` (``models.lm``,
``sharding.tensor_parallel``).  A ``model`` axis past 1 runs tensor
parallelism for every family (``models.transformer``); a dimension the
axis does not divide raises ``ValueError`` (``transformer.check_layout``);
serving on such an axis is ``launch.serve.generate`` on a model built
with the layout.  Every rank reads the
metrics, which are the same on each; process 0 writes the log.  A checkpoint holds the full arrays in the reference's
layout, gathered over ``model`` on every rank and written by process 0;
a restore reads each rank's blocks from them, so a checkpoint resumes on
another mesh, on one card, and in the other package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.dist import bootstrap
from repro_torch.models import common, lm, transformer
from repro_torch.optim import adamw
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.timing import timed


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = "checkpoints"
    keep_last: int = 3
    async_save: bool = True
    log_path: Optional[str] = None
    seed: int = 0
    batch: int = 8
    seq_len: int = 128
    microbatches: int = 1


class Trainer:
    def __init__(self, arch_cfg, opt_cfg: adamw.AdamWConfig,
                 tcfg: TrainerConfig, mesh=None, *, device=None):
        self.mesh = mesh
        self.layout = None if mesh is None else tp.Layout(mesh)
        transformer.check_layout(arch_cfg, self.layout)
        if self.layout is not None and \
                tcfg.batch % (self.layout.D * tcfg.microbatches):
            raise ValueError(
                f"a batch of {tcfg.batch} rows does not split into "
                f"{tcfg.microbatches} microbatches over {self.layout.D} "
                "data ranks")
        self.cfg = arch_cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.pipeline = TokenPipeline(arch_cfg.vocab_size, tcfg.batch,
                                      tcfg.seq_len, seed=tcfg.seed)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir,
                                      keep_last=tcfg.keep_last,
                                      async_save=tcfg.async_save)
        self.model = None
        self.train_step = None

    # ------------------------------------------------------------ state

    def init_state(self, generator: Optional[torch.Generator] = None):
        """(params, opt_state, 0): a model with weights drawn from
        ``generator`` (default: seeded with ``seed`` on the device), its
        train step, and zero moments."""
        gen = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        self.model = None           # free the last model before drawing
        self.model = lm.build_model(self.cfg, generator=gen,
                                    layout=self.layout)
        self.train_step = lm.make_train_step(
            self.model, self.opt_cfg, microbatches=self.tcfg.microbatches,
            layout=self.layout)
        params = lm.trainable_params(self.model)
        return params, adamw.adamw_init(params), 0

    def checkpoint_tree(self, params: dict, opt_state) -> dict:
        """The checkpoint's tree in the reference's layout (stacked
        layers), over the live tensors (no copy); under a tensor-parallel
        layout, restore templates of each rank's blocks."""
        defs = lm.param_defs(self.cfg)
        lay = self.model.layout
        return {"params": transformer.restack(defs, params, lay),
                "opt": adamw.AdamWState(
                    m=transformer.restack(defs, opt_state.m, lay),
                    v=transformer.restack(defs, opt_state.v, lay),
                    count=opt_state.count)}

    def save_tree(self, params: dict, opt_state) -> dict:
        """The tree a save writes: ``checkpoint_tree``, or under a
        tensor-parallel layout the full arrays gathered over ``model`` to
        the host of every rank (collective: every rank calls it)."""
        lay = self.model.layout
        if lay is None:
            return self.checkpoint_tree(params, opt_state)
        defs = lm.param_defs(self.cfg)
        return {"params": gathered(defs, params, lay),
                "opt": adamw.AdamWState(m=gathered(defs, opt_state.m, lay),
                                        v=gathered(defs, opt_state.v, lay),
                                        count=opt_state.count)}

    def restore_or_init(self):
        """(params, opt_state, next step): the latest checkpoint restored
        into a fresh state in place, or the fresh state at step 0."""
        params, opt_state, _ = self.init_state()
        if self.ckpt.latest_step() is None:
            return params, opt_state, 0
        _, md = self.ckpt.restore(self.checkpoint_tree(params, opt_state),
                                  in_place=True)
        return params, opt_state, int(md["next_step"])

    # ------------------------------------------------------------- run

    def rank_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch: of each microbatch in turn
        its block over ``data`` (the reference's microbatches are row
        blocks of the global batch)."""
        lay = self.layout
        if lay is None or lay.D == 1:
            return batch
        mb = self.tcfg.microbatches
        n = batch["tokens"].shape[0] // mb
        w = n // lay.D
        rows = np.concatenate([np.arange(i * n + lay.d * w,
                                         i * n + (lay.d + 1) * w)
                               for i in range(mb)])
        return {k: v[rows] for k, v in batch.items()}

    def step_at(self, opt_state, step: int):
        """One step of the run on this rank's rows of the pipeline's batch
        at ``step``: (opt_state, [loss, grad norm, lr] on the host)."""
        opt_state, metrics = self.train_step(
            opt_state, self.rank_batch(self.pipeline.batch_at(step)))
        # one batched device-to-host read a step (lint rule SYNC001); it
        # also ends the step's timing at the card's work, not its dispatch
        host = torch.stack([metrics[k].float() for k in
                            ("loss", "grad_norm", "lr")]).tolist()
        return opt_state, host

    def run(self):
        """Train from the latest checkpoint (or from scratch) to ``steps``:
        (params, opt_state, this run's losses)."""
        params, opt_state, start = self.restore_or_init()
        losses = []
        logs = self.tcfg.log_path and bootstrap.context().is_coordinator
        with (open(self.tcfg.log_path, "a") if logs
              else contextlib.nullcontext()) as log_f:
            for step in range(start, self.tcfg.steps):
                (opt_state, (loss, gnorm, lr)), step_s = timed(
                    self.step_at, opt_state, step)
                losses.append(loss)
                if log_f:
                    log_f.write(json.dumps({
                        "step": step, "loss": loss, "grad_norm": gnorm,
                        "lr": lr, "step_s": round(step_s, 4)}) + "\n")
                    log_f.flush()
                if (step + 1) % self.tcfg.ckpt_every == 0 \
                        or step + 1 == self.tcfg.steps:
                    self.ckpt.save(step + 1,
                                   self.save_tree(params, opt_state),
                                   metadata={"next_step": step + 1,
                                             "loss": loss})
            self.ckpt.wait()
        return params, opt_state, losses


def gathered(defs, state: dict, layout) -> dict:
    """The reference's tree (stacked layers) of full host arrays of a
    model state holding this rank's blocks: each split leaf gathered over
    ``model`` (collective)."""
    def full(t, spec):
        dims = [i for i in range(t.dim())
                if "model" in common.spec_axes(spec, i)]
        if not dims:
            return t.detach().to("cpu", copy=True).numpy()
        i = dims[0]
        arr = bootstrap.gather_to_host(t.detach().movedim(i, 0).contiguous(),
                                       layout.model)
        return np.moveaxis(arr, 0, i)

    tree = {}
    for key in sorted(defs):
        sub = defs[key]
        if key in transformer.STACKED:
            n = next(iter(common.flatten(sub).values())).shape[0]
            tree[key] = common.unflatten({
                name: np.stack([full(state[f"{key}.{i}.{name}"], d.spec[1:])
                                for i in range(n)])
                for name, d in common.flatten(sub).items()})
        elif isinstance(sub, dict):
            tree[key] = common.unflatten({
                name: full(state[f"{key}.{name}"], d.spec)
                for name, d in common.flatten(sub).items()})
        else:
            tree[key] = full(state[key], sub.spec)
    return tree
