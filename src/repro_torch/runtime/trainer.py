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

A mesh (``mesh=``) is not ported: sharded training is the slice after the
scan kernels (ROADMAP Queue 1 item 6), and passing one raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import lm, transformer
from repro_torch.optim import adamw
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
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): sharded training comes with its own "
                "slice (ROADMAP Queue 1 item 6, after the scan kernels)")
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
        self.model = lm.build_model(self.cfg, generator=gen)
        self.train_step = lm.make_train_step(
            self.model, self.opt_cfg, microbatches=self.tcfg.microbatches)
        params = lm.trainable_params(self.model)
        return params, adamw.adamw_init(params), 0

    def checkpoint_tree(self, params: dict, opt_state) -> dict:
        """The checkpoint's tree in the reference's layout (stacked
        layers), over the live tensors (no copy)."""
        defs = lm.param_defs(self.cfg)
        return {"params": transformer.restack(defs, params),
                "opt": adamw.AdamWState(
                    m=transformer.restack(defs, opt_state.m),
                    v=transformer.restack(defs, opt_state.v),
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

    def _step(self, opt_state, step: int):
        opt_state, metrics = self.train_step(opt_state,
                                             self.pipeline.batch_at(step))
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
        with (open(self.tcfg.log_path, "a") if self.tcfg.log_path
              else contextlib.nullcontext()) as log_f:
            for step in range(start, self.tcfg.steps):
                (opt_state, (loss, gnorm, lr)), step_s = timed(
                    self._step, opt_state, step)
                losses.append(loss)
                if log_f:
                    log_f.write(json.dumps({
                        "step": step, "loss": loss, "grad_norm": gnorm,
                        "lr": lr, "step_s": round(step_s, 4)}) + "\n")
                    log_f.flush()
                if (step + 1) % self.tcfg.ckpt_every == 0 \
                        or step + 1 == self.tcfg.steps:
                    self.ckpt.save(step + 1,
                                   self.checkpoint_tree(params, opt_state),
                                   metadata={"next_step": step + 1,
                                             "loss": loss})
            self.ckpt.wait()
        return params, opt_state, losses
