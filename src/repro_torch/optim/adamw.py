"""AdamW with decoupled weight decay, global-norm clipping and a linear
warmup + cosine decay schedule.  Moments are kept in float32 whatever the
parameter dtype.

A port of the JAX package's ``repro.optim.adamw``, function for function,
over dicts of tensors ({name: tensor}) in place of pytrees; a dict's order
is its leaf order (the reference's ``jax.tree.leaves`` order, as
``models.lm.trainable_params`` gives it).  The formulas and their order
are the reference's: the global norm summed in float32 leaf by leaf, the
clip scale ``min(1, clip_norm / max(gnorm, 1e-9))``, ``count + 1`` before
the schedule, bias corrections from ``b ** count``, the weight decay
decoupled.  ``adamw_update`` runs in place (the parameters, the moments
and the gradients, which it scales), so a step holds no second copy of
the parameters; the scalars it computes stay on the device.

On a mesh each rank holds blocks of the parameters: the global gradient
norm adds each split leaf's squared block over its ``group`` (the mesh's
``model`` group) and counts each whole leaf once, then sums the leaves in
the reference's order; without split leaves it is the single-device sum,
bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.sharding import collectives


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: torch.Tensor          # () int32, on the parameters' device


def adamw_init(params: dict) -> AdamWState:
    """Zero float32 moments for every parameter, and a count of 0."""
    dev = next(iter(params.values())).device
    return AdamWState(
        m={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()},
        v={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()},
        count=torch.zeros((), dtype=torch.int32, device=dev))


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an integer tensor or a host int), a
    float32 tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) \
        * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(grads: dict, split=(), group=None):
    """The gradients' global norm: each leaf's float32 sum of squares, a
    leaf named in ``split`` summed over ``group`` (one call for them all),
    the leaves added in order."""
    sq = {k: g.float().square().sum() for k, g in grads.items()}
    names = [k for k in sq if k in split]
    if names:
        sq.update(zip(names, collectives.all_reduce_many(
            [sq[k] for k in names], group)))
    gnorm = None
    for s in sq.values():             # the reference's leaf order
        gnorm = s if gnorm is None else gnorm + s
    return torch.sqrt(gnorm)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, state: AdamWState,
                 params: dict, *, split=(), group=None):
    """One AdamW step: (params, state, {"grad_norm", "lr"}), the parameters
    and moments updated in place (``grads`` is scaled in place too); the
    metrics are 0-d tensors on the device.  ``split``: the names of the
    leaves split over ``group`` (``global_norm``)."""
    gnorm = global_norm(grads, split, group)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    count = state.count + 1
    lr = schedule(cfg, count)
    b1c = 1.0 - torch.pow(cfg.b1, count.float())
    b2c = 1.0 - torch.pow(cfg.b2, count.float())
    for k, g in grads.items():
        p, m, v = params[k], state.m[k], state.v[k]
        g = g.float().mul_(scale)
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        step = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        upd = step.add_(p.float(), alpha=cfg.weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(upd)
        else:
            p.copy_(p.float().sub_(upd))
    return params, AdamWState(state.m, state.v, count), \
        {"grad_norm": gnorm, "lr": lr}
