"""Distributed online learning via truncated gradient (paper §8.1).

Langford, Li & Zhang (2009) truncated-gradient updates for L1; distributed
per Agarwal et al. (2014): example-split over M shards, each shard runs a
sequential online pass, weights are averaged across shards after every pass
and used as the warmstart for the next (the paper's competing configuration
for Figs. 2-4; with lam1=0 it is the online-learning stage of the L-BFGS
combination for Figs. 5-6).

Mirrors ``repro.baselines.online_tg``.  An epoch, the M shards' sequential
passes, is one launch of the CUDA kernel ``online_tg`` on the card
(``ops.online_tg_epoch``); the objective after it is K1's loss sum.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import glm as glm_lib
from repro_torch.device import as_float32, read_f_nnz, resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class OnlineTGConfig:
    lam1: float = 0.0
    lam2: float = 0.0
    n_shards: int = 4
    epochs: int = 20
    lr: float = 0.25
    lr_decay_power: float = 0.6   # eta_t = lr / t^power, t = global step
    family: str = "logistic"


def objective(fam, y, X, w, lam1, lam2):
    """f(w) = sum_i l(y_i, x_i . w) + lam1 |w|_1 + lam2/2 |w|^2, a 0-d
    tensor (the loss from ``ops.glm_stats``)."""
    loss, _, _ = ops.glm_stats(y, X @ w, fam)
    return torch.sum(loss) + glm_lib.penalty(w, lam1, lam2)


def nnz_of(w):
    return torch.sum(torch.abs(w) > 0)


def fit_online_tg(X, y, cfg: OnlineTGConfig, seed=0, device=None):
    """Returns (beta, history dict with per-epoch objective/nnz).
    ``device=None`` is the card."""
    dev = resolve_device(device)
    Xd, yd = as_float32(X, dev), as_float32(y, dev)
    n, p = Xd.shape
    rng = np.random.default_rng(seed)
    M = cfg.n_shards
    n_per = n // M
    perm = torch.from_numpy(rng.permutation(n)[: n_per * M]).to(dev)
    X_sh = Xd[perm].reshape(M, n_per, p)
    y_sh = yd[perm].reshape(M, n_per)
    del perm

    fam = glm_lib.resolve_family(cfg.family)
    w = torch.zeros(p, dtype=torch.float32, device=dev)
    f, _ = read_f_nnz(objective(fam, yd, Xd, w, cfg.lam1, cfg.lam2),
                      nnz_of(w))
    hist = {"f": [f], "nnz": [0]}
    t = np.float32(1.0)
    for _ in range(cfg.epochs):
        w = ops.online_tg_epoch(X_sh, y_sh, w, t, fam, lr=cfg.lr,
                                power=cfg.lr_decay_power, lam1=cfg.lam1,
                                lam2=cfg.lam2)
        t = np.float32(t + np.float32(n_per))
        f, nnz = read_f_nnz(objective(fam, yd, Xd, w, cfg.lam1, cfg.lam2),
                            nnz_of(w))
        hist["f"].append(f)
        hist["nnz"].append(nnz)
    return w.cpu().numpy(), hist
