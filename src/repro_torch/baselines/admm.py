"""ADMM with sharing for feature-split L1/L2 logistic regression.

Boyd et al. 2011, sections 7.3 + 8.3.1/8.3.3, including the correction the
paper points out (footnote 3): the z̄-update quadratic coefficient is ρN/2,
not ρ/2.  The x-update LASSO is solved with Shooting (cyclic CD) as in the
paper's comparison.

Mirrors ``repro.baselines.admm``.  The M feature blocks are carried in one
device tensor, column-major, (M, p_block, n); the x-update of all blocks
(all Shooting passes) is one launch of the CUDA kernel ``admm_shooting`` on
the card (``ops.admm_shooting``), and the z̄ Newton steps and the objective
go through ``ops.glm_stats`` (K1).  The sharing structure (only A x̄ crosses
blocks) is that of M nodes, which is what makes this "another way to do
distributed coordinate descent" (paper §8.1).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import glm as glm_lib
from repro_torch.device import as_float32, read_f_nnz, resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    lam1: float = 0.0
    lam2: float = 0.0
    rho: float = 1.0
    n_blocks: int = 4
    shooting_passes: int = 3
    newton_iters: int = 12
    max_outer: int = 100
    family: str = "logistic"


def _block_margins(At, x):
    """(M, n) A_m x_m of every block."""
    return torch.bmm(x[:, None, :], At)[:, 0, :]


def _admm_step(At, y, x_blocks, zbar, u, cfg: ADMMConfig, col_sq):
    """One outer iteration; returns (x, zbar, u, f, nnz), f and nnz 0-d
    device tensors.  ``col_sq`` (M, p_block) are the blocks' squared column norms
    (A is fixed, so they are formed once)."""
    M = At.shape[0]
    fam = glm_lib.resolve_family(cfg.family)

    Ax = _block_margins(At, x_blocks)                 # (M, n)
    Ax_bar = torch.mean(Ax, dim=0)

    # ---- x-update: M independent LASSOs (the "nodes"), one launch
    v = Ax + (zbar - Ax_bar - u)[None, :]
    x_new = ops.admm_shooting(At, x_blocks, v, col_sq, cfg.lam1 / cfg.rho,
                              cfg.lam2 / cfg.rho, cfg.shooting_passes)

    # ---- z̄-update: n independent 1-D problems, Newton (ρN/2 fix applied)
    Ax_new = _block_margins(At, x_new)
    Ax_bar_new = torch.mean(Ax_new, dim=0)
    a = Ax_bar_new + u
    z = zbar
    for _ in range(cfg.newton_iters):
        _, s, w = ops.glm_stats(y, M * z, fam)   # l'(Mz) = -s, l''(Mz) = w
        grad = -M * s + M * cfg.rho * (z - a)
        hess = M * M * w + M * cfg.rho
        z = z - grad / hess

    u_new = u + Ax_bar_new - z

    # true objective on the consensus iterate
    margin = M * Ax_bar_new
    f = (torch.sum(ops.glm_stats(y, margin, fam)[0])
         + glm_lib.penalty(x_new, cfg.lam1, cfg.lam2))
    nnz = torch.sum(x_new != 0.0)
    return x_new, z, u_new, f, nnz


def column_blocks(X, M: int):
    """(M, p_block, n) feature blocks of a float32 (n, p) tensor, p padded
    with zero columns to a multiple of M: block m holds columns
    m p_block .. (m + 1) p_block, each contiguous."""
    n, p = X.shape
    p_pad = p + ((-p) % M)
    At = torch.zeros((p_pad, n), dtype=torch.float32, device=X.device)
    At[:p] = X.T
    return At.reshape(M, p_pad // M, n)


def fit_admm(X, y, cfg: ADMMConfig, device=None):
    """Returns (beta, history dict).  ``device=None`` is the card."""
    dev = resolve_device(device)
    Xd = as_float32(X, dev)
    y = as_float32(y, dev)
    n, p = Xd.shape
    M = cfg.n_blocks
    At = column_blocks(Xd, M)
    del Xd
    col_sq = torch.sum(At * At, dim=2)
    x_blocks = torch.zeros(At.shape[:2], dtype=torch.float32, device=dev)
    zbar = torch.zeros((n,), dtype=torch.float32, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)

    hist = {"f": [], "nnz": []}
    for _ in range(cfg.max_outer):
        x_blocks, zbar, u, f, nnz = _admm_step(At, y, x_blocks, zbar, u,
                                               cfg, col_sq)
        # one batched device→host read per outer iteration
        fh, nnzh = read_f_nnz(f, nnz)
        hist["f"].append(fh)
        hist["nnz"].append(nnzh)
    beta = x_blocks.reshape(-1)[:p]
    return beta.cpu().numpy(), hist
