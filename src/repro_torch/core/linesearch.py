"""d-GLMNET line search (paper Algorithm 3), vectorized over candidates.

Mirrors ``repro.core.linesearch``.  With sigma, b, gamma, delta from the
paper (defaults b = 0.5, sigma = 0.01, gamma = 0):
  1. take alpha = 1 if it satisfies Armijo, f(beta + dbeta) <= f(beta) +
     sigma D;
  2. else take alpha_init = argmin over a log-spaced grid on [delta, 1] of
     f(beta + alpha dbeta) and backtrack alpha_init b^j until Armijo holds.

Every candidate's loss comes from the one-pass ``alpha_search`` kernel; the
penalties are separable and formed here.  Selection is branch-free tensor
code, so a superstep on the card never waits for the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops


class LineSearchResult(NamedTuple):
    alpha: torch.Tensor          # chosen step
    f_new: torch.Tensor          # objective at the chosen step
    accepted_unit: torch.Tensor  # bool: alpha = 1 accepted by Armijo directly
    D: torch.Tensor              # the paper's directional decrease bound


def candidate_alphas(delta, grid_size, device="cpu"):
    """Algorithm 3's candidates ``[1, logspace(delta .. 1)]`` in float32.

    The grid is formed as ``jnp.logspace`` forms it on XLA: a float32
    linspace of the exponents, point i being start (1 - i (1/(m-1))), then
    10 to that power rounded to float32.  For the default 13-point grid
    both packages search bit-identical step sizes.
    """
    f32 = np.float32
    start = f32(np.log10(float(delta)))
    step = np.arange(grid_size - 1, dtype=f32) \
        * (f32(1) / f32(grid_size - 1))
    lin = np.concatenate([start * (f32(1) - step) + f32(0) * step,
                          np.zeros(1, f32)]) if grid_size > 1 \
        else np.full(grid_size, start, f32)
    grid = np.power(10.0, lin.astype(np.float64)).astype(f32)
    alphas = np.concatenate([np.ones(1, f32), grid])
    return torch.from_numpy(alphas).to(device)


def backtrack_chains(alphas, b, max_backtracks):
    """(K, max_backtracks) Armijo chains ``alphas[i] * b^j``."""
    powers = torch.pow(
        torch.full((), b, dtype=torch.float32, device=alphas.device),
        torch.arange(max_backtracks, dtype=torch.float32,
                     device=alphas.device))
    return alphas[:, None] * powers[None, :]


def _at(v, idx):
    """v[idx] for a 0-d index tensor, without a device-to-host read."""
    return v.index_select(0, idx.reshape(1)).reshape(())


def armijo_select(f_unit, f_bt, bt, f_current, sigma, D) -> LineSearchResult:
    """Take alpha = 1 if it passes Armijo, else the first (largest) passing
    backtrack candidate, else the smallest step."""
    ok_unit = f_unit <= f_current + sigma * D
    ok_bt = f_bt <= f_current + bt * sigma * D
    # argmax over an int mask: the first passing index
    idx = torch.argmax(ok_bt.to(torch.int32))
    idx = torch.where(torch.any(ok_bt), idx,
                      torch.full_like(idx, bt.shape[0] - 1))
    alpha = torch.where(ok_unit, torch.ones_like(f_unit), _at(bt, idx))
    f_new = torch.where(ok_unit, f_unit, _at(f_bt, idx))
    return LineSearchResult(alpha, f_new, ok_unit, D)


def penalty_terms(beta, dbeta, alphas, lam1, lam2, penf=None):
    """R(beta + alpha dbeta) for every alpha, (K,).  ``penf``: optional
    per-coordinate penalty factors (0 leaves a coordinate unpenalized)."""
    pf = torch.ones_like(beta) if penf is None else penf
    l1 = torch.sum(pf[None, :]
                   * torch.abs(beta[None, :] + alphas[:, None]
                               * dbeta[None, :]), dim=-1)
    b2 = torch.sum(pf * beta * beta)
    bd = torch.sum(pf * beta * dbeta)
    d2 = torch.sum(pf * dbeta * dbeta)
    l2 = b2 + 2.0 * alphas * bd + alphas * alphas * d2
    return lam1 * l1 + 0.5 * lam2 * l2


def search(y, xb, xdb, beta, dbeta, *, family, lam1, lam2, f_current,
           grad_dot_dir, quad_form, alphas, sigma=0.01, b=0.5, gamma=0.0,
           max_backtracks=20, weights=None, offset=None,
           penf=None) -> LineSearchResult:
    """Run Algorithm 3.

    y, xb, xdb: (n,) labels, margins and margin delta; beta, dbeta: (p,);
    ``alphas``: the device tensor of ``candidate_alphas``; f_current: f(beta);
    grad_dot_dir: grad L(beta)^T dbeta; quad_form: dbeta^T (mu (H + nu I))
    dbeta (read only when gamma > 0).  ``weights``/``offset``/``penf`` are
    the observation weights, margin offsets and penalty factors.
    """
    losses = ops.alpha_search(y, xb, xdb, alphas, family, weights=weights,
                              offset=offset)
    pens = penalty_terms(beta, dbeta, alphas, lam1, lam2, penf)
    f_cand = losses + pens

    # the paper's D (eq. 12)
    R1 = pens[0]
    R0 = penalty_terms(beta, dbeta, torch.zeros_like(alphas[:1]), lam1,
                       lam2, penf)[0]
    D = grad_dot_dir + gamma * quad_form + R1 - R0

    a_init = _at(alphas, torch.argmin(f_cand))
    bt = backtrack_chains(a_init[None], b, max_backtracks)[0]
    losses_bt = ops.alpha_search(y, xb, xdb, bt, family, weights=weights,
                                 offset=offset)
    f_bt = losses_bt + penalty_terms(beta, dbeta, bt, lam1, lam2, penf)
    return armijo_select(f_cand[0], f_bt, bt, f_current, sigma, D)
