"""d-GLMNET on one device: the configuration, the fit state and one outer
iteration ("superstep").

Mirrors the unfused single-device superstep of ``repro.core.dglmnet``
(paper Algorithm 4 with one node):
  1. link stats (loss, s, w) at beta from the kept margins X beta [glm_stats]
  2. one Gauss-Seidel cycle of tile coordinate descent   [cd.py: tile_gram,
                                                          cd_tile_solve]
  3. the line search for alpha, Armijo after an alpha_init pre-search
                                             [linesearch.py: alpha_search]
  4. beta += alpha dbeta, X beta += alpha X dbeta, and the trust-region
     scale mu doubles after a short step or halves (not below 1) after a
     unit step (Algorithm 1, lines 8-12).

The superstep queues its work on the device and returns tensors; the
caller reads the metrics once per superstep.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import cd as cd_lib
from repro_torch.core import linesearch
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class DGLMNETConfig:
    family: str = "logistic"
    # default regularization (fit() takes per-call values)
    lam1: float = 0.0
    lam2: float = 0.0
    # trust region (paper Algorithm 1 / Section 4)
    mu_init: float = 1.0
    adaptive_mu: bool = True
    eta1: float = 2.0
    eta2: float = 2.0
    nu: float = 1e-6
    # line search (paper Algorithm 3)
    sigma: float = 0.01
    backtrack_b: float = 0.5
    gamma: float = 0.0
    ls_delta: float = 1e-3
    ls_grid_size: int = 13
    max_backtracks: int = 20
    # sweep
    tile_size: int = 256
    coupling: str = "gauss-seidel"
    # outer loop
    max_outer: int = 100
    tol: float = 1e-8


class FitState(NamedTuple):
    beta: torch.Tensor     # (p,) weights in packed column order
    xb: torch.Tensor       # (n,) margins X beta
    mu: torch.Tensor       # () trust-region scale
    cursor: int            # first tile of the next sweep
    step: int


class FitResult(NamedTuple):
    beta: np.ndarray
    history: dict
    n_iter: int
    converged: bool


METRIC_KEYS = ("f", "f_before", "loss", "alpha", "mu", "nnz",
               "accepted_unit", "D")


def make_superstep(config: DGLMNETConfig, *, n_tiles: int, device="cpu"):
    """Build the superstep closure for a design of ``n_tiles`` tiles.

    The returned ``superstep(design, y, weights, offset, lams, penf, state,
    *, active=None, tile_active=None)`` takes the combined
    observation weights (sample weight x row padding), margin offsets, the
    host pair ``lams = (lam1, lam2)``, the packed penalty factors and an
    optional screening mask (``active`` on the device, ``tile_active`` its
    per-tile summary on the host).  It returns (new state, metrics), the
    metrics being 0-d device tensors keyed by ``METRIC_KEYS``.
    """
    if config.coupling != "gauss-seidel":
        raise NotImplementedError(
            f"coupling={config.coupling!r}: the Jacobi coupling and its fused "
            "superstep (the stats_gram_solve and margin_ls kernels) are "
            "ported in a later slice; use coupling='gauss-seidel'")
    fam = config.family
    alphas0 = linesearch.candidate_alphas(config.ls_delta,
                                          config.ls_grid_size, device)

    def superstep(design, y, weights, offset, lams, penf, state: FitState,
                  *, active=None, tile_active=None):
        beta, xb, mu, cursor, step = state
        lam1, lam2 = float(lams[0]), float(lams[1])

        # (1) link statistics at the current iterate (weighted, offset)
        loss_i, s, w = ops.glm_stats(y, xb, fam, weights=weights,
                                     offset=offset)
        L = torch.sum(loss_i)
        R0 = linesearch.penalty_terms(beta, torch.zeros_like(beta),
                                      torch.zeros_like(alphas0[:1]), lam1,
                                      lam2, penf)[0]
        f_cur = L + R0

        # (2) the local quadratic sub-problem: one full tile cycle (one
        # device has no slow peers, so no ALB budget)
        dbeta, xdb, tiles_done = cd_lib.sweep_gauss_seidel(
            design, s, w, beta, torch.zeros_like(beta), torch.zeros_like(xb),
            mu=mu, nu=config.nu, lam1=lam1, lam2=lam2, start_tile=cursor,
            active=active, tile_active=tile_active, penf=penf)

        # (3) line search on the weighted Armijo sums
        grad_dot_dir = -torch.sum(s * xdb)
        quad_form = (mu * torch.sum(w * xdb * xdb)
                     + config.nu * torch.sum(dbeta * dbeta))
        ls = linesearch.search(
            y, xb, xdb, beta, dbeta, family=fam, lam1=lam1, lam2=lam2,
            f_current=f_cur, grad_dot_dir=grad_dot_dir, quad_form=quad_form,
            alphas=alphas0, sigma=config.sigma, b=config.backtrack_b,
            gamma=config.gamma, max_backtracks=config.max_backtracks,
            weights=weights, offset=offset, penf=penf)

        # (4) apply the step; adapt mu
        beta_new = beta + ls.alpha * dbeta
        xb_new = xb + ls.alpha * xdb
        if config.adaptive_mu:
            mu_new = torch.where(ls.alpha < 1.0, config.eta1 * mu,
                                 torch.clamp(mu / config.eta2, min=1.0))
        else:
            mu_new = mu
        metrics = {
            "f": ls.f_new, "f_before": f_cur, "loss": L,
            "alpha": ls.alpha, "mu": mu_new,
            "nnz": torch.sum(beta_new != 0.0),
            "accepted_unit": ls.accepted_unit.to(torch.int32),
            "D": ls.D,
        }
        new_state = FitState(beta_new, xb_new, mu_new,
                             (cursor + tiles_done) % n_tiles, step + 1)
        return new_state, metrics

    return superstep
