"""d-GLMNET on one device: the configuration, the fit state and one outer
iteration ("superstep").

Mirrors the single-device supersteps of ``repro.core.dglmnet`` (paper
Algorithm 4 with one node):
  1. link stats (loss, s, w) at beta from the kept margins X beta [glm_stats]
  2. one cycle of tile coordinate descent, Gauss-Seidel or Jacobi across
     tiles                                  [cd.py: tile_gram, cd_tile_solve]
  3. the line search for alpha, Armijo after an alpha_init pre-search
                                             [linesearch.py: alpha_search]
  4. beta += alpha dbeta, X beta += alpha X dbeta, and the trust-region
     scale mu doubles after a short step or halves (not below 1) after a
     unit step (Algorithm 1, lines 8-12).

With ``coupling="jacobi"`` and ``fuse_superstep=True`` (the default for that
coupling, as in the reference) steps 1-3 take two fused launches instead:
``ops.fused_stats_sweep`` (stats, every live tile's Gram and solve; the
``stats_gram_solve`` kernel on a dense design) and ``ops.fused_ls`` (the
margin delta and the losses of all ``full_candidates``; ``margin_ls``),
then ``select_precomputed`` picks alpha.  That one-pass line search is the
route the reference takes on its accelerator; it runs on both devices here.
``precision="bf16"`` gives those two launches bfloat16 product inputs (the
bf16 modes of stats_gram_solve, margin_ls and, on bricks, tile_gram).

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
from repro_torch.kernels import ops, ref


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
    coupling: str = "gauss-seidel"          # or "jacobi"
    # the fused Jacobi superstep (two launches); inert for gauss-seidel
    fuse_superstep: bool = True
    # "fp32" | "bf16": input precision of the fused superstep's Gram and
    # margin products (their sums, the stats, the solves and the Armijo
    # sums stay float32); inert for gauss-seidel and unfused jacobi
    precision: str = "fp32"
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


def make_superstep(config: DGLMNETConfig, *, n_tiles: int, device=None):
    """Build the superstep closure for a design of ``n_tiles`` tiles on
    ``device`` (None: the CUDA card).

    The returned ``superstep(design, y, weights, offset, lams, penf, state,
    *, active=None, tile_active=None)`` takes the combined
    observation weights (sample weight x row padding), margin offsets, the
    host pair ``lams = (lam1, lam2)``, the packed penalty factors and an
    optional screening mask (``active`` on the device, ``tile_active`` its
    per-tile summary on the host).  It returns (new state, metrics), the
    metrics being 0-d device tensors keyed by ``METRIC_KEYS``.
    """
    ref.is_bf16(config.precision)     # an unknown precision raises
    if config.coupling not in cd_lib.SWEEPS:
        raise ValueError(f"unknown coupling {config.coupling!r}; have "
                         f"{sorted(cd_lib.SWEEPS)}")
    fam = config.family
    sweep = cd_lib.SWEEPS[config.coupling]
    alphas0 = linesearch.candidate_alphas(config.ls_delta,
                                          config.ls_grid_size, device)
    cand = linesearch.full_candidates(config.ls_delta, config.ls_grid_size,
                                      config.backtrack_b,
                                      config.max_backtracks, device)

    def f_at(beta, L, lam1, lam2, penf):
        R0 = linesearch.penalty_terms(beta, torch.zeros_like(beta),
                                      torch.zeros_like(alphas0[:1]), lam1,
                                      lam2, penf)[0]
        return L + R0

    def finish(state, ls, dbeta, xdb, f_cur, L, tiles_done):
        """Apply the step; adapt mu; the metrics."""
        beta, xb, mu, cursor, step = state
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

    def superstep(design, y, weights, offset, lams, penf, state: FitState,
                  *, active=None, tile_active=None):
        beta, xb, mu, cursor, _ = state
        lam1, lam2 = float(lams[0]), float(lams[1])

        # (1) link statistics at the current iterate (weighted, offset)
        loss_i, s, w = ops.glm_stats(y, xb, fam, weights=weights,
                                     offset=offset)
        L = torch.sum(loss_i)
        f_cur = f_at(beta, L, lam1, lam2, penf)

        # (2) the local quadratic sub-problem: one full tile cycle (one
        # device has no slow peers, so no ALB budget)
        dbeta, xdb, tiles_done = sweep(
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
        return finish(state, ls, dbeta, xdb, f_cur, L, tiles_done)

    def superstep_fused(design, y, weights, offset, lams, penf,
                        state: FitState, *, active=None, tile_active=None):
        beta, xb, mu, _, _ = state
        lam1, lam2 = float(lams[0]), float(lams[1])

        # (1+2) fused launch: stats, every live tile's Gram and gradient and
        # the Jacobi tile solves
        loss_i, s, w, dbeta, _, _ = ops.fused_stats_sweep(
            design, y, xb, beta, fam, mu=mu, nu=config.nu, lam1=lam1,
            lam2=lam2, weights=weights, offset=offset, penf=penf,
            tile_live=tile_active, precision=config.precision)
        if active is not None:
            dbeta = torch.where(active > 0, dbeta, torch.zeros_like(dbeta))
        L = torch.sum(loss_i)
        f_cur = f_at(beta, L, lam1, lam2, penf)

        # (3) fused launch: the margin delta and every candidate's loss;
        # Algorithm 3 then picks from them
        xdb, losses = ops.fused_ls(design, y, xb, dbeta, cand, fam,
                                   weights=weights, offset=offset,
                                   precision=config.precision)
        grad_dot_dir = -torch.sum(s * xdb)
        quad_form = (mu * torch.sum(w * xdb * xdb)
                     + config.nu * torch.sum(dbeta * dbeta))
        ls = linesearch.select_precomputed(
            losses, cand, beta, dbeta, lam1, lam2, f_current=f_cur,
            grad_dot_dir=grad_dot_dir, quad_form=quad_form,
            sigma=config.sigma, gamma=config.gamma,
            grid_size=config.ls_grid_size,
            max_backtracks=config.max_backtracks, penf=penf)
        return finish(state, ls, dbeta, xdb, f_cur, L, n_tiles)

    if config.coupling == "jacobi" and config.fuse_superstep:
        return superstep_fused
    return superstep
