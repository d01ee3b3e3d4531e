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

On a (data x model) mesh (``groups=(data_group, model_group)``, one
process per rank) the superstep is the reference's sharded one: each rank
runs K1-K4 on its own (row shard, feature shard) block, L and the K4
losses are summed over the data group, (G, g) over it once a live tile
(Gauss-Seidel) or once a sweep (Jacobi), the margin delta is merged over
the model group (``sharding.compress.psum_compressed``, optionally bf16
or int8 on the wire), the penalty terms and nnz are summed over the model
group, and the ALB ``budget`` (a host int, this rank's column's) bounds
the sweep.  The fused Jacobi superstep is a single-device path, as in the
reference: a mesh takes the unfused one.

``make_streaming_superstep`` cuts the same iteration at the chunk boundary
for out-of-core designs (``StreamingDesign``): a pass over the chunks sums
the statistics (G_w = X^T W X, g0 = X^T s, the loss), the Gram-mode sweep
runs from them, and a second pass sums every line-search candidate's loss.

``fit`` and ``fit_sharded`` are the reference's deprecated one-shot fits,
thin wrappers over ``GLMSolver(...).fit()``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import cd as cd_lib
from repro_torch.core import linesearch
from repro_torch.kernels import ops, ref
from repro_torch.sharding import collectives
from repro_torch.sharding.compress import psum_compressed


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
    # distribution: the margin merge's wire format, None | "bf16" | "int8"
    compress_margin: Optional[str] = None
    # ALB (Section 7): False = BSP, every column a full cycle a superstep
    alb: bool = False
    alb_kappa: float = 0.75
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


def make_superstep(config: DGLMNETConfig, *, n_tiles: int, device=None,
                   groups=None, max_budget: Optional[int] = None):
    """Build the superstep closure for a design of ``n_tiles`` tiles on
    ``device`` (None: the CUDA card).

    The returned ``superstep(design, y, weights, offset, lams, penf, state,
    *, active=None, tile_active=None, budget=None)`` takes the combined
    observation weights (sample weight x row padding), margin offsets, the
    host pair ``lams = (lam1, lam2)``, the packed penalty factors and an
    optional screening mask (``active`` on the device, ``tile_active`` its
    per-tile summary on the host).  It returns (new state, metrics), the
    metrics being 0-d device tensors keyed by ``METRIC_KEYS``.

    ``groups=(data_group, model_group)`` makes it the sharded superstep
    of a mesh (either group may be None, a mesh dim of one); ``budget``
    is then this rank's column's ALB tile budget, at most ``max_budget``
    (default: one cycle, ``n_tiles``).
    """
    ref.is_bf16(config.precision)     # an unknown precision raises
    if config.coupling not in cd_lib.SWEEPS:
        raise ValueError(f"unknown coupling {config.coupling!r}; have "
                         f"{sorted(cd_lib.SWEEPS)}")
    fam = config.family
    sweep = cd_lib.SWEEPS[config.coupling]
    sharded = groups is not None
    dg, mg = groups if sharded else (None, None)
    alphas0 = linesearch.candidate_alphas(config.ls_delta,
                                          config.ls_grid_size, device)
    cand = linesearch.full_candidates(config.ls_delta, config.ls_grid_size,
                                      config.backtrack_b,
                                      config.max_backtracks, device)

    def f_at(beta, L, lam1, lam2, penf):
        R0 = linesearch.penalty_terms(beta, torch.zeros_like(beta),
                                      torch.zeros_like(alphas0[:1]), lam1,
                                      lam2, penf, mg)[0]
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
        nnz = torch.sum(beta_new != 0.0)
        if mg is not None:
            nnz = collectives.all_reduce(nnz.reshape(1), mg)[0]
        metrics = {
            "f": ls.f_new, "f_before": f_cur, "loss": L,
            "alpha": ls.alpha, "mu": mu_new,
            "nnz": nnz,
            "accepted_unit": ls.accepted_unit.to(torch.int32),
            "D": ls.D,
        }
        new_state = FitState(beta_new, xb_new, mu_new,
                             (cursor + tiles_done) % n_tiles, step + 1)
        return new_state, metrics

    def superstep(design, y, weights, offset, lams, penf, state: FitState,
                  *, active=None, tile_active=None, budget=None):
        beta, xb, mu, cursor, _ = state
        lam1, lam2 = float(lams[0]), float(lams[1])

        # (1) link statistics at the current iterate (weighted, offset)
        loss_i, s, w = ops.glm_stats(y, xb, fam, weights=weights,
                                     offset=offset)
        L = torch.sum(loss_i)

        # (2) the local quadratic sub-problem: one tile cycle on one
        # device; on a mesh this column's ALB budget of tiles
        dbeta, xdb_local, tiles_done = sweep(
            design, s, w, beta, torch.zeros_like(beta), torch.zeros_like(xb),
            mu=mu, nu=config.nu, lam1=lam1, lam2=lam2, start_tile=cursor,
            num_tiles=budget, max_num_tiles=max_budget, active=active,
            tile_active=tile_active, penf=penf, data_group=dg)

        if not sharded:
            f_cur = f_at(beta, L, lam1, lam2, penf)
            xdb = xdb_local
            grad_dot_dir = -torch.sum(s * xdb)
            quad_form = (mu * torch.sum(w * xdb * xdb)
                         + config.nu * torch.sum(dbeta * dbeta))
        else:
            # (3) merge the margin deltas over the feature shards (paper
            # step 6); the row sums over the data group in one reduction
            xdb = psum_compressed(xdb_local, mg, config.compress_margin)
            L, gdd, quad_local = collectives.all_reduce(torch.stack([
                L, -torch.sum(s * xdb),
                torch.sum(w * xdb_local * xdb_local)]), dg)
            f_cur = f_at(beta, L, lam1, lam2, penf)
            quad, d2 = collectives.all_reduce(
                torch.stack([quad_local, torch.sum(dbeta * dbeta)]), mg)
            grad_dot_dir = gdd
            quad_form = mu * quad + config.nu * d2

        # (4) line search on the weighted Armijo sums
        ls = linesearch.search(
            y, xb, xdb, beta, dbeta, family=fam, lam1=lam1, lam2=lam2,
            f_current=f_cur, grad_dot_dir=grad_dot_dir, quad_form=quad_form,
            alphas=alphas0, sigma=config.sigma, b=config.backtrack_b,
            gamma=config.gamma, max_backtracks=config.max_backtracks,
            weights=weights, offset=offset, penf=penf, data_group=dg,
            model_group=mg)
        return finish(state, ls, dbeta, xdb, f_cur, L, tiles_done)

    def superstep_fused(design, y, weights, offset, lams, penf,
                        state: FitState, *, active=None, tile_active=None,
                        budget=None):
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

    if config.coupling == "jacobi" and config.fuse_superstep and \
            not sharded:
        return superstep_fused
    return superstep


# ---------------------------------------------------------------------------
# streaming superstep (out-of-core row chunks)
# ---------------------------------------------------------------------------


class StreamingSuperstep(NamedTuple):
    """The pieces of one out-of-core superstep (mirrors the reference's):

      pass 1   ``stats_chunk`` a chunk: K1 on the chunk's margins X_c beta
               (never kept), then G_w += X_c^T W_c X_c, g0 += X_c^T s_c and
               L += sum loss_c;
      sweep    ``prepare``: the Gram-mode sweep (``cd.GRAM_SWEEPS``) and the
               line search's scalars;
      pass 2   ``ls_chunk`` a chunk: the chunk's two margins, then K4 over
               every candidate of ``full_candidates`` (the unit step, the
               grid and each one's backtracking chain), summed;
      finish   ``finish``: Algorithm 3 over the summed losses
               (``select_precomputed``), the step, mu and the cursor, and
               the in-memory superstep's metrics.
    """
    stats_chunk: object
    prepare: object
    ls_chunk: object
    finish: object
    n_candidates: int


def make_streaming_superstep(config: DGLMNETConfig, *, n_tiles: int,
                             device=None) -> StreamingSuperstep:
    """The streaming superstep's pieces for ``n_tiles`` tiles on ``device``
    (None: the CUDA card).  Their work is queued on the device; nothing
    waits for it."""
    if config.coupling not in cd_lib.GRAM_SWEEPS:
        raise ValueError(f"unknown coupling {config.coupling!r}; have "
                         f"{sorted(cd_lib.GRAM_SWEEPS)}")
    fam = config.family
    T = config.tile_size
    sweep = cd_lib.GRAM_SWEEPS[config.coupling]
    cand = linesearch.full_candidates(config.ls_delta, config.ls_grid_size,
                                      config.backtrack_b,
                                      config.max_backtracks, device)

    def stats_chunk(Xc, yc, wc, oc, beta, acc):
        """acc = (G, g0, L), summed into in place and returned."""
        G, g0, L = acc
        loss_i, s, w = ops.glm_stats(yc, Xc @ beta, fam, weights=wc,
                                     offset=oc)
        G.addmm_((Xc * w[:, None]).T, Xc)
        g0 += Xc.T @ s
        L += torch.sum(loss_i)
        return acc

    def prepare(acc, beta, mu, lams, penf, cursor, *, active=None,
                tile_active=None):
        G, g0, L = acc
        lam1, lam2 = float(lams[0]), float(lams[1])
        R0 = linesearch.penalty_terms(beta, torch.zeros_like(beta),
                                      torch.zeros_like(cand[:1]), lam1, lam2,
                                      penf)[0]
        dbeta, u, tiles_done = sweep(
            G, g0, beta, mu=mu, nu=config.nu, lam1=lam1, lam2=lam2,
            tile_size=T, start_tile=cursor, active=active,
            tile_active=tile_active, penf=penf)
        return {"dbeta": dbeta, "loss": L, "f_cur": L + R0,
                "grad_dot_dir": -torch.dot(g0, dbeta),
                "quad_form": mu * torch.dot(dbeta, u)
                + config.nu * torch.dot(dbeta, dbeta),
                "tiles_done": tiles_done}

    def ls_chunk(Xc, yc, wc, oc, beta, dbeta, losses):
        """losses (K,) summed into in place and returned."""
        losses += ops.alpha_search(yc, Xc @ beta, Xc @ dbeta, cand, fam,
                                   weights=wc, offset=oc)
        return losses

    def finish(losses, prep, state: FitState, lams, penf):
        beta, xb, mu, cursor, step = state
        lam1, lam2 = float(lams[0]), float(lams[1])
        dbeta = prep["dbeta"]
        ls = linesearch.select_precomputed(
            losses, cand, beta, dbeta, lam1, lam2, f_current=prep["f_cur"],
            grad_dot_dir=prep["grad_dot_dir"], quad_form=prep["quad_form"],
            sigma=config.sigma, gamma=config.gamma,
            grid_size=config.ls_grid_size,
            max_backtracks=config.max_backtracks, penf=penf)
        beta_new = beta + ls.alpha * dbeta
        if config.adaptive_mu:
            mu_new = torch.where(ls.alpha < 1.0, config.eta1 * mu,
                                 torch.clamp(mu / config.eta2, min=1.0))
        else:
            mu_new = mu
        metrics = {
            "f": ls.f_new, "f_before": prep["f_cur"], "loss": prep["loss"],
            "alpha": ls.alpha, "mu": mu_new,
            "nnz": torch.sum(beta_new != 0.0),
            "accepted_unit": ls.accepted_unit.to(torch.int32),
            "D": ls.D,
        }
        return FitState(beta_new, xb, mu_new,
                        (cursor + prep["tiles_done"]) % n_tiles,
                        step + 1), metrics

    return StreamingSuperstep(stats_chunk, prepare, ls_chunk, finish,
                              int(cand.shape[0]))


# ---------------------------------------------------------------------------
# the deprecated one-shot fit (a thin wrapper over solver.GLMSolver)
# ---------------------------------------------------------------------------

_DEPRECATION_WARNED: set = set()


def _warn_deprecated(name: str):
    """Warn once per name and process, as the reference does."""
    if name in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(name)
    warnings.warn(
        f"repro_torch.core.dglmnet.{name} is deprecated; construct a "
        "repro_torch.core.solver.GLMSolver session instead: it packs and "
        "places the design once and fits warm-started lambda paths "
        "(solver.fit / solver.fit_path).",
        DeprecationWarning, stacklevel=3)


def fit(X, y, config: DGLMNETConfig, *, beta0=None, verbose=False,
        design_info=None, device=None) -> FitResult:
    """DEPRECATED one-shot single-device fit; use ``GLMSolver(...).fit()``.

    X: (n, p) dense array-like, a ``SparseCOO`` (packed into bricks without
    densifying the whole matrix) or a prebuilt ``DesignMatrix`` (a
    ``BlockSparseDesign`` needs the ``DesignInfo`` made with it as
    ``design_info`` to map beta back to the feature order).  ``device``
    None is the CUDA card.
    """
    _warn_deprecated("fit")
    from repro_torch.core.solver import GLMSolver
    solver = GLMSolver(X, y, config=config, design_info=design_info,
                       device=device)
    return solver.fit(beta0=beta0, verbose=verbose)


def fit_sharded(X, y, config: DGLMNETConfig, mesh, *,
                axis_data: Optional[str] = "data",
                axis_model: str = "model", speeds=None, seed: int = 0,
                verbose=False, ckpt_manager=None, ckpt_every: int = 10,
                row_block: int = 256, reorder: bool = True,
                design_info=None, device=None) -> FitResult:
    """DEPRECATED one-shot sharded fit; use ``GLMSolver(..., mesh=mesh)``.

    Rows shard over ``axis_data`` and features over ``axis_model`` of the
    ``DeviceMesh`` (each process calls it with the same full inputs and
    keeps its block), with optional ALB speeds and checkpoints at superstep
    boundaries.  ``device`` None is the card.
    """
    _warn_deprecated("fit_sharded")
    from repro_torch.core.solver import GLMSolver
    solver = GLMSolver(X, y, config=config, mesh=mesh, axis_data=axis_data,
                       axis_model=axis_model, speeds=speeds, seed=seed,
                       row_block=row_block, reorder=reorder,
                       design_info=design_info, device=device)
    return solver.fit(verbose=verbose, ckpt_manager=ckpt_manager,
                      ckpt_every=ckpt_every)
