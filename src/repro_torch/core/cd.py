"""Block coordinate-descent sweeps over the feature tiles of one device.

Mirrors ``repro.core.cd``:

  * ``gauss-seidel`` (the default): tiles are processed cyclically and tile
    t sees the margin delta of tiles < t.  Per tile, ``design.tile_gram``
    gives the Gram block G and the gradient g (the ``tile_gram`` kernel on a
    brick layout, a matrix product on a dense one), ``ops.cd_tile_solve``
    runs the exact sequential chain of coordinate updates, and
    ``design.tile_matvec`` folds the tile's step into the margin delta.
  * ``jacobi``: every tile's G and g come up front at the entering iterate
    (``design.all_tile_grams``), each tile solves from a zero step as a
    virtual node of its own, and one ``design.matvec`` forms the margin
    delta.  This is the unfused form of the fused superstep
    (``fuse_superstep=False``).

The tile loops are Python loops: the budget and the screening mask are
known on the host, so a dead tile is skipped without asking the card.

On a mesh (``data_group``: the process group of the ranks that share this
rank's feature columns and hold the other row shards), each tile's (G, g)
is summed over the data group: once a live tile in the Gauss-Seidel sweep,
once a sweep in the Jacobi one.  The reference turns its dead-tile skip
off when rows are sharded, because a traced branch cannot hold a psum.
The host loop keeps it: every rank of a data group holds the same columns,
the same screening mask and the same budget, so all of them skip the same
tiles and meet at the same reductions.  An ALB budget may pass one cycle
(``max_num_tiles``, up to four): the sweep then visits tiles again from
where it left them.

The Gram-mode sweeps (``GRAM_SWEEPS``) serve out-of-core designs, where
one pass over the row chunks gives the full weighted Gram G_w = X^T W X and
the gradient g0 = X^T s.  They are the row-space sweeps rewritten: at tile
t the residual gradient X_t^T (s - mu W X dbeta) is g0_t - mu (G_w
dbeta)_t, so they keep u = G_w dbeta (a (p, T) product a tile) instead of
the (n,) margin delta, and return it for the line search's quadratic
dbeta^T G_w dbeta = dbeta^T u.  Both start from dbeta = 0.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.sharding import collectives


def alb_live_mask(n_tiles: int, start_tile: int, num_tiles: int):
    """(n_tiles,) bool: tiles [start, start + budget) in cyclic order, the
    ALB budget window of one sweep (paper Section 7)."""
    offset = (np.arange(n_tiles) - start_tile) % n_tiles
    return offset < min(num_tiles, n_tiles)


def _budget(nt: int, num_tiles, max_num_tiles) -> int:
    """Tiles a sweep visits: its budget (one cycle by default), at most
    ``max_num_tiles`` (one cycle by default)."""
    bound = nt if max_num_tiles is None else int(max_num_tiles)
    return bound if num_tiles is None else min(int(num_tiles), bound)


def sweep_gauss_seidel(design, s, w, beta, dbeta, xdb, *, mu, nu, lam1,
                       lam2, start_tile: int = 0, num_tiles=None,
                       max_num_tiles=None, active=None, tile_active=None,
                       penf=None, data_group=None):
    """Cyclic tile sweep; returns (dbeta, xdb, tiles_done).

    s, w: (n,) link stats at the outer iterate, observation weights folded
    in.  beta, dbeta: (p,); xdb: (n,) = X dbeta.  ``mu`` may be a device
    scalar.  ``num_tiles``: the budget of tiles this superstep (default one
    full cycle), at most ``max_num_tiles`` (default one cycle; an ALB
    budget may run to four).  ``active``: optional (p,) 0/1 screening mask
    on the device; coordinates with ``active == 0`` keep their entering
    step.  ``tile_active``: optional host (n_tiles,) bool, False for a tile
    with no active coordinate, whose Gram, solve and matvec are then
    skipped outright.  ``penf``: optional (p,) penalty factors (0 =
    unpenalized, the intercept).  ``data_group``: sum each tile's (G, g)
    over the row shards.
    """
    T = design.tile_size
    nt = design.n_tiles
    tiles_done = _budget(nt, num_tiles, max_num_tiles)
    dbeta = dbeta.clone()
    params = ops.solve_params(mu, nu, lam1, lam2, s)   # mu is fixed a sweep
    for t in range(tiles_done):
        tid = (start_tile + t) % nt
        if tile_active is not None and not tile_active[tid]:
            continue
        sl = slice(tid * T, (tid + 1) * T)
        dt = dbeta[sl]
        r = s - mu * (w * xdb)
        G, g = design.tile_gram(tid, w, r)
        if data_group is not None:
            G, g = collectives.all_reduce_many((G, g), data_group)
        dt_new = ops.cd_tile_solve(G, g, torch.diagonal(G), beta[sl], dt,
                                   params, penf=None if penf is None
                                   else penf[sl])
        if active is not None:
            dt_new = torch.where(active[sl] > 0, dt_new, dt)
        xdb = xdb + design.tile_matvec(tid, dt_new - dt)
        dbeta[sl] = dt_new
    return dbeta, xdb, tiles_done


def sweep_jacobi(design, s, w, beta, dbeta, xdb, *, mu, nu, lam1, lam2,
                 start_tile: int = 0, num_tiles=None, max_num_tiles=None,
                 active=None, tile_active=None, penf=None, data_group=None):
    """Jacobi-across-tiles sweep; returns (dbeta, xdb, tiles_done).

    ``dbeta`` and ``xdb`` must be zero on entry (the start of an outer
    iteration).  The budget window and ``tile_active`` pick the live tiles
    on the host; only those cost a Gram and a solve (a budget past one
    cycle makes every tile live once).  ``active`` and ``penf`` act per
    coordinate as in ``sweep_gauss_seidel``; ``data_group`` sums the
    sweep's Grams and gradients over the row shards in one reduction.
    """
    nt = design.n_tiles
    tiles_done = min(_budget(nt, num_tiles, max_num_tiles), nt)
    live = alb_live_mask(nt, start_tile, tiles_done)
    if tile_active is not None:
        live = live & np.asarray(tile_active, bool)
    G_all, g_all = design.all_tile_grams(w, s, live)
    if data_group is not None:
        G_all, g_all = collectives.all_reduce_many((G_all, g_all),
                                                   data_group)
    d = ops.jacobi_tile_solves(G_all, g_all, beta,
                               ops.solve_params(mu, nu, lam1, lam2, s),
                               penf=penf, tile_live=live)
    if active is not None:
        d = torch.where(active > 0, d, torch.zeros_like(d))
    ops.record_launch("matvec")     # the xdb merge pass, its own sweep of X
    return d, design.matvec(d), tiles_done


SWEEPS = {"gauss-seidel": sweep_gauss_seidel, "jacobi": sweep_jacobi}


def sweep_gauss_seidel_gram(G_full, g0, beta, *, mu, nu, lam1, lam2,
                            tile_size: int, start_tile: int = 0,
                            num_tiles=None, active=None, tile_active=None,
                            penf=None):
    """Cyclic tile sweep from the full Gram; returns (dbeta, u, tiles_done)
    with u = G_full dbeta.  One K2 launch a swept tile; ``active``,
    ``tile_active`` and ``penf`` as in ``sweep_gauss_seidel``."""
    T = tile_size
    nt = g0.shape[0] // T
    tiles_done = nt if num_tiles is None else min(int(num_tiles), nt)
    dbeta = torch.zeros_like(beta)
    u = torch.zeros_like(beta)
    params = ops.solve_params(mu, nu, lam1, lam2, g0)
    for t in range(tiles_done):
        tid = (start_tile + t) % nt
        if tile_active is not None and not tile_active[tid]:
            continue
        sl = slice(tid * T, (tid + 1) * T)
        G = G_full[sl, sl].contiguous()
        dt = dbeta[sl]
        g = g0[sl] - mu * u[sl]
        dt_new = ops.cd_tile_solve(G, g, torch.diagonal(G), beta[sl], dt,
                                   params, penf=None if penf is None
                                   else penf[sl])
        if active is not None:
            dt_new = torch.where(active[sl] > 0, dt_new, dt)
        u += G_full[:, sl] @ (dt_new - dt)
        dbeta[sl] = dt_new
    return dbeta, u, tiles_done


def sweep_jacobi_gram(G_full, g0, beta, *, mu, nu, lam1, lam2,
                      tile_size: int, start_tile: int = 0, num_tiles=None,
                      active=None, tile_active=None, penf=None):
    """Jacobi across tiles from the full Gram: every live tile's chain from
    a zero step on its diagonal block, in one batched K2 launch; returns
    (dbeta, u, tiles_done)."""
    T = tile_size
    nt = g0.shape[0] // T
    tiles_done = nt if num_tiles is None else min(int(num_tiles), nt)
    live = alb_live_mask(nt, start_tile, tiles_done)
    if tile_active is not None:
        live = live & np.asarray(tile_active, bool)
    tids = torch.arange(nt, device=g0.device)
    G_all = G_full.view(nt, T, nt, T)[tids, :, tids, :]     # diagonal blocks
    d = ops.jacobi_tile_solves(G_all, g0.view(nt, T), beta,
                               ops.solve_params(mu, nu, lam1, lam2, g0),
                               penf=penf, tile_live=live)
    if active is not None:
        d = torch.where(active > 0, d, torch.zeros_like(d))
    return d, G_full @ d, tiles_done


GRAM_SWEEPS = {"gauss-seidel": sweep_gauss_seidel_gram,
               "jacobi": sweep_jacobi_gram}
