"""Block coordinate-descent sweep over the feature tiles of one device.

Mirrors ``repro.core.cd`` for the default Gauss-Seidel coupling: tiles are
processed cyclically and tile t sees the margin delta of tiles < t.  Per
tile, ``design.tile_gram`` gives the Gram block G and the gradient g (the
``tile_gram`` kernel on a brick layout, a matrix product on a dense one),
``ops.cd_tile_solve`` runs the exact sequential chain of coordinate
updates, and ``design.tile_matvec`` folds the tile's step into the margin
delta.  The tile loop is a Python loop: the budget and the screening mask
are known on the host, so a dead tile is skipped without asking the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops


def alb_live_mask(n_tiles: int, start_tile: int, num_tiles: int):
    """(n_tiles,) bool: tiles [start, start + budget) in cyclic order, the
    ALB budget window of one sweep (paper Section 7)."""
    offset = (np.arange(n_tiles) - start_tile) % n_tiles
    return offset < min(num_tiles, n_tiles)


def sweep_gauss_seidel(design, s, w, beta, dbeta, xdb, *, mu, nu, lam1,
                       lam2, start_tile: int = 0, num_tiles=None,
                       active=None, tile_active=None, penf=None):
    """Cyclic tile sweep; returns (dbeta, xdb, tiles_done).

    s, w: (n,) link stats at the outer iterate, observation weights folded
    in.  beta, dbeta: (p,); xdb: (n,) = X dbeta.  ``mu`` may be a device
    scalar.  ``num_tiles``: the budget of tiles this superstep (default one
    full cycle).  ``active``: optional (p,) 0/1 screening mask on the
    device; coordinates with ``active == 0`` keep their entering step.
    ``tile_active``: optional host (n_tiles,) bool, False for a tile with no
    active coordinate, whose Gram, solve and matvec are then skipped
    outright.  ``penf``: optional (p,) penalty factors (0 = unpenalized,
    the intercept).
    """
    T = design.tile_size
    nt = design.n_tiles
    tiles_done = nt if num_tiles is None else min(int(num_tiles), nt)
    dbeta = dbeta.clone()
    for t in range(tiles_done):
        tid = (start_tile + t) % nt
        if tile_active is not None and not tile_active[tid]:
            continue
        sl = slice(tid * T, (tid + 1) * T)
        dt = dbeta[sl]
        r = s - mu * (w * xdb)
        G, g = design.tile_gram(tid, w, r)
        h = torch.diagonal(G).contiguous()
        dt_new = ops.cd_tile_solve(G, g, h, beta[sl], dt, mu, nu, lam1,
                                   lam2, penf=None if penf is None
                                   else penf[sl])
        if active is not None:
            dt_new = torch.where(active[sl] > 0, dt_new, dt)
        xdb = xdb + design.tile_matvec(tid, dt_new - dt)
        dbeta[sl] = dt_new
    return dbeta, xdb, tiles_done
