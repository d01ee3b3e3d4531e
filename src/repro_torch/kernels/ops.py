"""Entry points of the kernels, dispatched by the device of the tensors.

A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
runs the plain PyTorch version of ``kernels/ref.py``.  There is no backend
switch and no fallback between the two.  Each CUDA kernel counts its
launches (``launch_counts``), so a run can show that its main path went
through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core import glm as glm_lib
from repro_torch.kernels import alpha_search as alpha_search_k
from repro_torch.kernels import cd_tile_solve as cd_tile_solve_k
from repro_torch.kernels import glm_stats as glm_stats_k
from repro_torch.kernels import ref
from repro_torch.kernels import tile_gram as tile_gram_k

KERNELS = {
    "glm_stats": glm_stats_k.KERNEL,
    "cd_tile_solve": cd_tile_solve_k.KERNEL,
    "tile_gram": tile_gram_k.KERNEL,
    "alpha_search": alpha_search_k.KERNEL,
}


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _on_card(t) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel for tensors on {t.device}")
    return False


def cd_tile_solve(G, g, h, beta_t, dbeta_t, mu, nu, lam1, lam2, *,
                  penf=None):
    """Exact sequential tile solve (K2); see kernels/cd_tile_solve.py.

    ``mu`` may be a float or a 0-d tensor on g's device; ``penf`` optional
    (T,) penalty factors (0 = unpenalized).
    """
    if not _on_card(g):
        return ref.cd_tile_solve(G, g, h, beta_t, dbeta_t, mu, nu, lam1,
                                 lam2, penf=penf)
    # fill kernels, not host-to-device copies: a copy from pageable host
    # memory would make the host wait for the card once per tile
    mu = mu.to(torch.float32).reshape(()) if torch.is_tensor(mu) \
        else g.new_full((), mu)
    params = torch.stack([mu, g.new_full((), nu), g.new_full((), lam1),
                          g.new_full((), lam2)])
    if penf is None:
        penf = torch.ones_like(g)
    return cd_tile_solve_k.launch(G, g, h, beta_t, dbeta_t, params, penf)


def tile_gram(bricks, rows, n_valid, w, r):
    """Brick Gram/gradient of one feature tile (K3); see kernels/tile_gram.py.

    bricks (K, rb, T), rows (K,) int32, n_valid a host int; w, r flat
    (n_rows,) vectors.  Slots k >= n_valid are skipped.
    """
    if not _on_card(bricks):
        rb = bricks.shape[1]
        return ref.tile_gram(bricks, rows, n_valid, w.reshape(-1, rb),
                             r.reshape(-1, rb))
    return tile_gram_k.launch(bricks, rows, n_valid, w, r)


def glm_stats(y, xb, family, *, weights=None, offset=None):
    """(loss_i, s_i, w_i) per example (K1).

    ``weights`` is the combined observation weight (sample weight x fold
    mask x row padding); ``offset`` shifts the margins.
    """
    fam = glm_lib.resolve_family(family)
    if weights is None:
        weights = torch.ones_like(y)
    if not _on_card(y):
        return ref.glm_stats(y, xb, weights, fam, offset=offset)
    return glm_stats_k.launch(y, xb, weights, fam.name, offset=offset)


def alpha_search(y, xb, xdb, alphas, family, *, weights=None, offset=None):
    """losses[k] = sum_i weights_i * l(y_i, xb_i + o_i + alphas[k]*xdb_i)."""
    fam = glm_lib.resolve_family(family)
    if weights is None:
        weights = torch.ones_like(y)
    if not _on_card(y):
        return ref.alpha_search(y, xb, xdb, weights, alphas, fam,
                                offset=offset)
    return alpha_search_k.launch(y, xb, xdb, weights, alphas, fam.name,
                                 offset=offset)
