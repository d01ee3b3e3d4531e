"""Plain PyTorch versions of the four CUDA kernels of this package.

They mirror ``repro/kernels/ref.py`` (the JAX oracles) operation for
operation.  ``kernels/ops.py`` runs them for tensors on the CPU, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.  Nothing
on the solver's path calls them for a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch.core import glm as glm_lib


def cd_tile_solve(G, g, h, beta_t, dbeta_t, mu, nu, lam1, lam2, penf=None):
    """One cyclic pass of exact coordinate minimization over a feature tile.

    G (T, T) tile Gram block; g (T,) the tile gradient at entry; h = diag(G);
    beta_t the fixed outer iterate; dbeta_t the accumulated step (updated);
    penf optional (T,) penalty factors (0 = unpenalized).  Returns the new
    (T,) step.  Updating coordinate j by delta changes g_k by
    -mu * delta * G[k, j], so X is never touched again.
    """
    T = g.shape[0]
    pf = torch.ones_like(g) if penf is None else penf
    mu = torch.as_tensor(mu, dtype=g.dtype, device=g.device)
    nu = torch.as_tensor(nu, dtype=g.dtype, device=g.device)
    lam1v = lam1 * pf
    lam2v = lam2 * pf
    den = mu * h + nu + lam2v
    den_safe = torch.clamp(den, min=1e-30)
    g_c = g.clone()
    d_c = dbeta_t.clone()
    for j in range(T):
        num = g_c[j] + mu * h[j] * (beta_t[j] + d_c[j]) + nu * beta_t[j]
        u = glm_lib.soft_threshold(num, lam1v[j]) / den_safe[j]
        # dead coordinate (all-zero column, nu == lam2 == 0): keep at 0
        u = torch.where(den[j] > 0, u, beta_t[j])
        d_new = u - beta_t[j]
        delta = d_new - d_c[j]
        g_c = g_c - mu * delta * G[:, j]
        d_c[j] = d_new
    return d_c


def tile_gram(bricks, rows, n_valid, w2, r2):
    """G = sum_k b_k^T diag(w[rows[k]]) b_k,  g = sum_k b_k^T r[rows[k]].

    bricks (K, rb, T) the bricks of one feature tile (slots k >= n_valid are
    ignored); rows (K,) their row-block ids; w2, r2 (n_row_blocks, rb).
    """
    K = bricks.shape[0]
    mask = (torch.arange(K, device=bricks.device) < int(n_valid)) \
        .to(bricks.dtype)
    b = bricks * mask[:, None, None]
    wk = w2[rows.long()]
    rk = r2[rows.long()]
    G = torch.einsum("kit,kiu->tu", b * wk[:, :, None], b)
    g = torch.einsum("kit,ki->t", b, rk)
    return G, g


def glm_stats(y, xb, weights, family, offset=None):
    """(loss_i, s_i, w_i) at margins ``xb + offset``, scaled by ``weights``."""
    fam = glm_lib.resolve_family(family)
    return fam.stats(y, xb, weights=weights, offset=offset)


def alpha_search(y, xb, xdb, weights, alphas, family, offset=None):
    """losses[k] = sum_i weights_i * l(y_i, xb_i + o_i + alphas[k] * xdb_i)."""
    fam = glm_lib.resolve_family(family)
    if offset is not None:
        xb = xb + offset
    m = xb[None, :] + alphas[:, None] * xdb[None, :]
    loss, _, _ = fam.stats(y[None, :], m)
    return torch.sum(loss * weights[None, :], dim=-1)
