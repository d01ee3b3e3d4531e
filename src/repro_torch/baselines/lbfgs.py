"""L-BFGS for L2-regularized GLMs + the online-warmstart combination.

Agarwal et al. (2014) Algorithm 2 — the paper's strongest L2 competitor
(Figs. 5-6): (1) average online-learning weights trained on example shards,
(2) warmstart L-BFGS from the average.  Two-loop recursion with r=15 history
pairs (the paper's default) and Armijo backtracking.  The loss/gradient are
example-separable, i.e. data-parallel at scale; this in-process version keeps
the math identical.

Mirrors ``repro.baselines.lbfgs``: the loss and its gradient -X^T s come
from ``ops.glm_stats`` (K1) and two matrix-vector products on the card;
the recursion's dot products and the Armijo test are the reference's host
decisions.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.baselines.online_tg import (OnlineTGConfig,
                                             fit_online_tg, nnz_of)
from repro_torch.core import glm as glm_lib
from repro_torch.device import as_float32, read_f_nnz, resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class LBFGSConfig:
    lam2: float = 0.0
    history: int = 15          # paper's r
    max_iter: int = 100
    c1: float = 1e-4
    backtrack: float = 0.5
    max_backtracks: int = 30
    family: str = "logistic"


def fit_lbfgs(X, y, cfg: LBFGSConfig, w0=None, device=None):
    """Returns (beta, history dict).  ``w0`` a numpy array or a tensor;
    ``device=None`` is the card."""
    dev = resolve_device(device)
    X = as_float32(X, dev)
    y = as_float32(y, dev)
    n, p = X.shape
    fam = glm_lib.resolve_family(cfg.family)

    def f_and_g(w):
        loss, s, _ = ops.glm_stats(y, X @ w, fam)
        f = torch.sum(loss) + 0.5 * cfg.lam2 * torch.sum(w * w)
        g = -(X.T @ s) + cfg.lam2 * w
        return f, g

    w = torch.zeros(p, dtype=torch.float32, device=dev) if w0 is None \
        else as_float32(w0, dev)
    f, g = f_and_g(w)
    S, Y, RHO = [], [], []
    f0, nnz0 = read_f_nnz(f, nnz_of(w))
    hist = {"f": [f0], "nnz": [nnz0]}

    for _ in range(cfg.max_iter):
        # two-loop recursion
        q = g
        alphas = []
        for s_i, y_i, rho_i in zip(reversed(S), reversed(Y), reversed(RHO)):
            a_i = rho_i * float(s_i @ q)
            q = q - a_i * y_i
            alphas.append(a_i)
        if S:
            gamma = float(S[-1] @ Y[-1]) / max(float(Y[-1] @ Y[-1]), 1e-30)
        else:
            gamma = 1.0
        r = gamma * q
        for (s_i, y_i, rho_i), a_i in zip(zip(S, Y, RHO), reversed(alphas)):
            b_i = rho_i * float(y_i @ r)
            r = r + (a_i - b_i) * s_i
        d = -r

        gtd = float(g @ d)
        if gtd > 0:  # not a descent direction — reset memory
            S, Y, RHO = [], [], []
            d, gtd = -g, -float(g @ g)

        # Armijo backtracking
        step = 1.0
        for _bt in range(cfg.max_backtracks):
            f_new, g_new = f_and_g(w + step * d)
            if float(f_new) <= float(f) + cfg.c1 * step * gtd:
                break
            step *= cfg.backtrack
        w_new = w + step * d

        s_vec, y_vec = w_new - w, g_new - g
        sy = float(s_vec @ y_vec)
        if sy > 1e-10:
            S.append(s_vec); Y.append(y_vec); RHO.append(1.0 / sy)
            if len(S) > cfg.history:
                S.pop(0); Y.pop(0); RHO.pop(0)
        w, f, g = w_new, f_new, g_new
        fh, nnz = read_f_nnz(f, nnz_of(w))
        hist["f"].append(fh)
        hist["nnz"].append(nnz)
        if float(torch.max(torch.abs(g))) < 1e-10:
            break
    return w.cpu().numpy(), hist


def fit_online_warmstart_lbfgs(X, y, lbfgs_cfg: LBFGSConfig,
                               online_cfg: OnlineTGConfig | None = None,
                               device=None):
    """Agarwal et al. Algorithm 2: online average → L-BFGS warmstart."""
    if online_cfg is None:
        online_cfg = OnlineTGConfig(lam1=0.0, lam2=lbfgs_cfg.lam2, epochs=2,
                                    family=lbfgs_cfg.family)
    w0, hist_online = fit_online_tg(X, y, online_cfg, device=device)
    beta, hist = fit_lbfgs(X, y, lbfgs_cfg, w0=w0, device=device)
    hist["f"] = hist_online["f"] + hist["f"]
    hist["nnz"] = hist_online["nnz"] + hist["nnz"]
    return beta, hist
