"""Independent reference optimizer: FISTA proximal gradient for elastic-net
GLMs, on the card.

Mirrors ``repro.core.prox_ref``: an oracle that reaches the optimum by an
algorithm unrelated to d-GLMNET, so tests and ``chip_smoke.py`` can hold a
fit against it and take f* for suboptimality curves (the paper uses long
liblinear runs for the same purpose).  The smooth part and its gradient
-X^T s come from ``ops.glm_stats`` (K1) and two matrix-vector products;
the backtracking, the monotone restart and the stop test are the
reference's decisions on the host, each backtracking step one batched
read.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import glm as glm_lib
from repro_torch.device import as_float32, resolve_device
from repro_torch.kernels import ops


def prox_elastic_net(v, t, lam1, lam2):
    return glm_lib.soft_threshold(v, t * lam1) / (1.0 + t * lam2)


def lipschitz_sigma_sq(X) -> float:
    """||X||_2^2 by 50 steps of power iteration in float64 from the
    reference's start (``default_rng(0)``), on X's device."""
    p = X.shape[1]
    v = np.random.default_rng(0).normal(size=p)
    v /= np.linalg.norm(v)
    Xd = X.double()
    v = torch.from_numpy(v).to(X.device)
    for _ in range(50):
        v = Xd.T @ (Xd @ v)
        v = v / torch.clamp(torch.linalg.norm(v), min=1e-30)
    sigma_sq = float(v @ (Xd.T @ (Xd @ v)))
    del Xd
    return sigma_sq


def fit_fista(X, y, *, family="logistic", lam1=0.0, lam2=0.0,
              max_iter=2000, tol=1e-12, L0=None, device=None):
    """Returns (beta, objective history). Monotone (restarted) FISTA with
    backtracking on the smooth part.  X (n, p) and y (n,) as numpy arrays
    or tensors; ``device=None`` is the card."""
    dev = resolve_device(device)
    X = as_float32(X, dev)
    y = as_float32(y, dev)
    fam = glm_lib.resolve_family(family)
    p = X.shape[1]

    def smooth_and_s(beta):
        loss, s, _ = ops.glm_stats(y, X @ beta, fam)
        return torch.sum(loss), s

    bound = fam.curvature_bound if fam.curvature_bound is not None else 1.0
    L = L0 if L0 is not None else max(bound * lipschitz_sigma_sq(X), 1e-6)

    beta = torch.zeros(p, dtype=torch.float32, device=dev)
    z = beta
    tk = 1.0
    f_best = float(smooth_and_s(beta)[0]
                   + glm_lib.penalty(beta, lam1, lam2))
    beta_best = beta
    hist = [f_best]
    for _ in range(max_iter):
        fz_t, s = smooth_and_s(z)
        g = -(X.T @ s)
        # backtracking on L: q and the smooth part at the candidate, and
        # the candidate's full objective, in one read a step
        while True:
            cand = prox_elastic_net(z - g / L, 1.0 / L, lam1, lam2)
            diff = cand - z
            fc, _ = smooth_and_s(cand)
            fz, gd, dd, fc_h, f = torch.stack(
                [fz_t, g @ diff, diff @ diff, fc,
                 fc + glm_lib.penalty(cand, lam1, lam2)]).tolist()
            q = fz + gd + 0.5 * L * dd
            if fc_h <= q + 1e-12 * max(1.0, abs(q)):
                break
            L *= 2.0
        t_next = float(0.5 * (1.0 + np.sqrt(1.0 + 4.0 * tk * tk)))
        z = cand + ((tk - 1.0) / t_next) * (cand - beta)
        beta, tk = cand, t_next
        if f < f_best - 1e-300:
            f_best, beta_best = f, beta
        else:  # monotone restart
            z, tk = beta_best, 1.0
        hist.append(f)
        if len(hist) > 3 and abs(hist[-2] - hist[-1]) <= tol * max(
                1.0, abs(hist[-1])):
            break
        L *= 0.9  # allow L to shrink back
    return beta_best.cpu().numpy(), hist
