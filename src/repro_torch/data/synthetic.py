"""Synthetic datasets shaped like the paper's benchmarks (numpy only).

A copy of the generators of ``repro.data.synthetic``: the same seed gives
the same arrays as the JAX package.

  * ``make_dense``  -- "epsilon"-like: dense, AR(1)-correlated features.
  * ``make_sparse`` -- "webspam"-like: Zipf feature popularity, log-normal
    values, a controlled mean number of nonzeros per row.

Labels come from a planted sparse GLM.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.sparse import SparseCOO


@dataclasses.dataclass
class Split:
    X: object            # np.ndarray or SparseCOO
    y: np.ndarray


@dataclasses.dataclass
class Dataset:
    train: Split
    test: Split
    valid: Split
    beta_true: np.ndarray
    meta: dict


def _split(X, y, rng, test_frac=0.1, valid_frac=0.1):
    n = y.shape[0]
    idx = rng.permutation(n)
    n_test = int(n * test_frac)
    n_valid = int(n * valid_frac)
    te, va, tr = (idx[:n_test], idx[n_test:n_test + n_valid],
                  idx[n_test + n_valid:])
    take = (lambda ix: X.take_rows(ix)) if isinstance(X, SparseCOO) \
        else (lambda ix: X[ix])
    return (Split(take(tr), y[tr]), Split(take(te), y[te]),
            Split(take(va), y[va]))


def _labels_from_margin(margin, rng, family="logistic", noise=0.0,
                        intercept=0.0):
    m = margin + intercept
    if family == "logistic":
        p = 1.0 / (1.0 + np.exp(-m))
        y = np.where(rng.random(m.shape[0]) < p, 1.0, -1.0)
    elif family == "squared":
        y = m + noise * rng.normal(size=m.shape[0])
    elif family == "probit":
        y = np.where(m + rng.normal(size=m.shape[0]) > 0, 1.0, -1.0)
    elif family == "poisson":
        y = rng.poisson(np.exp(np.clip(m, -20, 3))).astype(np.float64)
    else:
        raise ValueError(family)
    return y.astype(np.float32)


def make_dense(n=2000, p=200, k_true=20, rho=0.3, family="logistic",
               seed=0, intercept=0.0):
    """epsilon-like dense data with AR(1)-correlated features (corr ``rho``).

    The recursion runs over a feature-major copy, so each step streams two
    contiguous rows instead of striding down a column; the arithmetic, and
    so every value, is the reference generator's.
    """
    rng = np.random.default_rng(seed)
    Zt = np.ascontiguousarray(
        rng.normal(size=(n, p)).astype(np.float32).T)
    Xt = np.empty_like(Zt)
    Xt[0] = Zt[0]
    c = np.sqrt(1 - rho * rho)
    for j in range(1, p):
        Xt[j] = rho * Xt[j - 1] + c * Zt[j]
    del Zt
    X = np.ascontiguousarray(Xt.T)
    del Xt
    beta = np.zeros(p, np.float32)
    nz = rng.choice(p, size=k_true, replace=False)
    beta[nz] = rng.normal(size=k_true).astype(np.float32) * 2.0
    y = _labels_from_margin(X @ beta, rng, family, intercept=intercept)
    tr, te, va = _split(X, y, rng)
    return Dataset(tr, te, va, beta, dict(kind="dense", n=n, p=p, rho=rho,
                                          family=family))


def make_sparse(n=5000, p=20000, avg_nnz=50, k_true=100, family="logistic",
                seed=0, zipf_a=1.3, imbalance=0.0):
    """webspam-like sparse data: feature popularity ~ Zipf(zipf_a); values
    log-normal.  ``imbalance`` shifts the intercept to skew class priors."""
    rng = np.random.default_rng(seed)
    nnz_per_row = np.maximum(1, rng.poisson(avg_nnz, size=n))
    total = int(nnz_per_row.sum())
    ranks = (rng.pareto(zipf_a, size=total) * p / 8.0).astype(np.int64) % p
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    vals = rng.lognormal(0.0, 0.5, size=total).astype(np.float32)
    X = SparseCOO(rows, ranks, vals, shape=(n, p)).dedupe()
    beta = np.zeros(p, np.float32)
    # plant signal on frequent features so it is identifiable
    nz = rng.choice(min(p, 4000), size=k_true, replace=False)
    beta[nz] = rng.normal(size=k_true).astype(np.float32)
    margin = X.matvec(beta)
    margin = margin / max(margin.std(), 1e-6) * 2.0
    y = _labels_from_margin(margin, rng, family, intercept=-imbalance)
    tr, te, va = _split(X, y, rng)
    return Dataset(tr, te, va, beta, dict(
        kind="sparse", n=n, p=p, avg_nnz=float(nnz_per_row.mean()),
        nnz=total, family=family, pos_frac=float((y > 0).mean())))
