"""repro_torch's mask-based K-fold ``GLMSolver.fit_cv`` and the observation
swaps (``training_margins``, ``set_observations``) on the CPU against the
JAX package's, and the reference's CV contracts written against the port
(without its compile count, which has no counterpart in the port).

Bars: the same fold assignment, ``dev_folds`` within rtol 1e-5, the same
``best_index`` and ``lam_best``, and beta equal to the full-data path's at
that index.  Paths run with ``tol=1e-4`` (lock-step, stopped before float32
resolution; see ``tests/test_torch_path.py``); with an intercept the port
takes JAX's grid (lambda_max agrees to ~1e-4, ROADMAP Queue 3 item 3).
"""
import numpy as np
import pytest
import torch

from repro.core.dglmnet import DGLMNETConfig as JConfig
from repro.core.solver import GLMSolver as JSolver
from repro.data import synthetic as jsynth
from repro_torch.core.dglmnet import DGLMNETConfig as TConfig
from repro_torch.core.solver import CVResult, GLMSolver as TSolver
from repro_torch.core.solver import PathResult
from repro_torch.data import sparse as tsparse
from repro_torch.data import synthetic as tsynth


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These problems are a few hundred rows: torch's intra-op threads buy
    nothing there and, beside the other test workers, spin on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(kind, seed, n=400, family="logistic"):
    if kind == "dense":
        ds = jsynth.make_dense(n=n, p=40, k_true=6, seed=seed, family=family)
        X = Xt = ds.train.X
    else:
        ds = jsynth.make_sparse(n=n, p=96, avg_nnz=10, k_true=12, seed=seed,
                                family=family)
        X = ds.train.X
        Xt = tsparse.SparseCOO(X.rows, X.cols, X.vals, X.shape)
    rng = np.random.default_rng(seed)
    sw = rng.uniform(0.5, 1.5, len(ds.train.y)).astype(np.float32)
    sw[::13] = 0.0
    return X, Xt, ds.train.y, sw


def _spy_folds(solver):
    """Record the held-out weights each fold's path is given."""
    seen = []
    impl = solver._path_impl

    def spy(lambdas, lam2, **kw):
        if kw.get("eval_weights") is not None:
            seen.append(np.array(kw["eval_weights"]))
        return impl(lambdas, lam2, **kw)

    solver._path_impl = spy
    return seen


CV_CASES = [("dense", "gauss-seidel", False, 17, "logistic"),
            ("dense", "jacobi", True, 17, "logistic"),
            ("sparse", "jacobi", False, 19, "logistic"),
            ("sparse", "gauss-seidel", True, 19, "logistic"),
            ("dense", "gauss-seidel", True, 23, "poisson")]


@pytest.mark.parametrize("kind,coupling,standardize,seed,family", CV_CASES)
def test_fit_cv_matches_jax(kind, coupling, standardize, seed, family):
    X, Xt, y, sw = _problem(kind, seed, family=family)
    cfg = dict(tile_size=16, coupling=coupling, max_outer=60, tol=1e-4,
               family=family)
    kw = dict(sample_weight=sw, fit_intercept=True, standardize=standardize,
              row_block=32)
    js = JSolver(X, y, config=JConfig(**cfg), **kw)
    ts = TSolver(Xt, y, config=TConfig(**cfg), device="cpu", **kw)
    fj, ft = _spy_folds(js), _spy_folds(ts)
    cj = js.fit_cv(n_folds=3, n_lambdas=8, lam_ratio=1e-2, seed=3)
    ct = ts.fit_cv(n_folds=3, lambdas=cj.lambdas, seed=3)
    assert isinstance(ct, CVResult) and isinstance(ct.path, PathResult)
    # the same folds: each fold's held-out weights, bit for bit
    assert len(ft) == len(fj) == 3
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(a, b)
    assert sum((a > 0).sum() for a in ft) == (sw > 0).sum()
    np.testing.assert_allclose(ct.dev_folds, cj.dev_folds, rtol=1e-5)
    np.testing.assert_allclose(ct.dev_mean, cj.dev_mean, rtol=1e-5)
    np.testing.assert_allclose(ct.dev_se, cj.dev_se, rtol=1e-3, atol=1e-7)
    assert ct.best_index == cj.best_index
    assert ct.lam_best == cj.lam_best
    np.testing.assert_array_equal(ct.beta, ct.path.betas[ct.best_index])
    np.testing.assert_array_equal(ts.beta_, ct.beta)
    assert ct.intercept == ct.path.intercepts[ct.best_index]
    np.testing.assert_allclose(ct.beta, cj.beta, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ct.path.n_iters, cj.path.n_iters)


# --------------------------------------------- the reference's contracts


def test_fit_cv_interior_lambda_and_refit():
    """K=5 CV selects an interior lambda, and its coefficients are the
    full-data path's at that lambda."""
    ds = tsynth.make_dense(n=400, p=40, k_true=6, seed=17)
    cfg = TConfig(tile_size=16, coupling="jacobi", max_outer=60, tol=1e-10)
    s = TSolver(ds.train.X, ds.train.y, config=cfg, fit_intercept=True,
                standardize=True, device="cpu")
    cv = s.fit_cv(n_folds=5, n_lambdas=12, lam_ratio=1e-3)
    K = len(cv.lambdas)
    assert cv.dev_folds.shape == (5, K)
    assert np.isfinite(cv.dev_mean).all()
    assert 0 < cv.best_index < K - 1
    assert cv.lam_best == float(cv.lambdas[cv.best_index])
    np.testing.assert_array_equal(cv.beta, cv.path.betas[cv.best_index])
    np.testing.assert_array_equal(s.beta_, cv.beta)
    assert isinstance(cv.path, PathResult)
    assert cv.path.nnz[-1] > cv.path.nnz[0]
    with pytest.raises(ValueError, match="n_folds"):
        s.fit_cv(n_folds=1)


def test_fit_cv_weighted_folds_respect_sample_weight():
    """Fold masks multiply the session weights: a zero-weight row never
    enters training or validation deviance."""
    ds = tsynth.make_dense(n=200, p=16, k_true=4, seed=18)
    X, y = ds.train.X.copy(), ds.train.y.copy()
    y2 = y.copy()
    y2[:30] = -y2[:30]
    sw2 = np.ones(len(y), np.float32)
    sw2[:30] = 0.0
    cfg = TConfig(tile_size=16, coupling="jacobi", max_outer=50, tol=1e-10)
    cv_clean = TSolver(X[30:], y[30:], config=cfg, device="cpu").fit_cv(
        n_folds=4, n_lambdas=8, lam_ratio=1e-2, seed=3)
    cv_masked = TSolver(X, y2, config=cfg, sample_weight=sw2,
                        device="cpu").fit_cv(n_folds=4, n_lambdas=8,
                                             lam_ratio=1e-2, seed=3)
    np.testing.assert_allclose(cv_masked.lambdas[0], cv_clean.lambdas[0],
                               rtol=1e-4)
    assert np.isfinite(cv_masked.dev_mean).all()


# ---------------------------------------------------------- observations


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_training_margins_and_set_observations_match_jax(kind):
    X, Xt, y, sw = _problem(kind, 21, n=300)
    cfg = dict(tile_size=16, max_outer=40, tol=1e-4)
    kw = dict(sample_weight=sw, fit_intercept=True, row_block=32)
    js = JSolver(X, y, config=JConfig(**cfg), **kw)
    ts = TSolver(Xt, y, config=TConfig(**cfg), device="cpu", **kw)
    with pytest.raises(ValueError, match="no fitted state"):
        ts.training_margins()
    lam1 = 0.1 * js.lambda_max()
    js.fit(lam1=lam1)
    ts.fit(lam1=lam1)
    mt, mj = ts.training_margins(), js.training_margins()
    assert mt.shape == (len(y),)
    np.testing.assert_allclose(mt, mj, rtol=1e-5, atol=1e-5)
    Xd = X if kind == "dense" else X.to_dense()
    np.testing.assert_allclose(mt, Xd @ ts.beta_ + ts.intercept_,
                               rtol=1e-5, atol=1e-5)

    # a new observation model on the same session: lambda_max is taken
    # anew, fits follow JAX's
    rng = np.random.default_rng(22)
    off = (0.3 * rng.normal(size=len(y))).astype(np.float32)
    sw2 = rng.uniform(0.5, 2.0, len(y)).astype(np.float32)
    y2 = np.where(rng.random(len(y)) < 0.2, -y, y).astype(np.float32)
    lmax_before = ts.lambda_max()
    for s in (js, ts):
        assert s.set_observations(y=y2, sample_weight=sw2, offset=off) is s
    assert ts._state is None
    with pytest.raises(ValueError, match="no fitted state"):
        ts.training_margins()
    lmax = js.lambda_max()
    assert ts.lambda_max() == pytest.approx(lmax, rel=1e-4)
    assert ts.lambda_max() != lmax_before
    rj = js.fit(lam1=0.2 * lmax)
    rt = ts.fit(lam1=0.2 * lmax)
    assert rt.history["alpha"] == rj.history["alpha"]
    np.testing.assert_allclose(rt.beta, rj.beta, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.training_margins(),
                               js.training_margins(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="must be"):
        ts.set_observations(y=y2[:-1])
    with pytest.raises(ValueError, match="nonnegative"):
        ts.set_observations(sample_weight=-sw2)
