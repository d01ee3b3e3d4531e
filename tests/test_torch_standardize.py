"""``GLMSolver(standardize=True)`` of repro_torch on the CPU against the JAX
package's: the designs' weighted column moments, the scaled design, fits
on it (packed and on the user's scale), the bf16 mode on a standardized
design, and the reference's standardization contracts written against the
port.

Tolerances: column moments within 1e-6 relative (the first moment of a
column relative to its weighted absolute sum, since it may cancel to 0);
packed beta within 1e-5 of JAX's; beta and the intercept on the user's
scale within 1e-5 of max |beta|.  Fits run lock-step (the same alpha every
superstep) with ``tol=1e-4``, which stops them before their Armijo tests
compare sums at float32 resolution (ROADMAP Queue 3 item 4).
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro.core.dglmnet import DGLMNETConfig as JConfig
from repro.core.solver import GLMSolver as JSolver
from repro.data import synthetic as jsynth
from repro_torch.core import glm as tglm
from repro_torch.core.dglmnet import DGLMNETConfig as TConfig
from repro_torch.core.solver import GLMSolver as TSolver
from repro_torch.data import design as tdesign
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


def _problem(kind, seed=5):
    """A badly scaled design with the whole observation model; the last
    three features are all zero (dead)."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        ds = jsynth.make_dense(n=300, p=43, k_true=8, seed=seed,
                               intercept=0.5)
        X = ds.train.X.copy()
        X[:, 3] *= 40.0
        X[:, 7] *= 0.02
        X[:, -3:] = 0.0
        Xt = X
    else:
        ds = jsynth.make_sparse(n=400, p=93, avg_nnz=10, k_true=20,
                                seed=seed)
        X = ds.train.X
        keep = X.cols < 90
        vals = X.vals[keep] * np.where(X.cols[keep] == 3, 40.0, 1.0) \
            .astype(np.float32)
        X = type(X)(X.rows[keep], X.cols[keep], vals, X.shape)
        Xt = tsparse.SparseCOO(X.rows, X.cols, X.vals, X.shape)
    y = ds.train.y
    n, p = len(y), X.shape[1]
    sw = rng.uniform(0.2, 2.0, n).astype(np.float32)
    sw[::9] = 0.0
    off = (rng.normal(size=n) * 0.2).astype(np.float32)
    pf = rng.uniform(0.5, 1.5, p).astype(np.float32)
    pf[0] = 0.0
    kw = dict(sample_weight=sw, offset=off, penalty_factor=pf,
              fit_intercept=True, row_block=32)
    return X, Xt, y, kw


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_col_moments_match_jax(kind):
    X, Xt, y, kw = _problem(kind)
    js = JSolver(X, y, config=JConfig(tile_size=16), **kw)
    ts = TSolver(Xt, y, config=TConfig(tile_size=16), device="cpu", **kw)
    s1j, s2j = js._col_moments()
    s1t, s2t = (m.numpy() for m in ts.design.col_moments(ts._wobs))
    absx = ts.design.to_dense().abs().T @ ts._wobs
    assert np.all(np.abs(s1t - s1j) <= 1e-6 * absx.numpy())
    np.testing.assert_allclose(s2t, s2j, rtol=1e-6)
    assert (s1t[s2t == 0] == 0).all()


@pytest.mark.parametrize("coupling", ["gauss-seidel", "jacobi"])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_standardized_fit_matches_jax(kind, coupling):
    X, Xt, y, kw = _problem(kind)
    cfg = dict(tile_size=16, coupling=coupling, max_outer=30, tol=1e-4)
    js = JSolver(X, y, config=JConfig(**cfg), standardize=True, **kw)
    ts = TSolver(Xt, y, config=TConfig(**cfg), standardize=True,
                 device="cpu", **kw)
    assert ts.standardize is True
    np.testing.assert_allclose(ts._scale_packed, js._scale_packed,
                               rtol=1e-6)
    np.testing.assert_allclose(ts._center_packed, js._center_packed,
                               rtol=1e-6, atol=1e-7)
    if kind == "sparse":            # bricks are scale-only
        assert (ts._center_packed == 0).all()
    lam1 = 0.1 * js.lambda_max()
    rj = js.fit(lam1=lam1, lam2=0.01)
    rt = ts.fit(lam1=lam1, lam2=0.01)
    assert rt.n_iter == rj.n_iter
    assert rt.history["alpha"] == rj.history["alpha"]
    np.testing.assert_allclose(rt.history["f"], rj.history["f"], rtol=1e-5)
    np.testing.assert_allclose(ts._state.beta.numpy(),
                               np.asarray(js._state.beta), rtol=0, atol=1e-5)
    scale = float(np.abs(rj.beta).max())
    np.testing.assert_allclose(rt.beta, rj.beta, rtol=0, atol=1e-5 * scale)
    assert ts.intercept_ == pytest.approx(js.intercept_, abs=1e-5 * scale)
    assert (rt.beta[-3:] == 0.0).all()
    # predictions on the original scale agree too
    Xd = X if kind == "dense" else X.to_dense()
    np.testing.assert_allclose(ts.predict(Xd[:30], kind="link"),
                               js.predict(Xd[:30], kind="link"),
                               rtol=1e-5, atol=1e-5)


def test_standardized_path_matches_jax():
    X, Xt, y, kw = _problem("dense")
    cfg = dict(tile_size=16, max_outer=60, tol=1e-4)
    js = JSolver(X, y, config=JConfig(**cfg), standardize=True, **kw)
    ts = TSolver(Xt, y, config=TConfig(**cfg), standardize=True,
                 device="cpu", **kw)
    pj = js.fit_path(n_lambdas=6, lam_ratio=1e-2, lam2=0.01)
    pt = ts.fit_path(lambdas=pj.lambdas, lam2=0.01)
    np.testing.assert_array_equal(pt.n_iters, pj.n_iters)
    np.testing.assert_array_equal(pt.nnz, pj.nnz)
    np.testing.assert_allclose(pt.f, pj.f, rtol=1e-5)
    scale = float(np.abs(pj.betas).max())
    np.testing.assert_allclose(pt.betas, pj.betas, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(pt.intercepts, pj.intercepts,
                               atol=1e-5 * scale)


def test_bricks_refuse_centering():
    X, Xt, y, kw = _problem("sparse")
    ts = TSolver(Xt, y, config=TConfig(tile_size=16), device="cpu", **kw)
    p = ts.design.shape[1]
    with pytest.raises(ValueError, match="cannot center"):
        ts.design.scale_columns(torch.ones(p), torch.zeros(p))
    scaled = ts.design.scale_columns(torch.full((p,), 2.0))
    assert torch.equal(scaled.to_dense(), 2.0 * ts.design.to_dense())


def test_intercept_column_stays_ones_and_old_design_is_freed(monkeypatch):
    """The dense design is centered and scaled into one new tensor; the
    intercept's packed column stays exact ones, and nothing keeps the
    unscaled tensor alive."""
    X, _, y, kw = _problem("dense")
    made = []
    dense_design = tdesign.dense_design

    def spy(*a, **k):
        out = dense_design(*a, **k)
        made.append(weakref.ref(out[0].data))
        return out

    monkeypatch.setattr(tdesign, "dense_design", spy)
    ts = TSolver(X, y, config=TConfig(tile_size=16), standardize=True,
                 device="cpu", **kw)
    gc.collect()
    assert len(made) == 1 and made[0]() is None
    data = ts.design.data
    assert torch.equal(data[:, ts._icol()], torch.ones(data.shape[0]))
    w = ts._wobs
    wsum = float(w.sum())
    mean = (data.T @ w) / wsum
    var = (data * data).T @ w / wsum - mean * mean
    live = ts._scale_packed != 1.0
    np.testing.assert_allclose(mean.numpy()[live], 0.0, atol=1e-5)
    np.testing.assert_allclose(var.numpy()[live], 1.0, rtol=1e-4)


def test_bf16_standardized_tracks_fp32():
    """precision="bf16" reads the scaled design; a standardized bf16 fit
    holds the reference's bf16 bar against its fp32 twin
    (``tests/test_fused.py``): alpha equal on at least 80% of supersteps,
    beta within 0.05 max(max |beta_fp32|, 1)."""
    ds = tsynth.make_dense(n=300, p=48, k_true=8, seed=12)
    X = ds.train.X.copy()
    X[:, 5] *= 30.0
    fits = {}
    for prec in ("fp32", "bf16"):
        s = TSolver(X, ds.train.y, standardize=True, fit_intercept=True,
                    device="cpu", config=TConfig(
                        tile_size=16, coupling="jacobi", max_outer=60,
                        tol=1e-10, precision=prec))
        fits[prec] = s.fit(lam1=0.1 * s.lambda_max(), lam2=0.05)
    a32 = np.asarray(fits["fp32"].history["alpha"])
    a16 = np.asarray(fits["bf16"].history["alpha"])
    k = min(len(a32), len(a16))
    assert k > 5
    match = float(np.mean(np.isclose(a32[:k], a16[:k], rtol=1e-6)))
    assert match >= 0.8, (match, a32[:k], a16[:k])
    err = float(np.abs(fits["bf16"].beta - fits["fp32"].beta).max())
    scale = float(np.abs(fits["fp32"].beta).max())
    assert err <= 0.05 * max(scale, 1.0), (err, scale)


# ------------------------------------- the reference's standardization


def _obj(X, y, beta, lam1, lam2, intercept=0.0):
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return float(tglm.objective("logistic", t(y), t(X), t(beta), lam1, lam2,
                                intercept=intercept))


def test_standardize_returns_original_scale_beta():
    """standardize=True equals an explicitly pre-standardized fit
    (weighted mean/std), with beta mapped back to the original scale."""
    ds = tsynth.make_dense(n=300, p=20, k_true=5, seed=12, intercept=0.5)
    X, y = ds.train.X.copy(), ds.train.y
    X[:, 3] *= 40.0
    X[:, 7] *= 0.02
    rng = np.random.default_rng(12)
    sw = rng.uniform(0.5, 2.0, size=len(y)).astype(np.float32)
    cfg = TConfig(tile_size=16, max_outer=400, tol=1e-13)

    sol = TSolver(X, y, config=cfg, sample_weight=sw, standardize=True,
                  fit_intercept=True, device="cpu")
    r = sol.fit(lam1=0.4, lam2=0.1)

    mu = (sw @ X) / sw.sum()
    sg = np.sqrt(np.maximum((sw @ (X ** 2)) / sw.sum() - mu ** 2, 0))
    Xs = ((X - mu) / sg).astype(np.float32)
    sol_m = TSolver(Xs, y, config=cfg, sample_weight=sw, fit_intercept=True,
                    device="cpu")
    r_m = sol_m.fit(lam1=0.4, lam2=0.1)
    beta_m = r_m.beta / sg
    b0_m = sol_m.intercept_ - float(mu @ beta_m)

    np.testing.assert_allclose(r.beta, beta_m, rtol=1e-3, atol=5e-3)
    assert sol.intercept_ == pytest.approx(b0_m, abs=5e-3)
    f = _obj(X, y, r.beta, 0.4, 0.0) \
        + 0.05 * float((np.asarray(r.beta) ** 2).sum())
    f_m = _obj(X, y, beta_m, 0.4, 0.0) \
        + 0.05 * float((np.asarray(beta_m) ** 2).sum())
    assert abs(f - f_m) <= 1e-3 * max(1.0, abs(f_m))


def test_standardize_sparse_scale_only():
    """Brick layouts standardize scale-only (no centering): the fit equals
    one on the explicitly column-scaled matrix."""
    ds = tsynth.make_sparse(n=300, p=128, avg_nnz=10, seed=13)
    X, y = ds.train.X, ds.train.y
    cfg = TConfig(tile_size=16, max_outer=300, tol=1e-13)
    sol = TSolver(X, y, config=cfg, standardize=True, device="cpu")
    r = sol.fit(lam1=0.5, lam2=0.1)

    Xd = X.to_dense()
    mu = Xd.mean(axis=0)
    sg = np.sqrt(np.maximum((Xd ** 2).mean(axis=0) - mu ** 2, 0))
    scale = np.where(sg > 1e-7, 1.0 / np.maximum(sg, 1e-30), 1.0)
    r_m = TSolver(Xd * scale[None, :], y, config=cfg, device="cpu") \
        .fit(lam1=0.5, lam2=0.1)
    np.testing.assert_allclose(r.beta, r_m.beta * scale, rtol=1e-2,
                               atol=1e-2)


def test_warm_start_roundtrip_with_standardize_and_intercept():
    """fit(beta0=fitted) under standardize and an intercept converges at
    once: the user-scale <-> packed-scale maps are a true inverse pair."""
    ds = tsynth.make_dense(n=250, p=20, k_true=5, seed=15, intercept=0.4)
    cfg = TConfig(tile_size=16, max_outer=300, tol=1e-13)
    s = TSolver(ds.train.X, ds.train.y, config=cfg, standardize=True,
                fit_intercept=True, device="cpu")
    cold = s.fit(lam1=0.3, lam2=0.1)
    warm = s.fit(lam1=0.3, lam2=0.1, beta0=cold.beta,
                 intercept0=s.intercept_)
    assert warm.n_iter <= 3
    np.testing.assert_allclose(warm.beta, cold.beta, rtol=1e-3, atol=2e-3)
