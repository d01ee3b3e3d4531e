"""The fused Jacobi superstep of repro_torch on the CPU against the JAX
package: the one-pass line search, the fused operations (the plain versions
of the stats_gram_solve and margin_ls kernels, and the brick route), the
Jacobi sweep, and whole fits.

The JAX fused operations are run on both their ``ref`` route and their
Pallas route (interpret mode).  Tolerances: 1e-5 (float32 sums in another
order) against ``ref``; 1e-4 on the stats against the Pallas route, whose
stats bodies differ from the oracle's in the tails (``test_fused.py``).
Whole fits use ``tol=0`` and a fixed superstep count: the same alpha every
superstep, f within 1e-5 relative and beta within 1e-5.  The reference's
own fused and unfused fits agree to 1.2e-7 at a fixed superstep count; a
stop rule that ends one superstep apart is a near-tie, not a fault.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (design <-> ops import cycle: core first)
from repro.core import cd as jcd
from repro.core import linesearch as jls
from repro.core.dglmnet import DGLMNETConfig as JConfig
from repro.core.solver import GLMSolver as JSolver
from repro.data import design as jdesign
from repro.data import synthetic as jsynth
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import cd as tcd
from repro_torch.core import linesearch as tls
from repro_torch.core.dglmnet import DGLMNETConfig as TConfig
from repro_torch.core.solver import GLMSolver as TSolver
from repro_torch.data import design as tdesign
from repro_torch.data import sparse as tsparse
from repro_torch.kernels import ops

FAMILIES = ["logistic", "squared", "probit", "poisson"]


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _labels(rng, family, n):
    if family in ("logistic", "probit"):
        return rng.choice([-1.0, 1.0], n).astype(np.float32)
    if family == "poisson":
        return rng.poisson(1.0, n).astype(np.float32)
    return rng.normal(size=n).astype(np.float32)


def _obs(rng, n, p):
    """weights (some zero), offset and penalty factors (one zero)."""
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    w[::11] = 0.0
    off = (0.1 * rng.normal(size=n)).astype(np.float32)
    pf = rng.uniform(0.5, 2.0, p).astype(np.float32)
    pf[0] = 0.0
    return w, off, pf


# ------------------------------------------------------------ line search


def test_full_candidates_match_jax():
    ours = tls.full_candidates(1e-3, 13, 0.5, 20, device="cpu").numpy()
    theirs = np.asarray(jls.full_candidates(1e-3, 13, 0.5, 20))
    assert ours.shape == (294,)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("seed", range(4))
def test_select_precomputed_matches_jax(seed):
    """Grid argmin, then its backtracking chain, from the same losses."""
    rng = np.random.default_rng(seed)
    p = 40
    cand = tls.full_candidates(1e-3, 13, 0.5, 20, device="cpu")
    beta = (rng.normal(size=p) * (rng.random(p) < 0.5)).astype(np.float32)
    dbeta = rng.normal(size=p).astype(np.float32)
    pf = rng.uniform(0.5, 1.5, p).astype(np.float32)
    # seed 0 accepts the unit step; the others force the backtracking
    base = 100.0 if seed == 0 else 50.0
    losses = (base + rng.normal(size=294) * 5).astype(np.float32)
    kw = dict(f_current=float(60.0 + seed), grad_dot_dir=-3.0 * (seed + 1),
              quad_form=1.5, sigma=0.01, gamma=0.1, grid_size=13,
              max_backtracks=20)
    got = tls.select_precomputed(t(losses), cand, t(beta), t(dbeta), 0.3,
                                 0.05, penf=t(pf), **kw)
    want = jls.select_precomputed(
        jnp.asarray(losses), jnp.asarray(cand.numpy()), jnp.asarray(beta),
        jnp.asarray(dbeta), 0.3, 0.05, penf=jnp.asarray(pf), **kw)
    assert float(got.alpha) == float(want.alpha)
    assert bool(got.accepted_unit) == bool(want.accepted_unit)
    assert float(got.f_new) == pytest.approx(float(want.f_new), rel=1e-6)
    assert float(got.D) == pytest.approx(float(want.D), rel=1e-6, abs=1e-6)


# ------------------------------------------------------- fused operations


def _dense_case(family, seed=9, n=256, p=256, T=128):
    rng = np.random.default_rng(seed)
    X = (0.2 * rng.normal(size=(n, p))).astype(np.float32)
    y = _labels(rng, family, n)
    beta = (0.5 * rng.normal(size=p) * (rng.random(p) < 0.3)) \
        .astype(np.float32)
    w, off, pf = _obs(rng, n, p)
    live = np.array([True, False])              # tile 1 screened out
    jd, _ = jdesign.dense_design(jnp.asarray(X), T)
    td, _ = tdesign.dense_design(X, T, device="cpu")
    return X, y, beta, w, off, pf, live, jd, td


@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("family", FAMILIES)
def test_fused_stats_sweep_dense_matches_jax(family, backend):
    X, y, beta, w, off, pf, live, jd, td = _dense_case(family)
    T = 128
    xb = X @ beta
    kw = dict(mu=1.5, nu=1e-6, lam1=0.1, lam2=0.05)
    got = ops.fused_stats_sweep(td, t(y), t(xb), t(beta), family,
                                weights=t(w), offset=t(off), penf=t(pf),
                                tile_live=live, **kw)
    want = jops.fused_stats_sweep(
        jd, jnp.asarray(y), jnp.asarray(xb), jnp.asarray(beta), family,
        weights=jnp.asarray(w), offset=jnp.asarray(off),
        penf=jnp.asarray(pf), tile_live=jnp.asarray(live), backend=backend,
        **kw)
    tol = 1e-5 if backend == "ref" else 1e-4
    for a, b, name in zip(got[:3], want[:3], ("loss", "s", "w")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol, err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=0, atol=tol, err_msg="dbeta")
    assert not got[3][T:].any()                # the dead tile stays put
    assert np.abs(got[3].numpy()).max() > 0    # the live one moved
    # G and g of the live tile; the dead tile's are zero
    for a, b in ((got[4], want[4]), (got[5], want[5])):
        a, b = a.numpy(), np.asarray(b)
        scale = max(np.abs(b[0]).max(), 1.0)
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=tol * scale)
        assert not a[1].any()


@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("family", FAMILIES)
def test_fused_ls_dense_matches_jax(family, backend):
    X, y, beta, w, off, _, _, jd, td = _dense_case(family, seed=10)
    rng = np.random.default_rng(11)
    xb = X @ beta
    dbeta = (0.3 * rng.normal(size=X.shape[1])).astype(np.float32)
    cand = tls.full_candidates(1e-3, 13, 0.5, 20, device="cpu")
    xdb, losses = ops.fused_ls(td, t(y), t(xb), t(dbeta), cand, family,
                               weights=t(w), offset=t(off))
    jxdb, jlosses = jops.fused_ls(
        jd, jnp.asarray(y), jnp.asarray(xb), jnp.asarray(dbeta),
        jnp.asarray(cand.numpy()), family, weights=jnp.asarray(w),
        offset=jnp.asarray(off), backend=backend)
    np.testing.assert_allclose(xdb.numpy(), np.asarray(jxdb), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-5, atol=1e-5)


def _brick_pair(seed, n=400, p=256, T=32, rb=32):
    ds = jsynth.make_sparse(n=n, p=p, avg_nnz=12, k_true=20, seed=seed)
    jd, _ = jdesign.build_block_sparse(ds.train.X, T, row_block=rb)
    td = convert.design_from_numpy(
        tile_size=T, bricks=np.asarray(jd.bricks),
        brick_row=np.asarray(jd.brick_row),
        brick_tile=np.asarray(jd.brick_tile),
        tile_ptr=np.asarray(jd.tile_ptr), row_block=rb, n_rows=jd.n_rows,
        device="cpu")
    return jd, td


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_route_bricks_matches_jax(family):
    jd, td = _brick_pair(12)
    n, p = td.shape
    rng = np.random.default_rng(13)
    y = _labels(rng, family, n)
    w, off, pf = _obs(rng, n, p)
    beta = (0.3 * rng.normal(size=p) * (rng.random(p) < 0.3)) \
        .astype(np.float32)
    xb = td.matvec(t(beta)).numpy()
    live = np.ones(td.n_tiles, bool)
    live[[1, 4]] = False
    kw = dict(mu=2.0, nu=1e-6, lam1=0.05, lam2=0.01)
    got = ops.fused_stats_sweep(td, t(y), t(xb), t(beta), family,
                                weights=t(w), offset=t(off), penf=t(pf),
                                tile_live=live, **kw)
    want = jops.fused_stats_sweep(
        jd, jnp.asarray(y), jnp.asarray(xb), jnp.asarray(beta), family,
        weights=jnp.asarray(w), offset=jnp.asarray(off),
        penf=jnp.asarray(pf), tile_live=jnp.asarray(live), backend="ref",
        **kw)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    G, Gj = got[4].numpy(), np.asarray(want[4])
    np.testing.assert_allclose(G[live], Gj[live], rtol=1e-5, atol=1e-5)
    assert not G[~live].any()
    cand = tls.full_candidates(1e-3, 13, 0.5, 20, device="cpu")
    xdb, losses = ops.fused_ls(td, t(y), t(xb), got[3], cand, family,
                               weights=t(w), offset=t(off))
    jxdb, jlosses = jops.fused_ls(
        jd, jnp.asarray(y), jnp.asarray(xb), jnp.asarray(got[3].numpy()),
        jnp.asarray(cand.numpy()), family, weights=jnp.asarray(w),
        offset=jnp.asarray(off), backend="ref")
    np.testing.assert_allclose(xdb.numpy(), np.asarray(jxdb), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-5, atol=1e-5)


def test_tiles3_is_a_view():
    X = np.arange(6 * 8, dtype=np.float32).reshape(6, 8)
    td, _ = tdesign.dense_design(X, 4, device="cpu")
    t3 = td.tiles3()
    assert t3.shape == (2, 6, 4)
    assert t3.data_ptr() == td.data.data_ptr()
    np.testing.assert_array_equal(t3[1].numpy(), X[:, 4:])


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_sweep_jacobi_matches_jax(kind):
    rng = np.random.default_rng(14)
    if kind == "dense":
        X = rng.normal(size=(120, 40)).astype(np.float32)
        X[:, -2:] = 0.0
        jd, _ = jdesign.dense_design(jnp.asarray(X), 16)
        td, _ = tdesign.dense_design(X, 16, device="cpu")
    else:
        jd, td = _brick_pair(15)
    n, p = td.shape
    s = rng.normal(size=n).astype(np.float32)
    w = rng.uniform(0.05, 0.25, n).astype(np.float32)
    beta = (0.2 * rng.normal(size=p)).astype(np.float32)
    active = (rng.random(p) < 0.8).astype(np.float32)
    pf = rng.uniform(0.5, 1.5, p).astype(np.float32)
    kw = dict(mu=1.0, nu=1e-6, lam1=0.2, lam2=0.05)
    d, xdb, done = tcd.sweep_jacobi(
        td, t(s), t(w), t(beta), torch.zeros(p), torch.zeros(n),
        active=t(active), penf=t(pf), **kw)
    jd_, jxdb, jdone = jcd.sweep_jacobi(
        jd, jnp.asarray(s), jnp.asarray(w), jnp.asarray(beta),
        jnp.zeros(p), jnp.zeros(n), active=jnp.asarray(active),
        penf=jnp.asarray(pf), **kw)
    assert done == int(jdone)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd_), atol=1e-5)
    np.testing.assert_allclose(xdb.numpy(), np.asarray(jxdb), rtol=1e-5,
                               atol=1e-5)
    assert not d.numpy()[active == 0].any()


# ---------------------------------------------------------------- fits


def _fit_problem(kind, family, seed):
    """(X for JAX, X for the port, y, observation model) of the whole-fit
    tests: make_dense(300, 48) at T = 16, make_sparse(400, 256) at T = 32."""
    if kind == "dense":
        ds = jsynth.make_dense(n=300, p=48, k_true=8, family=family,
                               seed=seed)
        X = Xt = ds.train.X
    else:
        ds = jsynth.make_sparse(n=400, p=256, avg_nnz=12, k_true=20,
                                family=family, seed=seed)
        X = ds.train.X
        Xt = tsparse.SparseCOO(X.rows, X.cols, X.vals, X.shape)
    y = ds.train.y
    w, off, pf = _obs(np.random.default_rng(seed + 1), len(y), X.shape[1])
    return X, Xt, y, dict(sample_weight=w, offset=off, penalty_factor=pf)


FIT_CASES = [("dense", "logistic", 5), ("dense", "squared", 5),
             ("dense", "probit", 5), ("dense", "poisson", 5),
             ("sparse", "logistic", 7), ("sparse", "squared", 7)]


@pytest.mark.parametrize("kind,family,seed", FIT_CASES)
def test_fused_fit_matches_jax(kind, family, seed):
    X, Xt, y, obs = _fit_problem(kind, family, seed)
    T = 16 if kind == "dense" else 32
    kw = dict(fit_intercept=True, row_block=32, **obs)
    js = JSolver(X, y, family=family, config=JConfig(
        family=family, tile_size=T, coupling="jacobi"), **kw)
    ts = TSolver(Xt, y, family=family, config=TConfig(
        family=family, tile_size=T, coupling="jacobi"), device="cpu", **kw)
    lmax = js.lambda_max()
    # the null fit behind lambda_max pins the intercept only to about
    # sqrt(eps) (ROADMAP Queue 3), hence 1e-4 here
    assert ts.lambda_max() == pytest.approx(lmax, rel=1e-4)
    ra = js.fit(lam1=0.1 * lmax, lam2=0.05, max_outer=8, tol=0.0)
    rb = ts.fit(lam1=0.1 * lmax, lam2=0.05, max_outer=8, tol=0.0)
    assert rb.n_iter == ra.n_iter == 8
    assert rb.history["alpha"] == ra.history["alpha"]
    np.testing.assert_allclose(rb.history["f"], ra.history["f"], rtol=1e-5)
    np.testing.assert_allclose(rb.beta, ra.beta, rtol=0, atol=1e-5)
    assert ts.intercept_ == pytest.approx(js.intercept_, abs=1e-5)
    assert np.abs(rb.beta).max() > 0


def test_fused_fit_matches_jax_pallas_route():
    """The same fit against the reference's accelerator route (its Pallas
    kernels in interpret mode and the one-pass line search)."""
    X, Xt, y, obs = _fit_problem("dense", "logistic", 5)
    kw = dict(fit_intercept=True, **obs)
    js = JSolver(X, y, config=JConfig(tile_size=16, coupling="jacobi",
                                      kernel_backend="pallas"), **kw)
    ts = TSolver(Xt, y, config=TConfig(tile_size=16, coupling="jacobi"),
                 device="cpu", **kw)
    lam1 = 0.1 * float(ts.lambda_max())
    ra = js.fit(lam1=lam1, lam2=0.05, max_outer=4, tol=0.0)
    rb = ts.fit(lam1=lam1, lam2=0.05, max_outer=4, tol=0.0)
    assert rb.history["alpha"] == ra.history["alpha"]
    np.testing.assert_allclose(rb.history["f"], ra.history["f"], rtol=1e-5)
    np.testing.assert_allclose(rb.beta, ra.beta, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_fused_matches_unfused_jacobi(kind):
    """The same Jacobi superstep fused and unfused, at a fixed superstep
    count: the same alpha, f within 1e-6 and beta within the 1e-5 bar (the
    two form G in another order: a batched product against one per tile)."""
    X, Xt, y, obs = _fit_problem(kind, "logistic", 5 if kind == "dense"
                                 else 7)
    T = 16 if kind == "dense" else 32
    fits = []
    for fused in (True, False):
        s = TSolver(Xt, y, config=TConfig(tile_size=T, coupling="jacobi",
                                          fuse_superstep=fused),
                    device="cpu", fit_intercept=True, row_block=32, **obs)
        fits.append(s.fit(lam1=0.1 * s.lambda_max(), lam2=0.05,
                          max_outer=10, tol=0.0))
    assert fits[0].history["alpha"] == fits[1].history["alpha"]
    np.testing.assert_allclose(fits[0].history["f"], fits[1].history["f"],
                               rtol=1e-6)
    np.testing.assert_allclose(fits[0].beta, fits[1].beta, rtol=0,
                               atol=1e-5)


def test_bf16_and_unknown_options_raise():
    """precision="bf16" (ported) builds and fits; unknown options raise."""
    X = np.random.default_rng(0).normal(size=(40, 6)).astype(np.float32)
    y = np.where(X[:, 0] > 0, 1.0, -1.0).astype(np.float32)
    s = TSolver(X, y, device="cpu", config=TConfig(
        tile_size=8, coupling="jacobi", precision="bf16"))
    res = s.fit(lam1=0.1 * s.lambda_max(), max_outer=3, tol=0.0)
    assert res.n_iter == 3 and np.isfinite(res.history["f"]).all()
    assert np.abs(res.beta).max() > 0
    for bad in (dict(precision="fp8"), dict(coupling="red-black")):
        with pytest.raises(ValueError):
            TSolver(X, y, device="cpu", config=TConfig(tile_size=8, **bad))
