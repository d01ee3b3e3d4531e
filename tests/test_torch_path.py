"""repro_torch's warm-started lambda path (``GLMSolver.fit_path``) on the CPU
against the JAX package's, the reference's path contracts written against
the port, the module-level ``lambda_max`` and path artifacts.

Parity cases run dense and brick layouts, Gauss-Seidel and fused Jacobi,
with and without strong-rule screening, with the whole observation model
(weights with zeros, offsets, penalty factors with a zero, an intercept)
and without it.  The JAX side runs as ``tests/test_solver.py`` runs it.
Bar per lambda, the reference's: beta within 1e-5, f within rtol 1e-5, the
same nnz and n_iters; dead and padded coordinates exactly 0.

``tol=1e-4``: the paths stop well before float32 resolution.  Closer to
convergence the stop rule and the Armijo test compare sums at float32
resolution, and the two packages part there (ROADMAP Queue 3 items 4-6).
At the head of a grid without unpenalized coordinates, lambda_0 =
lambda_max puts the coordinate that sets it at its soft threshold to the
last bit: either package may leave it at 0 or at about 1e-7
(``test_path_head_is_a_tie`` shows the margin), so there nnz may differ by
that one coordinate, held to the beta bar.
"""
import numpy as np
import pytest
import torch

from repro.core.dglmnet import DGLMNETConfig as JConfig
from repro.core.solver import GLMSolver as JSolver
from repro.core.solver import lambda_max as jlambda_max
from repro.data import synthetic as jsynth
from repro.serve import ScoringEngine as JEngine
from repro.serve import load_artifact as jload
from repro_torch.core import glm as tglm
from repro_torch.core.dglmnet import DGLMNETConfig as TConfig
from repro_torch.core.solver import GLMSolver as TSolver
from repro_torch.core.solver import PathResult
from repro_torch.core.solver import lambda_max as tlambda_max
from repro_torch.data import sparse as tsparse
from repro_torch.data import synthetic as tsynth
from repro_torch.serve import ScoringEngine, load_artifact


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These problems are a few hundred rows: torch's intra-op threads buy
    nothing there and, beside the other test workers, spin on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(kind, family, seed, obs=True):
    """(X for JAX, X for the port, y, solver kwargs); the last three
    features are all zero (dead)."""
    if kind == "dense":
        ds = jsynth.make_dense(n=300, p=43, k_true=8, family=family,
                               seed=seed)
        X = ds.train.X.copy()
        X[:, -3:] = 0.0
        Xt = X
    else:
        ds = jsynth.make_sparse(n=400, p=93, avg_nnz=10, k_true=20,
                                family=family, seed=seed)
        X = ds.train.X
        keep = X.cols < 90                       # features 90..92 empty
        X = type(X)(X.rows[keep], X.cols[keep], X.vals[keep], X.shape)
        Xt = tsparse.SparseCOO(X.rows, X.cols, X.vals, X.shape)
    y = ds.train.y
    n, p = len(y), X.shape[1]
    kw = dict(row_block=32)
    if obs:
        rng = np.random.default_rng(seed)
        sw = rng.uniform(0.2, 2.0, n).astype(np.float32)
        sw[::9] = 0.0
        off = (rng.normal(size=n) * 0.2).astype(np.float32)
        pf = rng.uniform(0.5, 1.5, p).astype(np.float32)
        pf[0] = 0.0                              # an unpenalized feature
        kw.update(sample_weight=sw, offset=off, penalty_factor=pf,
                  fit_intercept=True)
    return X, Xt, y, kw


def _pair(kind, family, seed, coupling, obs=True, **cfg):
    X, Xt, y, kw = _problem(kind, family, seed, obs)
    cfg = dict(family=family, tile_size=16, coupling=coupling, **cfg)
    js = JSolver(X, y, family=family, config=JConfig(**cfg), **kw)
    ts = TSolver(Xt, y, family=family, config=TConfig(**cfg), device="cpu",
                 **kw)
    return js, ts, kw.get("penalty_factor", np.ones(X.shape[1], np.float32))


def _assert_paths_match(pj, pt):
    np.testing.assert_array_equal(pt.n_iters, pj.n_iters)
    np.testing.assert_allclose(pt.f, pj.f, rtol=1e-5)
    np.testing.assert_allclose(pt.betas, pj.betas, rtol=0, atol=1e-5)
    if pj.intercepts is not None:
        np.testing.assert_allclose(pt.intercepts, pj.intercepts, atol=1e-5)
    np.testing.assert_array_equal(pt.converged, pj.converged)
    np.testing.assert_array_equal(pt.nnz[1:], pj.nnz[1:])
    # the head: the same support but for a coordinate at its threshold
    # (see the module docstring), which the beta bar above already holds
    part = (pt.betas[0] != 0) != (pj.betas[0] != 0)
    assert part.sum() <= 1 and abs(int(pt.nnz[0]) - int(pj.nnz[0])) <= 1
    np.testing.assert_array_equal(pt.lambdas, pj.lambdas)


def _dead_and_padded_zero(ts, path):
    assert (path.betas[:, -3:] == 0.0).all()
    packed = ts._state.beta.numpy()
    used = ts.info.col_of_feature if ts.info.col_of_feature is not None \
        else np.arange(ts.info.shape[1])
    assert (np.delete(packed, used) == 0.0).all()


# family and seed by layout and observation model
CASES = {("dense", True): ("logistic", 5), ("dense", False): ("poisson", 6),
         ("sparse", True): ("logistic", 5), ("sparse", False): ("squared", 9)}


@pytest.mark.parametrize("screen", [True, False])
@pytest.mark.parametrize("obs", [True, False])
@pytest.mark.parametrize("coupling", ["gauss-seidel", "jacobi"])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_path_matches_jax(kind, coupling, obs, screen):
    family, seed = CASES[kind, obs]
    js, ts, pf = _pair(kind, family, seed, coupling, obs, max_outer=60,
                       tol=1e-4)
    pj = js.fit_path(n_lambdas=8, lam_ratio=1e-2, lam2=0.01, screen=screen)
    # with an unpenalized coordinate lambda_max agrees only to ~1e-4
    # (ROADMAP Queue 3 item 3), so the port takes JAX's grid
    pt = ts.fit_path(lambdas=pj.lambdas, lam2=0.01, screen=screen)
    assert isinstance(pt, PathResult)
    _assert_paths_match(pj, pt)
    _dead_and_padded_zero(ts, pt)
    np.testing.assert_array_equal(ts.beta_, pt.betas[-1])
    if obs:
        assert ts.intercept_ == pytest.approx(js.intercept_, abs=1e-5)
    assert pt.nnz[-1] > pt.nnz[0]
    if not obs:
        # the head is zero in the penalized coordinates (but for the tie;
        # with unpenalized ones tol=1e-4 stops the head before they settle)
        assert np.abs(pt.betas[0][pf > 0]).max() < 1e-6


@pytest.mark.parametrize("kind,family", [("dense", "logistic"),
                                         ("sparse", "poisson")])
def test_default_grid_matches_jax(kind, family):
    """Without unpenalized coordinates lambda_max is closed-form and the
    default grids agree to rtol 1e-6; the paths on them to the bar."""
    js, ts, _ = _pair(kind, family, 3, "gauss-seidel", obs=False,
                      max_outer=60, tol=1e-4)
    pj = js.fit_path(n_lambdas=6, lam_ratio=0.05)
    pt = ts.fit_path(n_lambdas=6, lam_ratio=0.05)
    np.testing.assert_allclose(pt.lambdas, pj.lambdas, rtol=1e-6)
    np.testing.assert_array_equal(pt.n_iters, pj.n_iters)
    np.testing.assert_allclose(pt.betas, pj.betas, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,coupling,family,seed", [
    ("sparse", "gauss-seidel", "squared", 9),
    ("sparse", "jacobi", "logistic", 5)])
def test_path_head_is_a_tie(kind, coupling, family, seed):
    """At lambda_0 = lambda_max the coordinate that sets lambda_max has
    |g_j| = lambda_0 pf_j in float32: its soft threshold decides 0 or
    about 1e-7 by the last bits of two sums in another order.  The parts
    of the two packages' heads are that coordinate only, at that margin."""
    js, ts, _ = _pair(kind, family, seed, coupling, obs=False,
                      max_outer=60, tol=1e-4)
    pj = js.fit_path(n_lambdas=8, lam_ratio=1e-2)
    pt = ts.fit_path(lambdas=pj.lambdas)
    part = np.flatnonzero((pt.betas[0] != 0) != (pj.betas[0] != 0))
    assert len(part) == 1
    j = int(part[0])
    assert max(abs(pt.betas[0, j]), abs(pj.betas[0, j])) < 1e-6
    g0 = np.abs(ts._grad_state(ts._init_state(None)))
    col = ts.info.col_of_feature[j]
    margin = abs(g0[col] / pj.lambdas[0] - 1.0)
    assert margin <= 4 * np.finfo(np.float32).eps, margin
    assert g0[col] == g0.max()


# ----------------------------------------- the reference's path contracts


def _obj(family, X, y, beta, lam1, lam2):
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return float(tglm.objective(family, t(y), t(X), t(beta), lam1, lam2))


@pytest.mark.parametrize("screen", [True, False])
def test_path_matches_cold_fits_dense(screen):
    """fit_path at every grid point reaches the objective of a cold fit
    there (1e-5 relative); the head is all zero, the support grows."""
    ds = tsynth.make_dense(n=300, p=48, seed=7)
    X, y = ds.train.X, ds.train.y
    cfg = TConfig(tile_size=16, max_outer=150, tol=1e-12)
    s = TSolver(X, y, config=cfg, device="cpu")
    path = s.fit_path(n_lambdas=8, lam_ratio=1e-2, screen=screen)
    assert isinstance(path, PathResult)
    for k in (0, 3, 7):
        lam1 = float(path.lambdas[k])
        f_cold = _obj("logistic", X, y, s.fit(lam1=lam1, lam2=0.0).beta,
                      lam1, 0.0)
        f_warm = _obj("logistic", X, y, path.betas[k], lam1, 0.0)
        assert f_warm <= f_cold + 1e-5 * max(1.0, abs(f_cold)), \
            (k, f_warm, f_cold)
    assert path.nnz[0] == 0
    assert path.nnz[-1] > 0


def test_path_matches_cold_fits_sparse_jacobi():
    ds = tsynth.make_sparse(n=400, p=256, avg_nnz=16, seed=8)
    X, y = ds.train.X, ds.train.y
    cfg = TConfig(tile_size=16, coupling="jacobi", max_outer=150,
                  tol=1e-12)
    s = TSolver(X, y, config=cfg, device="cpu")
    path = s.fit_path(n_lambdas=6, lam_ratio=1e-2)
    Xd = X.to_dense()
    for k in (2, 5):
        lam1 = float(path.lambdas[k])
        f_cold = _obj("logistic", Xd, y, s.fit(lam1=lam1, lam2=0.0).beta,
                      lam1, 0.0)
        f_warm = _obj("logistic", Xd, y, path.betas[k], lam1, 0.0)
        assert f_warm <= f_cold + 1e-5 * max(1.0, abs(f_cold))


def test_path_warm_start_saves_iterations():
    """Total supersteps over the warm path undercut cold fits at the same
    grid (the amortization claim of the session API)."""
    ds = tsynth.make_dense(n=300, p=64, seed=9)
    cfg = TConfig(tile_size=16, max_outer=200, tol=1e-10)
    s = TSolver(ds.train.X, ds.train.y, config=cfg, device="cpu")
    path = s.fit_path(n_lambdas=10, lam_ratio=1e-2)
    cold_iters = sum(s.fit(lam1=float(l), lam2=0.0).n_iter
                     for l in path.lambdas)
    assert path.n_iters.sum() < cold_iters


def test_path_rejects_increasing_grid(tmp_path):
    ds = tsynth.make_dense(n=100, p=32, k_true=4, seed=10)
    s = TSolver(ds.train.X, ds.train.y, config=TConfig(tile_size=16),
                device="cpu")
    with pytest.raises(ValueError, match="decreasing"):
        s.fit_path(lambdas=[0.1, 1.0, 10.0])
    # the grid is checked before a checkpoint is read or written
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(ValueError, match="decreasing"):
        s.fit_path(lambdas=[0.1, 1.0, 10.0], ckpt_manager=mgr)
    assert mgr.latest_step() is None


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_screened_tiles_cost_zero_sweep_launches(kind):
    """Along a screened path, tiles with no active coordinate are skipped
    and the host bookkeeping balances exactly (live + skipped =
    supersteps x tiles) for Gauss-Seidel and fused Jacobi; the unfused
    Jacobi superstep is counted as sweeping every tile (as the reference
    counts it).  The counts equal JAX's on the same path."""
    if kind == "dense":
        ds = jsynth.make_dense(n=400, p=128, k_true=6, seed=10)
        X = Xt = ds.train.X
    else:
        ds = jsynth.make_sparse(n=400, p=128, avg_nnz=8, k_true=6, seed=10)
        X = ds.train.X
        Xt = tsparse.SparseCOO(X.rows, X.cols, X.vals, X.shape)
    y = ds.train.y
    n_tiles = 128 // 16
    for coupling, fused in (("gauss-seidel", True), ("jacobi", True),
                            ("jacobi", False)):
        cfg = dict(tile_size=16, coupling=coupling, fuse_superstep=fused,
                   max_outer=60, tol=1e-4)
        s = TSolver(Xt, y, config=TConfig(**cfg), device="cpu",
                    row_block=32)
        js = JSolver(X, y, config=JConfig(**cfg), row_block=32)
        pj = js.fit_path(n_lambdas=8, lam_ratio=1e-2)
        s.fit_path(lambdas=pj.lambdas)
        st = s.launch_stats
        assert st["supersteps"] > 0
        assert st["sweep_tile_launches"] + st["sweep_tiles_skipped"] \
            == st["supersteps"] * n_tiles, st
        if fused:
            assert st["sweep_tiles_skipped"] > 0, st
        else:
            assert st["sweep_tiles_skipped"] == 0, st
        assert st == js.launch_stats, (coupling, fused)


# ------------------------------------------------ lambda_max and artifacts


@pytest.mark.parametrize("with_pf", [False, True])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_module_lambda_max_matches_jax(kind, with_pf):
    X, Xt, y, kw = _problem(kind, "logistic", 4)
    pf = kw["penalty_factor"] if with_pf else None
    args = dict(sample_weight=kw["sample_weight"], offset=kw["offset"],
                penalty_factor=pf)
    want = jlambda_max(X, y, "logistic", **args)
    got = tlambda_max(Xt, y, "logistic", device="cpu", **args)
    assert got == pytest.approx(want, rel=1e-6)
    # without penalty factors and weights: the session's closed form
    s = TSolver(Xt, y, config=TConfig(tile_size=16), device="cpu",
                row_block=32)
    assert s.lambda_max() == pytest.approx(
        tlambda_max(Xt, y, "logistic", device="cpu"), rel=1e-5)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_path_artifact_both_ways(tmp_path, writer):
    """save(path_result=) writes one column per lambda with the grid in
    the manifest; the port and JAX read each other's, and both engines
    score it within 1e-5."""
    js, ts, _ = _pair("sparse", "logistic", 5, "gauss-seidel", max_outer=60,
                      tol=1e-4)
    pj = js.fit_path(n_lambdas=5, lam_ratio=0.05)
    pt = ts.fit_path(lambdas=pj.lambdas)
    if writer == "port":
        ts.save(tmp_path / "m", path_result=pt)
    else:
        js.save(tmp_path / "m", path_result=pj)
    mt, mj = load_artifact(tmp_path / "m"), jload(tmp_path / "m")
    for m in (mt, mj):
        assert m.n_outputs == 5 and m.standardized is False
        np.testing.assert_allclose(m.lambdas, pj.lambdas, rtol=1e-12)
    np.testing.assert_array_equal(mt.betas, mj.betas)
    np.testing.assert_array_equal(mt.intercepts, mj.intercepts)
    want = pt if writer == "port" else pj
    np.testing.assert_array_equal(mt.betas, want.betas)
    X, _, _, _ = _problem("sparse", "logistic", 5)
    Xq = tsparse.SparseCOO(X.rows, X.cols, X.vals, X.shape)
    got = ScoringEngine(mt, device="cpu").score_coo(Xq, kind="response")
    ref = np.asarray(JEngine(mj).score_coo(X, kind="response"))
    assert got.shape == (X.shape[0], 5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # the last column is the session's own fit
    np.testing.assert_allclose(
        got[:, -1], ts.predict(Xq, kind="response"), rtol=1e-6, atol=1e-7)
