"""repro_torch's GLMSolver on the CPU against the JAX GLMSolver (the unfused
Gauss-Seidel superstep, its default), on the dense and the brick layouts,
with the whole observation model: sample weights (some zero), offsets,
per-feature penalty factors and an intercept.

The bar is the reference's own: per superstep the same alpha and the same
unit-step decision, f within rtol 1e-5 (the same float32 sums in another
order); final beta within 1e-5; padded and dead coordinates exactly 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dglmnet as jdglmnet
from repro.core.dglmnet import DGLMNETConfig as JConfig
from repro.core.dglmnet import FitState as JState
from repro.core.solver import GLMSolver as JSolver
from repro.data import design as jdesign
from repro.data import synthetic as jsynth
from repro_torch import convert
from repro_torch.core import dglmnet as tdglmnet
from repro_torch.core import linesearch as tlinesearch
from repro_torch.core.dglmnet import DGLMNETConfig as TConfig
from repro_torch.core.solver import GLMSolver as TSolver
from repro_torch.data import sparse as tsparse


def _problem(kind, family, seed):
    """(X for JAX, X for the port, y, sample_weight, offset, penalty
    factors); the last three features are all zero (dead)."""
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
    rng = np.random.default_rng(seed)
    sw = rng.uniform(0.2, 2.0, n).astype(np.float32)
    sw[::9] = 0.0
    off = (rng.normal(size=n) * 0.2).astype(np.float32)
    pf = rng.uniform(0.5, 1.5, p).astype(np.float32)
    pf[0] = 0.0                                  # an unpenalized feature
    return X, Xt, y, sw, off, pf


CASES = [("dense", "logistic", 5), ("dense", "poisson", 5),
         ("sparse", "logistic", 5), ("sparse", "poisson", 6),
         ("dense", "squared", 9), ("sparse", "probit", 9)]


@pytest.mark.parametrize("kind,family,seed", CASES)
def test_fit_matches_jax(kind, family, seed):
    X, Xt, y, sw, off, pf = _problem(kind, family, seed)
    kw = dict(sample_weight=sw, offset=off, penalty_factor=pf,
              fit_intercept=True, row_block=32)
    js = JSolver(X, y, family=family,
                 config=JConfig(family=family, tile_size=16), **kw)
    ts = TSolver(Xt, y, family=family, config=TConfig(family=family,
                                                      tile_size=16),
                 device="cpu", **kw)
    lmax = js.lambda_max()
    # lambda_max is taken at the null model: both packages first fit the
    # unpenalized coordinates until f stops moving at float32 resolution,
    # which pins those coordinates only to about sqrt(eps); hence 1e-4 here
    # and 1e-5 in the closed-form case below
    assert ts.lambda_max() == pytest.approx(lmax, rel=1e-4)
    ra = js.fit(lam1=0.1 * lmax, lam2=0.01, max_outer=10, tol=0.0)
    rb = ts.fit(lam1=0.1 * lmax, lam2=0.01, max_outer=10, tol=0.0)
    assert ra.n_iter == rb.n_iter
    assert rb.history["alpha"] == ra.history["alpha"]
    assert rb.history["accepted_unit"] == ra.history["accepted_unit"]
    np.testing.assert_allclose(rb.history["f"], ra.history["f"], rtol=1e-5)
    np.testing.assert_allclose(rb.beta, ra.beta, rtol=0, atol=1e-5)
    assert ts.intercept_ == pytest.approx(js.intercept_, abs=1e-5)
    assert (rb.beta[-3:] == 0.0).all() and (ra.beta[-3:] == 0.0).all()
    # padded columns of the packed iterate stay exactly zero
    packed = ts._state.beta.numpy()
    used = ts.info.col_of_feature if ts.info.col_of_feature is not None \
        else np.arange(ts.info.shape[1])
    pad = np.setdiff1d(np.arange(packed.shape[0]), used)
    assert (packed[pad] == 0.0).all()
    Xd = X if kind == "dense" else X.to_dense()
    np.testing.assert_allclose(ts.predict(Xd[:20], offset=off[:20]),
                               js.predict(Xd[:20], offset=off[:20]),
                               rtol=1e-5, atol=1e-6)
    assert ts.score(Xd, y) == pytest.approx(js.score(Xd, y), abs=1e-6)


@pytest.mark.parametrize("kind,family", [("dense", "logistic"),
                                         ("sparse", "poisson"),
                                         ("sparse", "squared")])
def test_lambda_max_closed_form_matches_jax(kind, family):
    """Without unpenalized coordinates lambda_max = max_j |X^T s(0)|_j / pf_j
    at the zero margins plus offsets: no fit, the same sums."""
    X, Xt, y, sw, off, pf = _problem(kind, family, 3)
    pf[0] = 1.0
    kw = dict(sample_weight=sw, offset=off, penalty_factor=pf, row_block=32)
    js = JSolver(X, y, family=family,
                 config=JConfig(family=family, tile_size=16), **kw)
    ts = TSolver(Xt, y, family=family, config=TConfig(family=family,
                                                      tile_size=16),
                 device="cpu", **kw)
    assert ts.lambda_max() == pytest.approx(js.lambda_max(), rel=1e-5)


def _jax_design(kind, X, T, rb):
    if kind == "dense":
        return jdesign.dense_design(np.asarray(X), T)[0]
    return jdesign.build_block_sparse(X, T, row_block=rb)[0]


@pytest.mark.parametrize("kind,family", [("dense", "logistic"),
                                         ("sparse", "poisson")])
def test_supersteps_in_lock_step(kind, family):
    """Both supersteps from the very same packed design and state, step
    after step: the port's design and state are carried over from the JAX
    ones with ``convert`` before every step, so no drift accumulates."""
    X, _, y, sw, off, pf = _problem(kind, family, 11)
    T, rb = 16, 32
    jd = _jax_design(kind, X, T, rb)
    if kind == "dense":
        td = convert.design_from_numpy(tile_size=T, data=np.asarray(jd.data),
                                       device="cpu")
    else:
        td = convert.design_from_numpy(
            tile_size=T, bricks=np.asarray(jd.bricks),
            brick_row=np.asarray(jd.brick_row),
            brick_tile=np.asarray(jd.brick_tile),
            tile_ptr=np.asarray(jd.tile_ptr), row_block=rb,
            n_rows=jd.n_rows, device="cpu")
    n_rows, p_pad = td.shape
    nt = td.n_tiles
    pad = n_rows - len(y)
    yv = np.pad(y, (0, pad), constant_values=1.0)
    wv = np.pad(sw, (0, pad))
    ov = np.pad(off, (0, pad))
    pfv = np.ones(p_pad, np.float32)
    pfv[:len(pf)] = pf                  # packed order is irrelevant here
    lams = (0.5, 0.05)
    jstep = jax.jit(jdglmnet.make_superstep(JConfig(family=family,
                                                    tile_size=T),
                                            n_tiles_local=nt))
    tstep = tdglmnet.make_superstep(TConfig(family=family, tile_size=T),
                                    n_tiles=nt, device="cpu")
    state = JState(jnp.zeros(p_pad), jnp.zeros(n_rows), jnp.float32(1.0),
                   jnp.zeros((1,), jnp.int32), jnp.int32(0))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    for _ in range(6):
        tstate = convert.state_from_numpy(state.beta, state.xb, state.mu,
                                          state.cursor, state.step,
                                          device="cpu")
        new_t, mt = tstep(td, t(yv), t(wv), t(ov), lams, t(pfv), tstate)
        state, mj = jstep(jd, jnp.asarray(yv), jnp.asarray(wv),
                          jnp.asarray(ov), jnp.full((1,), nt, jnp.int32),
                          jnp.asarray(lams, jnp.float32),
                          jnp.ones(p_pad, jnp.float32), jnp.asarray(pfv),
                          state)
        assert float(mt["alpha"]) == float(mj["alpha"])
        assert int(mt["accepted_unit"]) == int(mj["accepted_unit"])
        assert int(mt["nnz"]) == int(mj["nnz"])
        for k in ("f", "f_before", "loss", "mu", "D"):
            assert float(mt[k]) == pytest.approx(float(mj[k]), rel=1e-5,
                                                 abs=1e-6), k
        np.testing.assert_allclose(new_t.beta.numpy(),
                                   np.asarray(state.beta), atol=1e-5)
        np.testing.assert_allclose(new_t.xb.numpy(), np.asarray(state.xb),
                                   rtol=1e-5, atol=1e-5)
        assert new_t.cursor == int(state.cursor[0])


def test_candidate_alphas_match_jax():
    from repro.core import linesearch as jlinesearch
    ours = tlinesearch.candidate_alphas(1e-3, 13, device="cpu").numpy()
    theirs = np.asarray(jlinesearch.candidate_alphas(1e-3, 13))
    np.testing.assert_array_equal(ours, theirs)
    bt = tlinesearch.backtrack_chains(torch.from_numpy(ours[:3]), 0.5, 20)
    np.testing.assert_array_equal(
        bt.numpy(), np.asarray(jlinesearch.backtrack_chains(
            jnp.asarray(ours[:3]), 0.5, 20)))


def test_no_card_no_silent_cpu(monkeypatch):
    X = np.zeros((8, 4), np.float32)
    y = np.ones(8, np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSolver(X, y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSolver(X, y, device="cuda")


def test_unported_options_raise(tmp_path):
    X = np.random.default_rng(0).normal(size=(40, 6)).astype(np.float32)
    y = np.where(X[:, 0] > 0, 1.0, -1.0).astype(np.float32)
    kw = dict(device="cpu", config=TConfig(tile_size=8))
    with pytest.raises(NotImplementedError):
        TSolver(X, y, **kw, mesh=object())
    s = TSolver(X, y, **kw)
    r0 = s.fit(lam1=0.1, max_outer=3)
    # ported since: the Jacobi coupling, its precision="bf16", predict
    # on SparseCOO rows, standardize=True, fit_path and fit_cv, the
    # checkpoints of fit and fit_path, and streaming (whose chunk-cursor
    # saves an in-memory fit ignores, as the reference does)
    r1 = s.fit(lam1=0.1, max_outer=3, ckpt_every_chunks=2)
    np.testing.assert_array_equal(r1.beta, r0.beta)
    from repro_torch.checkpoint import CheckpointManager
    s.fit(lam1=0.1, max_outer=3, ckpt_every=1,
          ckpt_manager=CheckpointManager(tmp_path / "fit"))
    assert CheckpointManager(tmp_path / "fit").latest_step() == 3
    s.fit_path(n_lambdas=3, max_outer=3,
               ckpt_manager=CheckpointManager(tmp_path / "path"))
    assert CheckpointManager(tmp_path / "path").latest_step() == 3
    TSolver(X, y, device="cpu", config=TConfig(tile_size=8,
                                               coupling="jacobi"))
    sb = TSolver(X, y, device="cpu", config=TConfig(
        tile_size=8, coupling="jacobi", precision="bf16"))
    assert np.isfinite(sb.fit(lam1=0.1, max_outer=3).history["f"]).all()
    out = s.predict(tsparse.SparseCOO(np.zeros(1, np.int64),
                                      np.zeros(1, np.int64),
                                      np.ones(1, np.float32), (1, 6)))
    assert out.shape == (1,)
    ss = TSolver(X, y, **kw, standardize=True)
    assert np.isfinite(ss.fit_path(n_lambdas=3, max_outer=3).f).all()
    assert np.isfinite(ss.fit_cv(n_folds=2, n_lambdas=3,
                                 max_outer=3).dev_mean).all()


def test_builders_default_to_the_card(monkeypatch):
    """Every public entry point that places tensors takes device=None as
    the card, and raises without one instead of running on the CPU."""
    from repro_torch.core.solver import lambda_max
    from repro_torch.data import design as tdesign
    from repro_torch.serve import ScoringEngine, ServableModel
    X = np.ones((8, 4), np.float32)
    coo = tsparse.SparseCOO(np.arange(4), np.arange(4),
                            np.ones(4, np.float32), (8, 4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: tdesign.dense_design(X, 4),
        lambda: tdesign.build_block_sparse(coo, 4, row_block=4),
        lambda: tdesign.as_design(X, 4),
        lambda: lambda_max(X, np.ones(8, np.float32)),
        lambda: lambda_max(coo, np.ones(8, np.float32)),
        lambda: convert.design_from_numpy(tile_size=4, data=X),
        lambda: convert.state_from_numpy(np.zeros(4), np.zeros(8), 1.0),
        lambda: tlinesearch.candidate_alphas(1e-3, 13),
        lambda: tlinesearch.full_candidates(1e-3, 13, 0.5, 20),
        lambda: tdglmnet.make_superstep(TConfig(tile_size=4), n_tiles=1),
        lambda: ScoringEngine(ServableModel(
            betas=np.ones((1, 4), np.float32),
            intercepts=np.zeros(1, np.float32), family="squared")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
