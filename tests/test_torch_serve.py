"""repro_torch.serve on the CPU against the JAX package's repro.serve:
artifacts in both directions, the scoring engine and the plain version of
the predict_tile kernel against JAX's, the micro-batcher's contracts, and
``GLMSolver.predict`` on SparseCOO rows through the engine.

Tolerances: scores within 1e-5 (float32 sums in another order); int8
margins within the manifest's bound (scale / 2) ||x||_1.  The estimators'
save and load are held against JAX's in ``tests/test_torch_estimators.py``.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import glm as jglm
from repro.kernels import ref as jref
from repro.serve import ScoringEngine as JEngine
from repro.serve import load_artifact as jload
from repro.serve import save_artifact as jsave
from repro_torch.core import glm as tglm
from repro_torch.core.dglmnet import DGLMNETConfig
from repro_torch.core.solver import GLMSolver
from repro_torch.data.sparse import SparseCOO
from repro_torch.kernels import ops, ref
from repro_torch.serve import (MicroBatcher, ScoringEngine, artifact_bytes,
                               export, load_artifact, quantize_int8,
                               save_artifact)
from repro_torch.serve import artifact as artifact_lib
from repro_torch.serve.batcher import _bucket_up
from repro_torch.serve.engine import coo_to_requests

FAMILIES = ("logistic", "squared", "probit", "poisson")


def _problem(family, n=120, p=24, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    beta = np.zeros(p, np.float32)
    beta[: p // 4] = rng.normal(size=p // 4)
    m = X @ beta + 0.1 * rng.normal(size=n)
    if family in ("logistic", "probit"):
        y = np.where(m > 0, 1.0, -1.0)
    elif family == "poisson":
        y = rng.poisson(np.exp(np.clip(m, None, 3.0)))
    else:
        y = m
    return X, np.asarray(y, np.float32), rng


def _fit(family, X, y, **kw):
    solver = GLMSolver(X, y, family=family, device="cpu",
                       config=DGLMNETConfig(tile_size=8, max_outer=60,
                                            tol=1e-9), **kw)
    solver.fit(lam1=0.05, lam2=0.01)
    return solver


def _sparse_requests(rng, n_req, p, nnz_max=10):
    reqs = []
    for _ in range(n_req):
        k = int(rng.integers(1, nnz_max))
        idx = rng.choice(p, size=k, replace=False)
        reqs.append((idx, rng.normal(size=k).astype(np.float32)))
    return reqs


def _model(K=3, p=40, seed=4, family="logistic", density=0.3):
    rng = np.random.default_rng(seed)
    betas = (rng.normal(size=(K, p)) *
             (rng.random((K, p)) < density)).astype(np.float32)
    b0 = rng.normal(size=K).astype(np.float32)
    return betas, b0, rng


def _engine(betas, b0, family):
    return ScoringEngine(artifact_lib.ServableModel(
        betas=betas, intercepts=b0, family=family), device="cpu")


# ---------------------------------------------------------------- artifacts


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_artifacts_cross_load(tmp_path, writer, quantize):
    """An artifact written by either package loads in the other with the
    same table, intercepts, lambdas and quantization record."""
    betas, b0, _ = _model(K=2, p=30, seed=1)
    save = jsave if writer == "jax" else save_artifact
    load = load_artifact if writer == "jax" else jload
    save(tmp_path / "m", betas=betas, intercepts=b0, family="probit",
         lambdas=[0.2, 0.1], lam2=0.01, quantize=quantize)
    got = load(tmp_path / "m")
    want = (jload if writer == "jax" else load_artifact)(tmp_path / "m")
    np.testing.assert_array_equal(got.betas, want.betas)
    np.testing.assert_array_equal(got.intercepts, want.intercepts)
    np.testing.assert_array_equal(got.lambdas, want.lambdas)
    assert (got.family, got.lam2, got.quant, got.version) == \
        (want.family, want.lam2, want.quant, want.version)


@pytest.mark.parametrize("family", FAMILIES)
def test_roundtrip_parity_with_solver_predict(tmp_path, family):
    """save -> load -> engine score == solver.predict, all four families,
    with an intercept and a prediction offset; JAX loads the same file."""
    X, y, rng = _problem(family)
    solver = _fit(family, X, y, fit_intercept=True)
    art = solver.save(tmp_path / family)
    eng = ScoringEngine(load_artifact(art), device="cpu")
    X_new = rng.normal(size=(17, X.shape[1])).astype(np.float32)
    off = rng.normal(size=17).astype(np.float32) * 0.1
    for kind in ("link", "response"):
        want = solver.predict(X_new, offset=off, kind=kind)
        got = eng.score_dense(X_new, kind=kind, offset=off)[:, 0]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    j = jload(art)
    np.testing.assert_array_equal(j.betas[0], solver.beta_)
    assert float(j.intercepts[0]) == solver.intercept_


def test_versioning_rejects_unknown(tmp_path):
    save_artifact(tmp_path / "m", betas=np.ones((1, 3), np.float32),
                  family="squared")
    mf = tmp_path / "m" / artifact_lib.MANIFEST
    rec = json.loads(mf.read_text())
    rec["version"] = artifact_lib.VERSION + 1
    mf.write_text(json.dumps(rec))
    with pytest.raises(ValueError, match="newer"):
        load_artifact(tmp_path / "m")
    rec["version"] = artifact_lib.VERSION
    rec["format"] = "something-else"
    mf.write_text(json.dumps(rec))
    with pytest.raises(ValueError, match="format"):
        load_artifact(tmp_path / "m")
    rec["format"] = artifact_lib.FORMAT
    rec["intercepts"] = [0.0, 0.0]          # 2 intercepts, 1 output
    mf.write_text(json.dumps(rec))
    with pytest.raises(ValueError, match="intercepts"):
        load_artifact(tmp_path / "m")


def test_servable_model_is_immutable_and_copies(tmp_path):
    save_artifact(tmp_path / "m", betas=np.ones((2, 3), np.float32),
                  family="squared")
    m = load_artifact(tmp_path / "m")
    with pytest.raises(ValueError):
        m.betas[0, 0] = 5.0
    mine = np.ones((1, 4), np.float32)
    artifact_lib.ServableModel(betas=mine,
                               intercepts=np.zeros(1, np.float32),
                               family="squared")
    mine[0, 0] = 7.0                   # the caller's array stays writable


def test_int8_quantization_bounds(tmp_path):
    """Shared-scale int8: per-element error <= scale/2; scored margins
    within (scale/2) ||x||_1 of fp32; the artifact >= 2x smaller."""
    rng = np.random.default_rng(3)
    K, p = 6, 800
    betas = (rng.normal(size=(K, p)) *
             (rng.random((K, p)) < 0.3)).astype(np.float32)
    q, scale = quantize_int8(betas)
    assert np.abs(q.astype(np.float32) * scale - betas).max() \
        <= scale / 2 + 1e-7
    qz, sz = quantize_int8(np.zeros((2, 4), np.float32))
    assert (qz == 0).all() and (qz.astype(np.float32) * sz == 0).all()
    b0 = rng.normal(size=K).astype(np.float32)
    save_artifact(tmp_path / "fp32", betas=betas, intercepts=b0,
                  family="logistic")
    save_artifact(tmp_path / "int8", betas=betas, intercepts=b0,
                  family="logistic", quantize="int8")
    assert artifact_bytes(tmp_path / "fp32") \
        >= 2.0 * artifact_bytes(tmp_path / "int8")
    m8 = load_artifact(tmp_path / "int8")
    assert m8.quant["mode"] == "int8"
    e32 = ScoringEngine(load_artifact(tmp_path / "fp32"), device="cpu")
    e8 = ScoringEngine(m8, device="cpu")
    reqs = _sparse_requests(rng, 40, p, nnz_max=30)
    m_fp = e32.score_sparse(reqs, kind="link")
    m_i8 = e8.score_sparse(reqs, kind="link")
    for i, (_, val) in enumerate(reqs):
        bound = m8.margin_error_bound(np.abs(val).sum())
        assert np.abs(m_fp[i] - m_i8[i]).max() <= bound + 1e-6


def test_export_takes_a_solver_only(tmp_path):
    """A solver or an estimator (duck-typed, as in JAX: ``coef_``,
    ``intercept_``, ``family``) exports; anything else raises."""
    class Estimator:
        coef_ = np.asarray([1.0, 0.0, -2.0], np.float32)
        intercept_ = 0.5
        family = "logistic"
        lam1_ = 0.25
        lam2 = 0.1
        classes_ = np.asarray([0, 1])

    from repro.serve import export as jexport
    export(Estimator(), tmp_path / "e")
    jexport(Estimator(), tmp_path / "je")
    got, want = jload(tmp_path / "e"), jload(tmp_path / "je")
    np.testing.assert_array_equal(got.betas, want.betas)
    np.testing.assert_array_equal(got.intercepts, want.intercepts)
    assert (got.family, got.lam2, got.penalty, got.extra,
            got.standardized) == (want.family, want.lam2, want.penalty,
                                  want.extra, want.standardized)
    np.testing.assert_array_equal(got.lambdas, want.lambdas)
    with pytest.raises(TypeError):
        export(object(), tmp_path / "o")
    X, y, _ = _problem("squared", n=40, p=8)
    unfitted = GLMSolver(X, y, family="squared", device="cpu",
                         config=DGLMNETConfig(tile_size=8))
    with pytest.raises(ValueError, match="not fitted"):
        export(unfitted, tmp_path / "u")


# ------------------------------------------------------------------ engine


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kind", ("link", "response"))
def test_engine_matches_jax_engine(family, kind):
    """Sparse requests, a SparseCOO with an offset and dense rows, L = 3
    outputs, against JAX's engine on its oracle route."""
    betas, b0, rng = _model(K=3, p=40, seed=5, family=family)
    betas *= 0.5
    model = artifact_lib.ServableModel(betas=betas, intercepts=b0,
                                       family=family)
    ours = ScoringEngine(model, device="cpu")
    theirs = JEngine(model, backend="ref")
    assert ours.n_active == theirs.n_active
    reqs = _sparse_requests(rng, 13, 40, nnz_max=9)
    np.testing.assert_allclose(ours.score_sparse(reqs, kind=kind),
                               theirs.score_sparse(reqs, kind=kind),
                               rtol=1e-5, atol=1e-5)
    X = (rng.normal(size=(21, 40)) * (rng.random((21, 40)) < 0.2)) \
        .astype(np.float32)
    coo = SparseCOO(*np.nonzero(X), X[np.nonzero(X)], X.shape)
    off = (0.1 * rng.normal(size=21)).astype(np.float32)
    np.testing.assert_allclose(
        ours.score_coo(coo, kind=kind, offset=off),
        theirs.score_coo(coo, kind=kind, offset=off), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.score_dense(X, kind=kind),
                               theirs.score_dense(X, kind=kind),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kind", ("link", "response"))
def test_predict_tile_plain_matches_jax_oracle(family, kind):
    rng = np.random.default_rng(5)
    A, L, B, J = 19, 3, 11, 7          # deliberately unaligned shapes
    table = np.zeros((A + 1, L), np.float32)
    table[:-1] = rng.normal(size=(A, L))
    slots = rng.integers(0, A + 1, size=(B, J)).astype(np.int32)
    vals = rng.normal(size=(B, J)).astype(np.float32)
    b0 = rng.normal(size=L).astype(np.float32)
    want = jref.predict_tile(jnp.asarray(slots), jnp.asarray(vals),
                             jnp.asarray(table), jnp.asarray(b0)[None, :],
                             family, kind=kind)
    got = ops.predict_tile(torch.from_numpy(slots), torch.from_numpy(vals),
                           torch.from_numpy(table), torch.from_numpy(b0),
                           family, kind=kind)
    assert got.shape == (B, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, ref.predict_tile(
        torch.from_numpy(slots), torch.from_numpy(vals),
        torch.from_numpy(table), torch.from_numpy(b0), family, kind=kind))


def test_predict_tile_unknown_family_raises(monkeypatch):
    """The reference's contract (tests/test_serve.py
    ``test_predict_tile_unknown_family_falls_back_to_oracle``): a family
    with no link body in the kernel takes the plain version, and its
    result is JAX's oracle's; an unregistered name raises.  The
    multinomial engine scores as JAX's does (a softmax over the
    outputs)."""
    slots = torch.tensor([[0, 1, 1]], dtype=torch.int32)
    vals = torch.ones((1, 3))
    table = torch.tensor([[2.0], [0.0]])
    link = lambda m: 2.0 * m + 1.0
    custom = tglm.GLMFamily("custom_serve", tglm.SQUARED.raw_stats, link,
                            1.0)
    monkeypatch.setitem(tglm.FAMILIES, custom.name, custom)   # undone after
    assert tglm.register_family(custom) is custom
    monkeypatch.setitem(jglm.FAMILIES, custom.name, jglm.GLMFamily(
        custom.name, jglm.SQUARED.raw_stats, link, 1.0))
    for kind in ("link", "response"):
        want = jref.predict_tile(jnp.asarray(slots.numpy()),
                                 jnp.asarray(vals.numpy()),
                                 jnp.asarray(table.numpy()),
                                 jnp.zeros((1, 1)), custom.name, kind=kind)
        for fam in (custom, custom.name):
            got = ops.predict_tile(slots, vals, table, torch.zeros(1), fam,
                                   kind=kind)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        with pytest.raises(ValueError, match="unknown GLM family"):
            ops.predict_tile(slots, vals, table, torch.zeros(1),
                             "no-such-family", kind=kind)
    betas, b0, rng = _model(K=3, p=20, seed=7)
    model = artifact_lib.ServableModel(betas=betas, intercepts=b0,
                                       family="multinomial")
    reqs = [(rng.choice(20, 5, replace=False),
             rng.normal(size=5).astype(np.float32)) for _ in range(6)]
    X = rng.normal(size=(4, 20)).astype(np.float32)
    eng, jeng = ScoringEngine(model, device="cpu"), JEngine(model)
    for kind in ("link", "response"):
        np.testing.assert_allclose(eng.score_sparse(reqs, kind=kind),
                                   jeng.score_sparse(reqs, kind=kind),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(eng.score_dense(X, kind=kind),
                                   jeng.score_dense(X, kind=kind),
                                   rtol=1e-5, atol=1e-6)
    probs = eng.score_sparse(reqs, kind="response")
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-6)


def test_active_set_compaction_equals_full_beta():
    betas, b0, rng = _model(K=3, p=60, seed=4, density=0.2)
    eng = _engine(betas, b0, "logistic")
    assert eng.n_active == int((betas != 0).any(axis=0).sum()) < 60
    X = rng.normal(size=(11, 60)).astype(np.float32)
    np.testing.assert_allclose(eng.score_dense(X, kind="link"),
                               X @ betas.T + b0, atol=1e-5)
    mask = rng.random((11, 60)) < 0.25
    Xs = (X * mask).astype(np.float32)
    coo = SparseCOO(*np.nonzero(Xs), Xs[np.nonzero(Xs)], Xs.shape)
    np.testing.assert_allclose(eng.score_coo(coo, kind="link"),
                               Xs @ betas.T + b0, atol=1e-5)
    eng1 = ScoringEngine(artifact_lib.ServableModel(
        betas=betas, intercepts=b0, family="logistic"), outputs=[2],
        device="cpu")
    np.testing.assert_allclose(eng1.score_dense(X, kind="link")[:, 0],
                               X @ betas[2] + b0[2], atol=1e-5)


def test_engine_out_of_range_features_score_zero():
    eng = _engine(np.ones((1, 4), np.float32), np.zeros(1, np.float32),
                  "squared")
    out = eng.score_sparse([(np.array([0, 9999, -3]),
                             np.array([1.0, 5.0, 5.0], np.float32))],
                           kind="link")
    assert out[0, 0] == pytest.approx(1.0)


def test_score_coo_chunked_parity():
    """Chunked COO scoring (small chunk_rows, ragged tail, one skewed wide
    row, a tiny launch budget) matches the dense product."""
    rng = np.random.default_rng(7)
    p = 40
    betas = (rng.normal(size=(2, p)) *
             (rng.random((2, p)) < 0.4)).astype(np.float32)
    eng = _engine(betas, np.zeros(2, np.float32), "squared")
    X = (rng.normal(size=(23, p)) *
         (rng.random((23, p)) < 0.1)).astype(np.float32)
    X[5] = rng.normal(size=p)          # one near-dense row
    coo = SparseCOO(*np.nonzero(X), X[np.nonzero(X)], X.shape)
    off = rng.normal(size=23).astype(np.float32)
    for kw in (dict(chunk_rows=4), dict(chunk_rows=7), dict(chunk_rows=64),
               dict(launch_budget=64)):
        out = eng.score_coo(coo, kind="link", offset=off, **kw)
        np.testing.assert_allclose(out, X @ betas.T + off[:, None],
                                   atol=1e-5)


def test_coo_to_requests_handles_empty_rows():
    coo = SparseCOO(np.array([0, 2, 2]), np.array([1, 0, 3]),
                    np.array([1.0, 2.0, 3.0], np.float32), (4, 5))
    reqs = coo_to_requests(coo)
    assert len(reqs) == 4
    assert len(reqs[1][0]) == 0 and len(reqs[3][0]) == 0
    assert list(reqs[2][1]) == [2.0, 3.0]


# -------------------------------------------------------------- batcher


def _toy_engine(p=30, K=2, seed=6):
    rng = np.random.default_rng(seed)
    betas = (rng.normal(size=(K, p)) *
             (rng.random((K, p)) < 0.5)).astype(np.float32)
    return _engine(betas, np.zeros(K, np.float32), "squared"), betas, rng


def test_bucket_up():
    assert _bucket_up(1, (1, 4, 16)) == 1
    assert _bucket_up(5, (1, 4, 16)) == 16
    assert _bucket_up(99, (1, 4, 16)) == 99      # outsized: its own shape


def test_batcher_results_and_bounded_shapes():
    eng, betas, rng = _toy_engine()
    reqs = _sparse_requests(rng, 50, 30, nnz_max=12)
    with MicroBatcher(eng, max_delay_ms=5.0, batch_buckets=(1, 4, 16),
                      nnz_buckets=(4, 16), kind="link") as b:
        b.warmup()
        n_shapes = eng.compile_count
        assert n_shapes <= 3 * 2
        outs = np.stack([h.get(timeout=30.0) for h in
                         [b.submit(i, v) for i, v in reqs]])
        st = b.stats()
    assert eng.compile_count == n_shapes      # no shape outside the buckets
    exact = np.stack([betas[:, i] @ v for i, v in reqs])
    np.testing.assert_allclose(outs, exact, atol=1e-5)
    assert st["n_requests"] == 50
    assert st["p50_ms"] is not None and st["p99_ms"] >= st["p50_ms"]
    assert st["rows_per_s"] > 0 and st["mean_batch"] >= 1.0


def test_batcher_deadline_flush_underfull():
    """A lone request is served within about max_delay even though the
    batch bucket never fills."""
    eng, betas, _ = _toy_engine()
    with MicroBatcher(eng, max_delay_ms=10.0, kind="link") as b:
        out = b.submit(np.array([2]), np.array([1.0], np.float32)) \
            .get(timeout=5.0)
    np.testing.assert_allclose(out, betas[:, 2], atol=1e-6)


def test_batcher_offset_and_response():
    eng, betas, _ = _toy_engine()
    with MicroBatcher(eng, max_delay_ms=5.0, kind="link") as b:
        out = b.submit(np.array([0]), np.array([2.0], np.float32),
                       offset=1.5).get(timeout=5.0)
    np.testing.assert_allclose(out, 2.0 * betas[:, 0] + 1.5, atol=1e-6)
    model = artifact_lib.ServableModel(betas=betas,
                                       intercepts=np.zeros(2, np.float32),
                                       family="logistic")
    eng = ScoringEngine(model, device="cpu")
    with MicroBatcher(eng, max_delay_ms=5.0) as b:
        out = b.submit(np.array([0]), np.array([2.0], np.float32),
                       offset=1.5).get(timeout=5.0)
    np.testing.assert_allclose(out, 1 / (1 + np.exp(-(2.0 * betas[:, 0]
                                                      + 1.5))), atol=1e-6)


def test_batcher_survives_engine_failure():
    """A failing flush errors its own handles and leaves the flusher alive
    for the traffic after it."""
    eng, betas, _ = _toy_engine()
    b = MicroBatcher(eng, max_delay_ms=2.0, kind="link")
    orig = eng.score_sparse
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient engine failure")
        return orig(*a, **k)

    eng.score_sparse = flaky
    try:
        h1 = b.submit(np.array([1]), np.array([1.0], np.float32))
        with pytest.raises(RuntimeError, match="transient"):
            h1.get(timeout=10.0)
        h2 = b.submit(np.array([1]), np.array([1.0], np.float32))
        np.testing.assert_allclose(h2.get(timeout=10.0), betas[:, 1],
                                   atol=1e-6)
        assert b.stats()["n_failed"] == 1
    finally:
        eng.score_sparse = orig
        b.close()


def test_request_length_mismatch_rejected():
    eng, _, _ = _toy_engine()
    with pytest.raises(ValueError, match="disagree"):
        eng.score_sparse([(np.array([0, 1]), np.array([1.0], np.float32))])
    with MicroBatcher(eng, kind="link") as b:
        with pytest.raises(ValueError, match="disagree"):
            b.submit(np.array([0, 1]), np.array([1.0], np.float32))


def test_warmup_covers_offset_link_path():
    eng, _, _ = _toy_engine()
    with MicroBatcher(eng, max_delay_ms=5.0, batch_buckets=(1, 4),
                      nnz_buckets=(4,), kind="response") as b:
        b.warmup()
        n0 = eng.compile_count
        assert n0 == 2 * 2 * 1              # (link + response) per bucket
        b.submit(np.array([0]), np.array([1.0], np.float32),
                 offset=0.5).get(timeout=10.0)
        assert eng.compile_count == n0


def test_submit_after_close_raises():
    eng, _, _ = _toy_engine()
    b = MicroBatcher(eng, kind="link")
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.array([0]), np.array([1.0], np.float32))


def test_batch1_baseline_matches_coalesced_results():
    eng, _, rng = _toy_engine()
    reqs = _sparse_requests(rng, 8, 30, nnz_max=6)
    b = MicroBatcher(eng, batch_buckets=(1,), kind="link")
    singles = np.stack([b.score_one(i, v) for i, v in reqs])
    b.close()
    with MicroBatcher(eng, max_delay_ms=5.0, kind="link") as b2:
        coalesced = np.stack([h.get(timeout=30.0) for h in
                              [b2.submit(i, v) for i, v in reqs]])
    np.testing.assert_allclose(singles, coalesced, atol=1e-5)


# ----------------------------------------------------------------- solver


def test_solver_sparse_coo_predict_routes_through_engine():
    X, y, rng = _problem("logistic", n=100, p=16)
    solver = _fit("logistic", X, y, fit_intercept=True)
    mask = rng.random((30, 16)) < 0.3
    Xs = (rng.normal(size=(30, 16)) * mask).astype(np.float32)
    coo = SparseCOO(*np.nonzero(Xs), Xs[np.nonzero(Xs)], Xs.shape)
    off = (0.1 * rng.normal(size=30)).astype(np.float32)
    for kind in ("link", "response"):
        np.testing.assert_allclose(solver.predict(coo, kind=kind, offset=off),
                                   solver.predict(Xs, kind=kind, offset=off),
                                   atol=1e-5)
    assert solver._serve_cache is not None          # the engine was taken
    assert solver._serve_cache[1].device.type == "cpu"
