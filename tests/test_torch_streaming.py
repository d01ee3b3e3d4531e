"""repro_torch's out-of-core mode on the CPU, against the JAX package's.

``StreamingDesign`` (rows on the host, one chunk at a time on the device)
is held against the dense design and against JAX's ``StreamingDesign`` on
the same numpy inputs: its operators, ``scale_columns`` composition (the
chunks bit for bit), ``with_ones_column``, a callable source, the stale
``design_info`` rule, and serial against double-buffered chunks.

Streaming fits (two passes over the chunks a superstep, the Gram-mode
sweep between them) are held against JAX's streaming fits per family
(weights, offsets, an intercept, standardization) and per coupling at a
fixed superstep count below the first superstep where f repeats (``tol=0``
and ``max_outer`` under the float32 plateau, where stopping noise would
part the runs): beta within 1e-5, the same alpha at every superstep and
the same n_iter.  Then ``fit_path`` and ``fit_cv``, and the chunk-cursor
checkpoints: resumed mid-pass and at a superstep boundary, bit for bit
within the port and within 1e-5 across the packages, both ways.
"""
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.core.dglmnet import DGLMNETConfig as JConfig
from repro.core.solver import GLMSolver as JSolver
from repro.data import synthetic
from repro.data.design import streaming_design as jstreaming_design
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.dglmnet import DGLMNETConfig as TConfig
from repro_torch.core.solver import GLMSolver as TSolver
from repro_torch.data.design import (StreamingDesign, dense_design,
                                     streaming_design)

TILE = 16
CPU = "cpu"
# supersteps of each family's parity fit: below the first superstep where
# f repeats (JAX's squared fit repeats at 16, its poisson fit at 27)
BUDGET = {"logistic": 15, "squared": 8, "probit": 15, "poisson": 10}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small problems: torch's intra-op threads buy nothing here and,
    beside the other test workers, spin on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(family="logistic", n=300, p=40, seed=3):
    ds = synthetic.make_dense(n=n, p=p, k_true=6, seed=seed, family=family)
    return ds.train.X, ds.train.y


def _obs_model(n, seed=1):
    rng = np.random.default_rng(seed)
    return dict(sample_weight=rng.uniform(0.5, 2.0, n).astype(np.float32),
                offset=(0.1 * rng.normal(size=n)).astype(np.float32),
                fit_intercept=True, standardize=True)


def _tsd(X, chunk_rows, **kw):
    return streaming_design(X, TILE, chunk_rows=chunk_rows, device=CPU,
                            **kw)[0]


def _jsd(X, chunk_rows):
    return jstreaming_design(X, TILE, chunk_rows=chunk_rows)[0]


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _same_run(r_t, r_j, beta_tol=1e-5):
    """The reference's bar: beta within ``beta_tol``, the same alpha at
    every superstep and the same n_iter."""
    assert r_t.n_iter == r_j.n_iter
    np.testing.assert_allclose(r_t.beta, r_j.beta, atol=beta_tol)
    np.testing.assert_array_equal(np.asarray(r_t.history["alpha"]),
                                  np.asarray(r_j.history["alpha"]))


# ---------------------------------------------------------------------------
# the design
# ---------------------------------------------------------------------------


def test_operators_against_dense_and_jax():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(130, 35)).astype(np.float32)
    dd, _ = dense_design(X, TILE, device=CPU)
    sd = _tsd(X, 48)
    jsd = _jsd(X, 48)
    assert sd.shape == jsd.shape and sd.shape[1] == dd.shape[1]
    assert sd.n_chunks == 3 and sd.n_tiles == dd.n_tiles
    n_tot = sd.shape[0]
    w = np.zeros(n_tot, np.float32)
    r = np.zeros(n_tot, np.float32)
    w[:130] = rng.uniform(0.1, 2.0, 130)
    r[:130] = rng.normal(size=130)
    wd, rd = torch.from_numpy(w[:130]), torch.from_numpy(r[:130])
    wt, rt = torch.from_numpy(w), torch.from_numpy(r)
    for tid in (0, sd.n_tiles - 1):
        G1, g1 = dd.tile_gram(tid, wd, rd)
        G2, g2 = sd.tile_gram(tid, wt, rt)
        G3, g3 = jsd.tile_gram(tid, w, r)
        for got, want in ((G2, G1), (g2, g1), (G2, G3), (g2, g3)):
            np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)
    live = np.ones(sd.n_tiles, bool)
    live[1] = False
    Ga1, ga1 = dd.all_tile_grams(wd, rd, live)
    Ga2, ga2 = sd.all_tile_grams(wt, rt, live)
    np.testing.assert_allclose(Ga2.numpy(), Ga1.numpy(), atol=1e-4)
    np.testing.assert_allclose(ga2.numpy(), ga1.numpy(), atol=1e-4)
    assert not Ga2[1].any() and not ga2[1].any()
    Gf, gf = sd.full_gram(wt, rt)
    Xp = dd.data.numpy().astype(np.float64)
    np.testing.assert_allclose(Gf.numpy(), (Xp.T * w[:130]) @ Xp,
                               atol=1e-4)
    np.testing.assert_allclose(gf.numpy(), Xp.T @ r[:130], atol=1e-4)
    v = torch.from_numpy(rng.normal(size=sd.shape[1]).astype(np.float32))
    np.testing.assert_allclose(sd.matvec(v).numpy()[:130],
                               dd.matvec(v).numpy(), atol=1e-4)
    np.testing.assert_allclose(sd.matvec(v).numpy(),
                               np.asarray(jsd.matvec(v.numpy())), atol=1e-4)
    np.testing.assert_allclose(sd.tile_matvec(1, v[TILE:2 * TILE])
                               .numpy()[:130],
                               dd.tile_matvec(1, v[TILE:2 * TILE]).numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(sd.rmatvec(rt).numpy(),
                               dd.rmatvec(rd).numpy(), atol=1e-4)
    s1d, s2d = dd.col_moments(wd)
    s1s, s2s = sd.col_moments(wt)
    s1j, s2j = jsd.col_moments(w)
    np.testing.assert_allclose(s1s.numpy(), s1d.numpy(), atol=1e-4)
    np.testing.assert_allclose(s2s.numpy(), s2d.numpy(), atol=1e-4)
    np.testing.assert_allclose(s1s.numpy(), np.asarray(s1j), atol=1e-4)
    np.testing.assert_allclose(s2s.numpy(), np.asarray(s2j), atol=1e-4)
    np.testing.assert_array_equal(sd.to_dense().numpy(),
                                  np.asarray(jsd.to_dense()))
    np.testing.assert_array_equal(sd.to_dense().numpy()[:130],
                                  dd.to_dense().numpy())


def test_row_chunks_pads_vectors():
    """An unpadded (n,) vector is zero-extended (padded rows weigh 0); a
    vector of another length raises."""
    X = np.arange(5 * 2, dtype=np.float32).reshape(5, 2)
    sd = streaming_design(lambda i: X[i * 2:(i + 1) * 2], TILE, n_rows=5,
                          n_cols=2, chunk_rows=2, device=CPU)[0]
    seen = [wc.numpy() for _, (wc,) in sd._row_chunks(np.ones(5))]
    assert all(len(s) == 2 for s in seen)
    np.testing.assert_array_equal(np.concatenate(seen), [1, 1, 1, 1, 1, 0])
    with pytest.raises(ValueError):
        list(sd._row_chunks(np.ones(4, np.float32)))


def test_scale_columns_compose_bit_for_bit():
    """Two scalings compose as the reference composes them, and the
    chunks, centered and scaled on the device after the copy, equal JAX's
    host-made chunks bit for bit."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(50, 20)).astype(np.float32)
    sd, jsd = _tsd(X, 32), _jsd(X, 32)
    p = sd.p_pad
    s1, s2 = (rng.uniform(0.5, 2.0, p).astype(np.float32) for _ in "ab")
    c1, c2 = (rng.normal(size=p).astype(np.float32) for _ in "ab")
    got = sd.scale_columns(torch.from_numpy(s1), torch.from_numpy(c1)) \
        .scale_columns(s2, c2).to_dense().numpy()
    want = np.asarray(jsd.scale_columns(s1, c1).scale_columns(s2, c2)
                      .to_dense())
    np.testing.assert_array_equal(got, want)
    ref = ((X - c1[:20]) * s1[:20] - c2[:20]) * s2[:20]
    np.testing.assert_allclose(got[:50, :20], ref, atol=1e-5)
    # scale only: centers stay zero, padded columns stay zero
    only = sd.scale_columns(s1).to_dense().numpy()
    np.testing.assert_array_equal(
        only, np.asarray(jsd.scale_columns(s1).to_dense()))
    assert not only[:, 20:].any()


def test_with_ones_column_rules():
    X, _ = _data()
    sd = _tsd(X, 64)
    sd2 = sd.with_ones_column()
    assert sd2.p_user == sd.p_user + 1
    dense = sd2.to_dense().numpy()
    np.testing.assert_array_equal(dense[:sd.n_rows_data, sd.p_user], 1.0)
    assert not dense[sd.n_rows_data:].any()      # padded rows carry no 1
    with pytest.raises(ValueError, match="intercept"):
        sd2.with_ones_column()
    with pytest.raises(ValueError, match="before scaling"):
        sd.scale_columns(np.ones(sd.p_pad)).with_ones_column()


def test_callable_needs_dims_and_validates_shape():
    with pytest.raises(ValueError, match="n_rows/n_cols"):
        streaming_design(lambda i: np.zeros((4, 4)), TILE, chunk_rows=4,
                         device=CPU)
    sd = streaming_design(lambda i: np.zeros((3, 4), np.float32), TILE,
                          chunk_rows=4, n_rows=8, n_cols=4, device=CPU)[0]
    with pytest.raises(ValueError, match="chunk_fn"):
        sd._host_chunk(0)          # 3 rows, chunk 0 expects 4
    with pytest.raises(ValueError, match="chunk_fn"):
        next(sd.iter_chunks())
    with pytest.raises(ValueError, match="dense device buffers"):
        from repro_torch.data.sparse import SparseCOO
        streaming_design(SparseCOO(np.zeros(1, np.int64),
                                   np.zeros(1, np.int64),
                                   np.ones(1, np.float32), (2, 2)),
                         TILE, chunk_rows=2, device=CPU)


def test_callable_source_equals_array():
    """A pure chunk callable trains bit for bit as the array slicer."""
    X, y = _data()
    cr = 96
    sd_fn, info = streaming_design(
        lambda i: X[i * cr:(i + 1) * cr], TILE, chunk_rows=cr,
        n_rows=X.shape[0], n_cols=X.shape[1], device=CPU)
    assert info.shape == X.shape
    cfg = TConfig(tile_size=TILE, max_outer=10, tol=0.0)
    r1 = TSolver(_tsd(X, cr), y, config=cfg, device=CPU).fit(lam1=0.05)
    r2 = TSolver(sd_fn, y, config=cfg, device=CPU).fit(lam1=0.05)
    np.testing.assert_array_equal(r1.beta, r2.beta)


def test_double_buffer_matches_serial():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(100, 20)).astype(np.float32)
    sd = _tsd(X, 33)
    pre = [c.numpy() for _, c in sd.iter_chunks()]
    ser = [c.numpy() for _, c in sd.iter_chunks(prefetch=False)]
    assert len(pre) == sd.n_chunks == 4
    for a, b in zip(pre, ser):
        np.testing.assert_array_equal(a, b)
    assert [i for i, _ in sd.iter_chunks(start=2)] == [2, 3]


def test_design_rules_in_the_session():
    X, y = _data()
    sd = streaming_design(X, 8, chunk_rows=64, device=CPU)[0]
    with pytest.raises(ValueError, match="tile_size"):
        TSolver(sd, y, config=TConfig(tile_size=TILE), device=CPU)
    # a mesh is ported, and a StreamingDesign on a real one raises
    # ValueError (tests/test_torch_sharded.py); here: not a DeviceMesh
    with pytest.raises(TypeError, match="mesh"):
        TSolver(_tsd(X, 64), y, mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="y=None"):
        TSolver(_tsd(X, 64), None, device=CPU)


def test_stale_design_info_is_ignored():
    """The builder's info predates the intercept column: the session
    rebuilds it from the design, as JAX's does."""
    X, y = _data()
    sd, stale = streaming_design(X, TILE, chunk_rows=64, device=CPU)
    cfg = TConfig(tile_size=TILE, max_outer=10, tol=0.0)
    sol = TSolver(sd, y, config=cfg, design_info=stale, fit_intercept=True,
                  device=CPU)
    assert sol._p_user == X.shape[1]
    r_t = sol.fit(lam1=0.05)
    jsd, jstale = jstreaming_design(X, TILE, chunk_rows=64)
    jsol = JSolver(jsd, y, config=JConfig(tile_size=TILE, max_outer=10,
                                          tol=0.0),
                   design_info=jstale, fit_intercept=True)
    r_j = jsol.fit(lam1=0.05)
    _same_run(r_t, r_j)
    assert abs(sol.intercept_ - jsol.intercept_) <= 1e-5


# ---------------------------------------------------------------------------
# fits against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["logistic", "squared", "probit",
                                    "poisson"])
def test_fit_parity_per_family(family):
    """Weights, offsets, an intercept and standardization, a ragged last
    chunk: the port's streaming fit against JAX's."""
    X, y = _data(family)
    kw = _obs_model(y.shape[0])
    budget = BUDGET[family]
    t = TSolver(_tsd(X, 77), y, device=CPU, config=TConfig(
        family=family, tile_size=TILE, max_outer=budget, tol=0.0), **kw)
    r_t = t.fit(lam1=0.05, lam2=0.01)
    j = JSolver(_jsd(X, 77), y, config=JConfig(
        family=family, tile_size=TILE, max_outer=budget, tol=0.0), **kw)
    r_j = j.fit(lam1=0.05, lam2=0.01)
    assert r_t.n_iter == budget
    _same_run(r_t, r_j)
    assert abs(t.intercept_ - j.intercept_) <= 1e-5
    np.testing.assert_allclose(r_t.history["f"], r_j.history["f"],
                               rtol=1e-6)


@pytest.mark.parametrize("coupling", ["gauss-seidel", "jacobi"])
def test_fit_parity_per_coupling(coupling):
    """Both couplings against JAX's streaming fit and against the port's
    own in-memory fit of the same rows."""
    X, y = _data()
    cfg = dict(tile_size=TILE, coupling=coupling, max_outer=12, tol=0.0)
    r_t = TSolver(_tsd(X, 96), y, config=TConfig(**cfg),
                  device=CPU).fit(lam1=0.05, lam2=0.01)
    r_j = JSolver(_jsd(X, 96), y, config=JConfig(**cfg)).fit(lam1=0.05,
                                                             lam2=0.01)
    _same_run(r_t, r_j)
    r_m = TSolver(X, y, config=TConfig(fuse_superstep=False, **cfg),
                  device=CPU).fit(lam1=0.05, lam2=0.01)
    _same_run(r_t, r_m)


def test_single_chunk_equals_multi_chunk():
    """Chunk geometry does not matter: one chunk against many."""
    X, y = _data()
    cfg = TConfig(tile_size=TILE, max_outer=12, tol=0.0)
    res = [TSolver(_tsd(X, cr), y, config=cfg, device=CPU).fit(lam1=0.05)
           for cr in (X.shape[0], 64, 17)]
    for r in res[1:]:
        np.testing.assert_allclose(r.beta, res[0].beta, atol=1e-6)
        assert r.history["alpha"] == res[0].history["alpha"]


def test_training_margins_and_warm_start():
    X, y = _data()
    cfg = TConfig(tile_size=TILE, max_outer=6, tol=0.0)
    s = TSolver(_tsd(X, 64), y, config=cfg, fit_intercept=True, device=CPU)
    s.fit(lam1=0.05)
    m = s.training_margins()
    np.testing.assert_allclose(m, X @ s.beta_ + s.intercept_, atol=1e-5)
    j = JSolver(_jsd(X, 64), y, config=JConfig(tile_size=TILE, max_outer=6,
                                               tol=0.0), fit_intercept=True)
    j.fit(lam1=0.05)
    np.testing.assert_allclose(m, j.training_margins(), atol=1e-5)
    r_t = s.fit(lam1=0.04, beta0=s.beta_, intercept0=s.intercept_)
    r_j = j.fit(lam1=0.04, beta0=j.beta_, intercept0=j.intercept_)
    _same_run(r_t, r_j)


def test_fit_path_parity():
    """lambda_max (the gradient summed over chunks) and a screened path:
    the port's streaming path against JAX's, per lambda."""
    X, y = _data(n=350, p=48, seed=7)
    cfg = dict(tile_size=TILE, max_outer=30, tol=1e-4)
    t = TSolver(_tsd(X, 96), y, config=TConfig(**cfg), device=CPU)
    j = JSolver(_jsd(X, 96), y, config=JConfig(**cfg))
    np.testing.assert_allclose(t.lambda_max(), j.lambda_max(), rtol=1e-5)
    p_t = t.fit_path(n_lambdas=5, lam_ratio=1e-2)
    p_j = j.fit_path(n_lambdas=5, lam_ratio=1e-2)
    np.testing.assert_array_equal(p_t.n_iters, p_j.n_iters)
    np.testing.assert_allclose(p_t.betas, p_j.betas, atol=1e-5)
    np.testing.assert_allclose(p_t.f, p_j.f, rtol=1e-6)
    assert t.launch_stats["sweep_tiles_skipped"] > 0


def test_fit_cv_parity():
    X, y = _data(n=350, p=48, seed=7)
    cfg = dict(tile_size=TILE, max_outer=30, tol=1e-4)
    cv_t = TSolver(_tsd(X, 96), y, config=TConfig(**cfg),
                   device=CPU).fit_cv(n_folds=3, n_lambdas=4, lam_ratio=1e-2)
    cv_j = JSolver(_jsd(X, 96), y, config=JConfig(**cfg)).fit_cv(
        n_folds=3, n_lambdas=4, lam_ratio=1e-2)
    assert cv_t.best_index == cv_j.best_index
    np.testing.assert_allclose(cv_t.dev_folds, cv_j.dev_folds, rtol=1e-5)
    np.testing.assert_allclose(cv_t.beta, cv_j.beta, atol=1e-5)


# ---------------------------------------------------------------------------
# chunk-cursor checkpoints
# ---------------------------------------------------------------------------


class _Abort(Exception):
    pass


def _cut_after(mgr, at):
    """Make ``mgr`` raise right after the save whose (stream_chunk,
    next_it) metadata is ``at``: a crash at that chunk."""
    orig = mgr.save

    def save(step, tree, **kw):
        orig(step, tree, **kw)
        md = kw.get("metadata") or {}
        if (md.get("stream_chunk"), md.get("next_it")) == at:
            raise _Abort

    mgr.save = save
    return mgr


STREAM = dict(n=400, p=48, seed=5)
CUT = (4, 4)        # chunk 4 of superstep 4 (7 chunks of 64 rows)


def _stream_fit(pkg, X, y, max_outer, mgr=None, **kw):
    if pkg == "torch":
        s = TSolver(_tsd(X, 64), y, device=CPU, config=TConfig(
            tile_size=TILE, max_outer=max_outer, tol=0.0))
    else:
        s = JSolver(_jsd(X, 64), y, config=JConfig(
            tile_size=TILE, max_outer=max_outer, tol=0.0))
    return s.fit(lam1=0.05, ckpt_manager=mgr, **kw)


def test_mid_pass_resume_is_bit_exact(tmp_path):
    """Cut mid-pass, resumed at the saved chunk in a fresh session: the
    partial sums are part of the checkpoint, so the resumed fit is the
    uninterrupted one bit for bit."""
    X, y = _data(**STREAM)
    full = _stream_fit("torch", X, y, 12)
    with pytest.raises(_Abort):
        _stream_fit("torch", X, y, 12, _cut_after(
            CheckpointManager(tmp_path), CUT), ckpt_every=3,
            ckpt_every_chunks=2)
    mgr = CheckpointManager(tmp_path)
    md = mgr.read_metadata()
    assert md["stream_chunk"] == 4 and md["next_it"] == 4
    assert md["design_layout"] == {"kind": "streaming", "tile": TILE,
                                   "chunk_rows": 64}
    res = _stream_fit("torch", X, y, 12, mgr, ckpt_every=3,
                      ckpt_every_chunks=2)
    np.testing.assert_array_equal(res.beta, full.beta)
    assert res.n_iter == 12
    assert res.history["f"] == full.history["f"][3:]
    assert res.history["alpha"] == full.history["alpha"][3:]


def test_boundary_resume_is_bit_exact(tmp_path):
    X, y = _data(**STREAM)
    full = _stream_fit("torch", X, y, 10)
    mgr = CheckpointManager(tmp_path)
    _stream_fit("torch", X, y, 6, mgr, ckpt_every=3)
    assert mgr.latest_step() == 6
    assert "stream_chunk" not in mgr.read_metadata()
    res = _stream_fit("torch", X, y, 10, CheckpointManager(tmp_path),
                      ckpt_every=3)
    np.testing.assert_array_equal(res.beta, full.beta)
    assert res.history["f"] == full.history["f"][6:]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_mid_pass_resume_across_packages(tmp_path, writer):
    """A chunk-cursor checkpoint of one package resumed by the other
    matches JAX's uninterrupted fit (beta within 1e-5, same alpha and
    n_iter)."""
    X, y = _data(**STREAM)
    want = _stream_fit("jax", X, y, 12)
    cut_mgr = JManager(tmp_path) if writer == "jax" \
        else CheckpointManager(tmp_path)
    with pytest.raises(_Abort):
        _stream_fit(writer, X, y, 12, _cut_after(cut_mgr, CUT),
                    ckpt_every=3, ckpt_every_chunks=2)
    reader = "torch" if writer == "jax" else "jax"
    mgr = CheckpointManager(tmp_path) if reader == "torch" \
        else JManager(tmp_path)
    assert mgr.read_metadata()["stream_chunk"] == 4
    got = _stream_fit(reader, X, y, 12, mgr, ckpt_every=3,
                      ckpt_every_chunks=2)
    assert got.n_iter == want.n_iter
    np.testing.assert_allclose(got.beta, want.beta, atol=1e-5)
    assert got.history["alpha"] == want.history["alpha"][3:]


def test_checkpoint_rejects_other_layout(tmp_path):
    X, y = _data()
    mgr = CheckpointManager(tmp_path)
    _stream_fit("torch", X, y, 4, mgr, ckpt_every=2)
    cfg = TConfig(tile_size=TILE, max_outer=4, tol=0.0)
    with pytest.raises(ValueError, match="layout"):
        TSolver(X, y, config=cfg, device=CPU).fit(
            lam1=0.05, ckpt_manager=CheckpointManager(tmp_path))
    with pytest.raises(ValueError, match="layout"):
        TSolver(_tsd(X, 32), y, config=cfg, device=CPU).fit(
            lam1=0.05, ckpt_manager=CheckpointManager(tmp_path))


def test_path_checkpoint_resume(tmp_path):
    """fit_path on a streaming design, cut after 2 of 4 lambdas and
    resumed: the uninterrupted path bit for bit (the margins slot of the
    path checkpoint is the empty placeholder, as in JAX's files)."""
    X, y = _data(n=350, p=48, seed=7)
    cfg = TConfig(tile_size=TILE, max_outer=30, tol=1e-4)
    full = TSolver(_tsd(X, 96), y, config=cfg, device=CPU).fit_path(
        n_lambdas=4, lam_ratio=1e-2)
    mgr = CheckpointManager(tmp_path)
    TSolver(_tsd(X, 96), y, config=cfg, device=CPU).fit_path(
        full.lambdas[:2], ckpt_manager=mgr)
    assert mgr.read_metadata()["path"]["next_k"] == 2
    res = TSolver(_tsd(X, 96), y, config=cfg, device=CPU).fit_path(
        full.lambdas, ckpt_manager=CheckpointManager(tmp_path))
    np.testing.assert_array_equal(res.betas, full.betas)
    np.testing.assert_array_equal(res.n_iters, full.n_iters)


def test_streaming_is_a_design_matrix():
    X, _ = _data()
    sd = _tsd(X, 64)
    assert isinstance(sd, StreamingDesign)
    assert sd.device.type == "cpu"
    assert sd.row_slice(2) == slice(128, 192)
