"""repro_torch.io on the CPU, against the JAX package's ``repro.io``.

The readers are the reference's contracts (``tests/test_io.py``): comments
and ``qid`` annotations, libsvm round trips (plain, gzip, from a
SparseCOO), one-based index detection, random access and purity, the
capped single pass, the parsed-chunk LRU; each reader's chunks equal
JAX's bit for bit, and so do the files the two writers write.  The hasher
gives JAX's columns and signs bit for bit, crosses included.  The
prefetch thread restarts on a jump and carries errors to the consumer;
``validate_chunk_callable`` holds the chunk contract.

File fits run at a fixed superstep count below the first superstep where
f repeats (``tol=0``): the reference's own ``test_parquet_fit_parity``
runs to ``max_outer=15``, where its file fit stops at 10 supersteps and
its in-memory fit at 8 (both on the float32 plateau), so it is not copied.
Each family's file fit is held against JAX's file fit and against the
port's in-memory fit of the same rows: beta within 1e-5, the same alpha
and n_iter.  Then Parquet (under ``HAVE_PYARROW``), a hashed
``open_design``, every estimator's ``fit(path)`` and ``ingest_train``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import io as jio
from repro.core.dglmnet import DGLMNETConfig as JConfig
from repro.core.solver import GLMSolver as JSolver
from repro.data import synthetic
from repro.data.pipeline import validate_chunk_callable as jvalidate
from repro.glm import estimators as jest
from repro_torch import io as tio
from repro_torch.core.dglmnet import DGLMNETConfig as TConfig
from repro_torch.core.solver import GLMSolver as TSolver
from repro_torch.data.design import StreamingDesign
from repro_torch.data.pipeline import validate_chunk_callable
from repro_torch.data.sparse import SparseCOO
from repro_torch.glm import estimators as test_
from repro_torch.io.hashing import (FeatureHasher, expand_interactions,
                                    fnv1a64, splitmix64)
from repro_torch.io.libsvm import LibsvmReader, parse_line, write_libsvm
from repro_torch.io.parquet import HAVE_PYARROW
from repro_torch.io.prefetch import PrefetchingSource
from repro_torch.launch import ingest_train

TILE = 8
CPU = "cpu"
FAMILIES = ["logistic", "squared", "probit", "poisson"]
# supersteps of each family's file fit, below the first superstep where f
# repeats (JAX's squared streaming fit of this data repeats at 16)
BUDGET = {"logistic": 12, "squared": 8, "probit": 12, "poisson": 10}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small problems: torch's intra-op threads buy nothing here and,
    beside the other test workers, spin on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense(n=240, p=12, seed=0, density=0.5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    X[rng.random(size=X.shape) > density] = 0.0
    return X, rng


def _labels(X, rng, family="logistic"):
    p = X.shape[1]
    beta = np.zeros((p,), np.float32)
    beta[: max(p // 3, 2)] = rng.normal(size=max(p // 3, 2))
    m = X @ beta
    if family in ("logistic", "probit"):
        return np.where(rng.random(len(m)) < 1 / (1 + np.exp(-m)),
                        1.0, -1.0).astype(np.float32)
    if family == "poisson":
        return rng.poisson(np.exp(np.clip(0.3 * m, None, 3.0))) \
            .astype(np.float32)
    return (m + 0.1 * rng.normal(size=len(m))).astype(np.float32)


def _all_chunks(reader):
    return np.concatenate([reader.chunk_fn(i)
                           for i in range(reader.n_chunks)])


def _same_run(r_a, r_b, beta_tol=1e-5):
    assert r_a.n_iter == r_b.n_iter
    np.testing.assert_allclose(r_a.beta, r_b.beta, atol=beta_tol)
    np.testing.assert_array_equal(np.asarray(r_a.history["alpha"]),
                                  np.asarray(r_b.history["alpha"]))


# ---------------------------------------------------------------------------
# libsvm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("line", ["1 qid:3 0:1.5 4:-2 # trailing\n",
                                  "-1 2:0.25 7:3e-4\n", "# comment\n",
                                  "   \n"])
def test_parse_line_as_jax(line):
    got, want = parse_line(line), jio.libsvm.parse_line(line)
    if want is None:
        assert got is None
        return
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    if "qid" in line:
        assert got[1].tolist() == [0, 4]
        np.testing.assert_allclose(got[2], [1.5, -2.0])


@pytest.mark.parametrize("suffix", [".libsvm", ".libsvm.gz"])
def test_libsvm_roundtrip_dense(tmp_path, suffix):
    X, rng = _dense()
    y = _labels(X, rng)
    path = write_libsvm(tmp_path / f"d{suffix}", X, y)
    jpath = jio.write_libsvm(tmp_path / f"j{suffix}", X, y)
    if suffix == ".libsvm":
        assert path.read_bytes() == jpath.read_bytes()
    r = LibsvmReader(path, chunk_rows=64)
    assert (r.n_rows, r.n_features) == X.shape
    np.testing.assert_array_equal(r.labels(), y)
    np.testing.assert_array_equal(_all_chunks(r), X)      # %.9g is exact
    jr = jio.LibsvmReader(jpath, chunk_rows=64)
    for i in range(r.n_chunks):
        for a, b in zip(r.chunk(i), jr.chunk(i)):
            np.testing.assert_array_equal(a, b)


def test_libsvm_roundtrip_sparse_coo(tmp_path):
    X, rng = _dense(density=0.2)
    y = _labels(X, rng)
    rr, cc = np.nonzero(X)
    coo = SparseCOO(rr.astype(np.int64), cc.astype(np.int64),
                    X[rr, cc].astype(np.float32), X.shape)
    path = write_libsvm(tmp_path / "s.libsvm", coo, y)
    r = LibsvmReader(path, chunk_rows=50)          # a ragged last chunk
    np.testing.assert_array_equal(_all_chunks(r), X)
    back = r.to_coo()
    np.testing.assert_array_equal(back.to_dense(), X)


def test_libsvm_one_based_autodetect(tmp_path):
    X, rng = _dense(n=30, p=5)
    y = _labels(X, rng)
    path = write_libsvm(tmp_path / "ob.libsvm", X, y, zero_based=False)
    r = LibsvmReader(path, chunk_rows=16)
    assert r.n_features == 5
    np.testing.assert_array_equal(_all_chunks(r), X)


@pytest.mark.parametrize("name", ["plain.libsvm", "z.libsvm.gz"])
def test_libsvm_random_access_and_purity(tmp_path, name):
    X, rng = _dense(n=100, p=6)
    y = _labels(X, rng)
    r = LibsvmReader(write_libsvm(tmp_path / name, X, y), chunk_rows=32)
    # out of order and repeated reads give the same bits (gzip reopens
    # and skips forward on a jump back)
    c2 = r.chunk_fn(2)
    c0 = r.chunk_fn(0)
    np.testing.assert_array_equal(r.chunk_fn(2), c2)
    np.testing.assert_array_equal(r.chunk_fn(0), c0)
    np.testing.assert_array_equal(c2, X[64:96])
    out = validate_chunk_callable(r.chunk_fn, n_rows=100, n_cols=6,
                                  chunk_rows=32)
    assert out["last_rows"] == 4


def test_libsvm_capped_single_pass(tmp_path):
    X, rng = _dense(n=50, p=8)
    y = _labels(X, rng)
    path = write_libsvm(tmp_path / "cap.libsvm", X, y)
    r = LibsvmReader(path, chunk_rows=20, n_rows=50, n_features=8,
                     zero_based=True)
    assert r._labels is None                    # no scan yet
    np.testing.assert_array_equal(_all_chunks(r), X)
    np.testing.assert_array_equal(r.labels(), y)
    # an index past the cap raises, it is not dropped
    r2 = LibsvmReader(path, chunk_rows=20, n_rows=50, n_features=4,
                      zero_based=True)
    with pytest.raises(ValueError, match="hash"):
        r2.chunk_fn(0)


def test_reader_chunk_cache(tmp_path):
    """``cache_chunks`` serves later passes from a bounded LRU with the
    same values."""
    X, rng = _dense(n=100, p=8)
    y = _labels(X, rng)
    path = write_libsvm(tmp_path / "c.libsvm.gz", X, y)
    cold = LibsvmReader(path, chunk_rows=16)
    cached = LibsvmReader(path, chunk_rows=16, cache_chunks=3)
    for _ in range(3):
        for i in range(cold.n_chunks):
            np.testing.assert_array_equal(cached.chunk_fn(i),
                                          cold.chunk_fn(i))
        assert len(cached._cache) <= 3
    assert set(cached._cache) == {cold.n_chunks - 3, cold.n_chunks - 2,
                                  cold.n_chunks - 1}


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------


def test_hash_primitives_as_jax():
    keys = np.arange(0, 5000, 7, dtype=np.uint64) * np.uint64(2654435761)
    np.testing.assert_array_equal(splitmix64(keys),
                                  jio.hashing.splitmix64(keys))
    for s in (b"", b"a", b"token", "café".encode("utf-8")):
        assert fnv1a64(s) == jio.hashing.fnv1a64(s)


@pytest.mark.parametrize("seed,field", [(0, 0), (3, 0), (7, 1), (11, 5)])
def test_hasher_as_jax_bit_for_bit(seed, field):
    h = FeatureHasher(1000, tile_size=64, n_shards=2, seed=seed)
    jh = jio.FeatureHasher(1000, tile_size=64, n_shards=2, seed=seed)
    assert h.n_features == jh.n_features == 1024
    keys = np.random.default_rng(seed).integers(0, 2**40, 3000) \
        .astype(np.uint64)
    c, s = h.hash_indices(keys, field)
    jc, js = jh.hash_indices(keys, field)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(s, js)
    toks = [f"tok{i}" for i in range(300)]
    for a, b in zip(h.hash_tokens(toks, field), jh.hash_tokens(toks, field)):
        np.testing.assert_array_equal(a, b)
    X, _ = _dense(n=40, p=30, seed=seed)
    cols = np.where(X != 0, np.arange(30)[None, :], -1).astype(np.int64)
    for k in (0, 4):
        np.testing.assert_array_equal(
            h.transform_chunk(cols, X, field=field, interactions=k),
            jh.transform_chunk(cols, X, field=field, interactions=k))


def test_hashing_deterministic_across_processes():
    h = FeatureHasher(64, seed=3)
    cols, signs = h.hash_indices(np.arange(1000, dtype=np.uint64))
    prog = ("import numpy as np\n"
            "from repro_torch.io.hashing import FeatureHasher\n"
            "h = FeatureHasher(64, seed=3)\n"
            "c, s = h.hash_indices(np.arange(1000, dtype=np.uint64))\n"
            "print(int(c.sum()), int(s.sum()))\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    out = subprocess.run(
        [sys.executable, "-c", prog], capture_output=True, text=True,
        check=True, env={**os.environ, "PYTHONHASHSEED": "99",
                         "PYTHONPATH": src})
    assert tuple(int(v) for v in out.stdout.split()) == \
        (int(cols.sum()), int(signs.sum()))


def test_hashing_collision_is_signed_sum():
    h = FeatureHasher(8, seed=1)
    cols = np.asarray([[0, 1, 2, -1]], np.int64)   # -1 = padding
    vals = np.asarray([[1.0, 2.0, 3.0, 99.0]], np.float32)
    dense = h.transform_chunk(cols, vals)
    bc, sg = h.hash_indices(np.asarray([0, 1, 2], np.uint64))
    want = np.zeros(8, np.float32)
    np.add.at(want, bc, sg * np.asarray([1, 2, 3], np.float32))
    np.testing.assert_allclose(dense[0], want)


def test_interactions_order_invariant_and_as_jax():
    h = FeatureHasher(32, seed=2)
    cols = np.asarray([[3, 7, 11, -1]], np.int64)
    vals = np.asarray([[1.0, 2.0, 0.5, 0.0]], np.float32)
    ic, iv = expand_interactions(cols, vals, h)
    perm = np.asarray([[11, 3, 7, -1]], np.int64)
    pv = np.asarray([[0.5, 1.0, 2.0, 0.0]], np.float32)
    ic2, iv2 = expand_interactions(perm, pv, h)
    np.testing.assert_allclose(h.transform_chunk(ic, iv, field=1),
                               h.transform_chunk(ic2, iv2, field=1))
    jic, jiv = jio.expand_interactions(cols, vals,
                                       jio.FeatureHasher(32, seed=2))
    np.testing.assert_array_equal(ic, jic)
    np.testing.assert_array_equal(iv, jiv)


# ---------------------------------------------------------------------------
# prefetch and the chunk contract
# ---------------------------------------------------------------------------


def test_prefetch_matches_and_restarts():
    def fn(i):
        return np.full((4, 3), i, np.float32)

    with PrefetchingSource(fn, 6, depth=2) as src:
        for i in range(6):
            np.testing.assert_array_equal(src(i), fn(i))
        np.testing.assert_array_equal(src(2), fn(2))     # a jump back
        np.testing.assert_array_equal(src(3), fn(3))
        np.testing.assert_array_equal(src(0), fn(0))
    with pytest.raises(IndexError):
        PrefetchingSource(fn, 6)(6)


def test_prefetch_propagates_errors():
    def fn(i):
        if i == 2:
            raise RuntimeError("boom at 2")
        return np.zeros((2, 2), np.float32)

    src = PrefetchingSource(fn, 4, depth=2)
    src(0), src(1)
    with pytest.raises(RuntimeError, match="boom at 2"):
        src(2)
    src.close()


def test_validate_chunk_callable_as_jax():
    X = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)

    def ragged(i):
        return X[i * 3:(i + 1) * 3]

    def padded(i):
        return np.zeros((3, 2), np.float32)

    state = [0]

    def impure(i):
        state[0] += 1
        return np.full((2, 2), state[0], np.float32)

    out = validate_chunk_callable(ragged, n_rows=7, n_cols=3, chunk_rows=3)
    assert out == jvalidate(ragged, n_rows=7, n_cols=3, chunk_rows=3)
    assert out["n_chunks"] == 3 and out["last_rows"] == 1
    with pytest.raises(ValueError, match="RAGGED"):
        validate_chunk_callable(padded, n_rows=7, n_cols=2, chunk_rows=3)
    with pytest.raises(ValueError, match="pure"):
        validate_chunk_callable(impure, n_rows=4, n_cols=2, chunk_rows=2)
    with pytest.raises(ValueError, match="positive"):
        validate_chunk_callable(ragged, n_rows=0, n_cols=3, chunk_rows=3)


# ---------------------------------------------------------------------------
# fits from files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_file_fit_parity(tmp_path, family):
    """The full observation model: the port's file fit against JAX's file
    fit and against the port's in-memory fit of the same rows."""
    budget = BUDGET[family]
    ds = synthetic.make_dense(n=300, p=40, k_true=6, seed=3, family=family)
    X, y = ds.train.X, ds.train.y
    rng = np.random.default_rng(4)
    sw = rng.uniform(0.5, 2.0, y.shape[0]).astype(np.float32)
    off = (0.1 * rng.normal(size=y.shape[0])).astype(np.float32)
    path = write_libsvm(tmp_path / "p.libsvm.gz", X, y)
    kw = dict(family=family, sample_weight=sw, offset=off,
              fit_intercept=True, standardize=True)
    cfg = dict(tile_size=TILE, max_outer=budget, tol=0.0, family=family)
    s_file = TSolver(str(path), y, config=TConfig(**cfg), device=CPU, **kw)
    r_file = s_file.fit(lam1=0.05, lam2=0.01)
    assert isinstance(s_file.design, StreamingDesign)
    assert r_file.n_iter == budget
    j_file = JSolver(str(path), y, config=JConfig(**cfg), **kw)
    _same_run(r_file, j_file.fit(lam1=0.05, lam2=0.01))
    assert abs(s_file.intercept_ - j_file.intercept_) <= 1e-5
    s_mem = TSolver(X, y, config=TConfig(**cfg), device=CPU, **kw)
    _same_run(r_file, s_mem.fit(lam1=0.05, lam2=0.01))
    assert abs(s_file.intercept_ - s_mem.intercept_) <= 1e-5


def test_reader_labels_from_file(tmp_path):
    X, rng = _dense(n=120, p=6)
    y = _labels(X, rng)
    path = write_libsvm(tmp_path / "l.libsvm", X, y)
    # 3 supersteps: f repeats from the 5th on (the float32 plateau)
    cfg = TConfig(tile_size=TILE, max_outer=3, tol=0.0)
    s = TSolver(str(path), None, family="logistic", config=cfg, device=CPU)
    res = s.fit(lam1=0.05)
    assert s._reader is not None and s._reader.n_rows == 120
    np.testing.assert_array_equal(s._ys.numpy()[:120], y)
    reader = tio.open_reader(path, chunk_rows=32)
    res2 = TSolver(reader, None, family="logistic", config=cfg,
                   device=CPU).fit(lam1=0.05)
    assert res.n_iter == res2.n_iter == 3
    np.testing.assert_allclose(res2.beta, res.beta, atol=1e-6)


@pytest.mark.skipif(not HAVE_PYARROW, reason="pyarrow not installed")
def test_parquet_reader_and_fit(tmp_path):
    from repro_torch.io.parquet import ParquetReader, write_parquet

    X, rng = _dense(n=150, p=9, seed=11)
    y = _labels(X, rng)
    path = write_parquet(tmp_path / "p.parquet", X, y)
    r = ParquetReader(path, chunk_rows=64)
    np.testing.assert_array_equal(r.labels(), y)
    np.testing.assert_array_equal(_all_chunks(r), X)
    np.testing.assert_array_equal(r.chunk_fn(1), X[64:128])   # a jump
    assert isinstance(tio.open_reader(path), ParquetReader)
    # 6 supersteps: under the 8 where the in-memory fit's f repeats
    cfg = dict(tile_size=TILE, max_outer=6, tol=0.0)
    s_file = TSolver(str(path), None, family="logistic",
                     config=TConfig(**cfg), device=CPU)
    r_file = s_file.fit(lam1=0.03, lam2=0.01)
    assert r_file.n_iter == 6
    j_file = JSolver(str(path), None, family="logistic",
                     config=JConfig(**cfg))
    _same_run(r_file, j_file.fit(lam1=0.03, lam2=0.01))
    s_mem = TSolver(X, y, family="logistic", config=TConfig(**cfg),
                    device=CPU)
    _same_run(r_file, s_mem.fit(lam1=0.03, lam2=0.01))


def test_parquet_gate_fails_closed(monkeypatch):
    from repro_torch.io import parquet

    monkeypatch.setattr(parquet, "HAVE_PYARROW", False)
    with pytest.raises(ImportError, match="pyarrow"):
        parquet.ParquetReader("nowhere.parquet")
    with pytest.raises(ImportError, match="pyarrow"):
        parquet.write_parquet("nowhere.parquet", np.zeros((2, 2)),
                              np.zeros(2))


def test_open_design_hashed(tmp_path):
    X, rng = _dense(n=90, p=20)
    y = _labels(X, rng)
    path = write_libsvm(tmp_path / "h.libsvm", X, y)
    h = FeatureHasher(24, tile_size=TILE)
    design, labels, reader = tio.open_design(
        str(path), tile_size=TILE, chunk_rows=32, hasher=h,
        prefetch_chunks=2, device=CPU)
    assert isinstance(design, StreamingDesign)
    assert design.shape[1] == h.n_features
    np.testing.assert_array_equal(labels, y)
    jdesign, _, _ = jio.open_design(str(path), tile_size=TILE, chunk_rows=32,
                                    hasher=jio.FeatureHasher(24,
                                                             tile_size=TILE))
    np.testing.assert_array_equal(design.to_dense().numpy(),
                                  np.asarray(jdesign.to_dense()))
    cfg = dict(tile_size=TILE, max_outer=8, tol=0.0)
    r_t = TSolver(design, labels, family="logistic", config=TConfig(**cfg),
                  device=CPU).fit(lam1=0.05)
    r_j = JSolver(jdesign, labels, family="logistic",
                  config=JConfig(**cfg)).fit(lam1=0.05)
    _same_run(r_t, r_j)
    with pytest.raises(ValueError, match="hashing"):
        from repro_torch.io.parquet import ParquetReader

        class Fake(ParquetReader):
            def __init__(self):
                pass
        tio.open_design(Fake(), tile_size=TILE, hasher=h, device=CPU)


# ---------------------------------------------------------------------------
# estimators and the CLI
# ---------------------------------------------------------------------------

EST = dict(tile_size=TILE, max_outer=80, tol=1e-4)


@pytest.mark.parametrize("name,family", [
    ("ElasticNetGLM", "squared"), ("LogisticRegressionCD", "logistic"),
    ("PoissonRegressorCD", "poisson")])
def test_estimator_fit_from_path(tmp_path, name, family):
    """``fit(path)`` takes the labels from the file: the same coefficients
    as JAX's ``fit(path)`` and as the port's in-memory ``fit(X, y)``."""
    X, rng = _dense(n=200, p=12, seed=5)
    y = _labels(X, rng, family)
    if family == "logistic":
        y = (y > 0).astype(np.float32)           # {0, 1} labels
    path = write_libsvm(tmp_path / "e.libsvm.gz", X, y)
    kw = dict(lam1=0.02, **EST)
    if name == "ElasticNetGLM":
        kw["family"] = family
    est = getattr(test_, name)(device=CPU, **kw).fit(str(path))
    jfit = getattr(jest, name)(**kw).fit(str(path))
    np.testing.assert_allclose(est.coef_, np.asarray(jfit.coef_), atol=1e-5)
    assert est.intercept_ == pytest.approx(float(jfit.intercept_), abs=1e-5)
    mem = getattr(test_, name)(device=CPU, **kw).fit(X, y)
    np.testing.assert_allclose(est.coef_, mem.coef_, atol=1e-5)
    np.testing.assert_allclose(est.predict(X), mem.predict(X), atol=1e-5)
    with pytest.raises(ValueError, match="y=None"):
        getattr(test_, name)(device=CPU, **kw).fit(X)


def test_multinomial_fit_from_path_and_stream(tmp_path):
    """MultinomialGLM over a file (a StreamingDesign underneath) against
    JAX's, and against the port's in-memory fit."""
    X, rng = _dense(n=240, p=12, seed=6)
    B = rng.normal(size=(12, 3)).astype(np.float32)
    y = np.argmax(X @ B + 0.3 * rng.normal(size=(240, 3)), axis=1) \
        .astype(np.float32)
    path = write_libsvm(tmp_path / "m.libsvm", X, y)
    kw = dict(lam1=0.01, standardize=False, max_cycles=3, **EST)
    est = test_.MultinomialGLM(device=CPU, **kw).fit(str(path))
    assert isinstance(est.solver_.design, StreamingDesign)
    jfit = jest.MultinomialGLM(**kw).fit(str(path))
    np.testing.assert_allclose(est.coef_, np.asarray(jfit.coef_), atol=1e-4)
    np.testing.assert_array_equal(est.classes_, np.asarray(jfit.classes_))
    mem = test_.MultinomialGLM(device=CPU, **kw).fit(X, y)
    np.testing.assert_allclose(est.coef_, mem.coef_, atol=1e-4)
    assert est.n_cycles_ == mem.n_cycles_


def test_ingest_train_smoke(capsys, tmp_path):
    out = tmp_path / "smoke.json"
    assert ingest_train.main(["--smoke", "--device", "cpu", "--json",
                              str(out)]) == 0
    assert "INGEST_SMOKE_OK" in capsys.readouterr().out
    rec = json.loads(out.read_text())
    assert rec["beta_max_err"] <= 1e-5 and rec["device"] == "cpu"


def test_ingest_train_record(capsys, tmp_path):
    """The reference's flags and record, hashed, on the CPU."""
    X, rng = _dense(n=150, p=30, seed=8)
    y = _labels(X, rng)
    path = write_libsvm(tmp_path / "t.libsvm", X, y)
    out = tmp_path / "rec.json"
    assert ingest_train.main([
        "--data", str(path), "--hash-dim", "40", "--chunk-rows", "64",
        "--tile", "16", "--steps", "4", "--device", "cpu",
        "--json", str(out)]) == 0
    rec = json.loads(out.read_text())
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == rec
    assert rec["rows"] == 150 and rec["chunks"] == 3
    assert rec["design_cols"] == 48 and rec["hash_dim"] == 40
    assert rec["n_iter"] == 4 and len(rec["f_history"]) == 4
    assert np.isfinite(rec["f"]) and rec["rows_per_s"] > 0
    with pytest.raises(SystemExit):
        ingest_train.main(["--device", "cpu"])
