"""repro_torch.checkpoint and checkpoint resume of ``GLMSolver.fit`` and
``fit_path`` on the CPU, against the JAX package's.

The manager's contracts are those of ``tests/test_checkpoint.py`` (roundtrip,
keep-last gc, an explicit step, a partial write ignored, async saves, the
last async save durable at interpreter exit, ``__del__`` joining a writer,
a tree mismatch), and its files are the JAX manager's: each package reads
what the other writes.

Resume runs on dense and brick layouts, Gauss-Seidel and fused Jacobi: a
port checkpoint resumed by the port equals the uninterrupted port run bit
for bit; a JAX checkpoint resumed by the port, and a port checkpoint
resumed by JAX, match JAX's uninterrupted run by the reference's bar (beta
within 1e-5, the same n_iter; per lambda along a path).  Fits stop at
``tol=1e-4``, away from the float32 ties of ROADMAP Queue 3 item 4.  Then
the reference's error contracts (``tests/test_solver.py``
``test_path_checkpoint_resume``).
"""
import collections
import functools
import gc
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.core.dglmnet import DGLMNETConfig as JConfig
from repro.core.solver import GLMSolver as JSolver
from repro.data import synthetic as jsynth
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as tmanager
from repro_torch.core.dglmnet import DGLMNETConfig as TConfig
from repro_torch.core.solver import GLMSolver as TSolver
from repro_torch.core.solver import lambda_max as tlambda_max
from repro_torch.data import sparse as tsparse

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small problems: torch's intra-op threads buy nothing here and,
    beside the other test workers, spin on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32))
    return {"params": {"w": t(8, 4), "layers": [t(3), t(5)]},
            "mu": torch.tensor(2.5), "step": np.int32(7)}


def _leaves(tree):
    return [np.asarray(v) for _, v in tmanager._leaves(tree)]


# ------------------------------------------------------------ the manager


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(10, t, metadata={"note": "hi"})
    restored, md = mgr.restore(_tree(1))
    assert md == {"note": "hi"}
    assert torch.is_tensor(restored["params"]["w"])
    assert restored["params"]["w"].dtype == torch.float32
    for a, b in zip(_leaves(t), _leaves(restored)):
        np.testing.assert_array_equal(a, b)


def test_keep_last_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2)
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [4, 5]


def test_latest_and_explicit_step(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=10)
    mgr.save(3, _tree(3))
    mgr.save(9, _tree(9))
    r9, _ = mgr.restore(_tree())
    r3, _ = mgr.restore(_tree(), step=3)
    assert not torch.allclose(r9["params"]["w"], r3["params"]["w"])
    assert torch.equal(r3["params"]["w"], _tree(3)["params"]["w"])
    assert mgr.latest_step() == 9
    assert mgr.read_metadata(step=3) == {}


def test_partial_write_is_ignored(tmp_path):
    """A crash mid-write leaves a .tmp directory or one without a
    manifest: restore takes the last complete checkpoint."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, _tree(5))
    (tmp_path / "ckpt_6.tmp").mkdir()
    broken = tmp_path / "ckpt_7"
    broken.mkdir()
    (broken / "shard_0.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 5
    restored, _ = mgr.restore(_tree())
    assert torch.equal(restored["params"]["w"], _tree(5)["params"]["w"])


def test_async_save(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    t = _tree(1)
    mgr.save(1, t)
    t["params"]["w"].zero_()        # the host copy was taken before
    mgr.wait()
    assert mgr.all_steps() == [1]
    restored, _ = mgr.restore(_tree())
    assert torch.equal(restored["params"]["w"], _tree(1)["params"]["w"])


def test_async_last_save_survives_interpreter_exit(tmp_path):
    """The writer threads are daemonic: without the atexit join an exit
    right after save() kills the writer mid-write.  The subprocess slows
    the serializer to force that race and exits without wait(); it must
    not import jax either."""
    script = textwrap.dedent("""
        import sys, time
        import numpy as np
        import torch
        import repro_torch.checkpoint.manager as M

        _orig = M.np.savez
        def slow_savez(*a, **kw):
            time.sleep(1.0)          # exit reaches atexit before the write
            _orig(*a, **kw)
        M.np.savez = slow_savez

        mgr = M.CheckpointManager(sys.argv[1], async_save=True)
        mgr.save(7, {"w": torch.arange(5.0)})
        assert "jax" not in sys.modules
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 7
    restored, _ = mgr.restore({"w": np.zeros(5, np.float32)})
    np.testing.assert_array_equal(restored["w"],
                                  np.arange(5.0, dtype=np.float32))


def test_del_joins_inflight_writer(tmp_path, monkeypatch):
    """Dropping the manager (its __del__) also commits a save in flight."""
    orig = np.savez

    def slow_savez(*a, **kw):
        time.sleep(0.3)
        orig(*a, **kw)

    monkeypatch.setattr(tmanager.np, "savez", slow_savez)
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(3, {"w": torch.arange(4.0)})
    del mgr
    gc.collect()
    assert CheckpointManager(tmp_path).latest_step() == 3


def test_tree_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    bad = {"params": {"w": torch.zeros((8, 4))}, "mu": torch.tensor(0.0)}
    with pytest.raises(ValueError, match="tree mismatch"):
        mgr.restore(bad)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(bad)


def test_restore_follows_the_template(tmp_path):
    """A tensor leaf comes back a tensor on the template's device with the
    stored dtype, a numpy leaf a numpy array, a scalar the stored array."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": torch.arange(3, dtype=torch.int32),
                 "b": np.ones((2, 2)), "c": 1.5})
    out, _ = mgr.restore({"a": torch.zeros(3), "b": np.zeros((2, 2)),
                          "c": 0.0})
    assert torch.is_tensor(out["a"]) and out["a"].dtype == torch.int32
    assert out["a"].device.type == "cpu"
    assert isinstance(out["b"], np.ndarray) and out["b"].dtype == np.float64
    assert float(out["c"]) == 1.5


Pair = collections.namedtuple("Pair", ["left", "right"])


def _cross_tree(seed):
    rng = np.random.default_rng(seed)
    a = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return {"beta": a(12), "xb": a(7), "mu": np.float32(3.0),
            "nested": {"z": [a(2), a(3, 2)], "pair": Pair(a(4), a(1))}}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_packages(tmp_path, writer):
    """One package writes, the other reads: the same keys (dict keys,
    list indices and named-tuple fields joined by '/'), values and
    metadata."""
    import jax
    import jax.numpy as jnp

    tree = _cross_tree(0)
    md = {"next_it": 11, "f_prev": 1.25, "design_layout": None}
    t_tree = tmanager._unflatten(tree, {
        k: torch.from_numpy(np.array(v))
        for k, v in tmanager._flatten(tree).items()})
    if writer == "jax":
        JManager(tmp_path).save(10, jax.tree.map(jnp.asarray, tree),
                                metadata=md)
        got, got_md = CheckpointManager(tmp_path).restore(t_tree)
        have = _leaves(got)
    else:
        CheckpointManager(tmp_path).save(10, t_tree, metadata=md)
        got, got_md = JManager(tmp_path).restore(
            jax.tree.map(jnp.asarray, tree))
        have = [np.asarray(v) for v in jax.tree.leaves(got)]
    want = jax.tree.leaves(tree)
    assert len(have) == len(want) == 7
    for a, b in zip(have, want):
        np.testing.assert_array_equal(a, b)
    assert got_md == md
    keys = json.loads((tmp_path / "ckpt_10" / "manifest.json")
                      .read_text())["keys"]
    assert keys == sorted(tmanager._flatten(tree)) == [
        "beta", "mu", "nested/pair/left", "nested/pair/right",
        "nested/z/0", "nested/z/1", "xb"]


# -------------------------------------------------------- solver resume

LAYOUTS = ("dense", "bricks")
COUPLINGS = ("gauss-seidel", "jacobi")
T, RB, TOL, MAX_OUTER = 16, 32, 1e-4, 100
STOP_AT, EVERY, PATH_STOP = 4, 2, 3      # supersteps / lambdas before the cut


@functools.lru_cache(maxsize=None)
def _problem(layout):
    """(X for JAX, X for the port, y, lam1 of the fits, the path's grid)."""
    if layout == "dense":
        ds = jsynth.make_dense(n=300, p=43, k_true=8, seed=4)
        X = Xt = ds.train.X
    else:
        ds = jsynth.make_sparse(n=400, p=93, avg_nnz=10, k_true=20, seed=4)
        X = ds.train.X
        Xt = tsparse.SparseCOO(X.rows, X.cols, X.vals, X.shape)
    y = ds.train.y
    lmax = tlambda_max(Xt, y, device="cpu")
    return X, Xt, y, 0.05 * lmax, lmax * np.logspace(-0.2, -1.5, 7)


def _session(pkg, layout, coupling, **kw):
    X, Xt, y, _, _ = _problem(layout)
    common = dict(fit_intercept=True, row_block=RB, **kw)
    if pkg == "jax":
        return JSolver(X, y, config=JConfig(tile_size=T, coupling=coupling),
                       **common)
    return TSolver(Xt, y, config=TConfig(tile_size=T, coupling=coupling),
                   device="cpu", **common)


def _manager(pkg, path):
    return (JManager if pkg == "jax" else CheckpointManager)(path)


def _fit(pkg, layout, coupling, mgr=None, max_outer=MAX_OUTER):
    lam = _problem(layout)[3]
    return _session(pkg, layout, coupling).fit(
        lam1=lam, max_outer=max_outer, tol=TOL, ckpt_manager=mgr,
        ckpt_every=EVERY)


def _path(pkg, layout, coupling, mgr=None, stop=None):
    grid = _problem(layout)[4]
    return _session(pkg, layout, coupling).fit_path(
        lambdas=grid if stop is None else grid[:stop], max_outer=MAX_OUTER,
        tol=TOL, ckpt_manager=mgr)


@functools.lru_cache(maxsize=None)
def _uninterrupted(pkg, layout, coupling, what):
    return (_fit if what == "fit" else _path)(pkg, layout, coupling)


@pytest.mark.parametrize("coupling", COUPLINGS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_fit_resume_is_bit_exact(tmp_path, layout, coupling):
    full = _uninterrupted("port", layout, coupling, "fit")
    assert full.n_iter > STOP_AT + 2 and full.converged
    cut = _fit("port", layout, coupling, CheckpointManager(tmp_path),
               max_outer=STOP_AT)
    assert cut.n_iter == STOP_AT and not cut.converged
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == STOP_AT
    res = _fit("port", layout, coupling, mgr)
    assert res.n_iter == full.n_iter and res.converged
    np.testing.assert_array_equal(res.beta, full.beta)
    for key in ("f", "alpha", "mu", "nnz"):
        assert res.history[key] == full.history[key][STOP_AT:], key


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("coupling", COUPLINGS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_fit_resume_across_packages(tmp_path, layout, coupling, writer):
    """One package writes the checkpoint of a cut fit, the other resumes
    it; held against JAX's uninterrupted fit."""
    reader = "port" if writer == "jax" else "jax"
    _fit(writer, layout, coupling, _manager(writer, tmp_path),
         max_outer=STOP_AT)
    res = _fit(reader, layout, coupling, _manager(reader, tmp_path))
    want = _uninterrupted("jax", layout, coupling, "fit")
    assert res.n_iter == want.n_iter
    np.testing.assert_allclose(np.asarray(res.beta), np.asarray(want.beta),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.history["f"],
                               want.history["f"][STOP_AT:], rtol=1e-5)


@pytest.mark.parametrize("coupling", COUPLINGS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_path_resume_is_bit_exact(tmp_path, layout, coupling):
    full = _uninterrupted("port", layout, coupling, "path")
    _path("port", layout, coupling, CheckpointManager(tmp_path),
          stop=PATH_STOP)
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == PATH_STOP
    res = _path("port", layout, coupling, mgr)
    for key in ("betas", "f", "nnz", "n_iters", "converged", "intercepts",
                "lambdas"):
        np.testing.assert_array_equal(getattr(res, key), getattr(full, key),
                                      err_msg=key)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("coupling", COUPLINGS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_path_resume_across_packages(tmp_path, layout, coupling, writer):
    reader = "port" if writer == "jax" else "jax"
    _path(writer, layout, coupling, _manager(writer, tmp_path),
          stop=PATH_STOP)
    res = _path(reader, layout, coupling, _manager(reader, tmp_path))
    want = _uninterrupted("jax", layout, coupling, "path")
    np.testing.assert_array_equal(res.n_iters, want.n_iters)
    np.testing.assert_array_equal(res.nnz, want.nnz)
    np.testing.assert_allclose(res.betas, want.betas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.f, want.f, rtol=1e-5)
    # the completed prefix comes back as the writer saved it
    mine = _uninterrupted(writer, layout, coupling, "path")
    np.testing.assert_allclose(res.betas[:PATH_STOP],
                               np.asarray(mine.betas)[:PATH_STOP], rtol=0,
                               atol=0)


def test_checkpoint_contracts(tmp_path):
    """The reference's errors: a path checkpoint does not resume a single
    fit and the other way round, a path resumes only on its grid, a brick
    checkpoint only onto the same layout; streaming checkpoints are not
    ported."""
    grid = _problem("dense")[4]
    path_dir = tmp_path / "path"
    _path("port", "dense", "gauss-seidel", CheckpointManager(path_dir),
          stop=PATH_STOP)
    s = _session("port", "dense", "gauss-seidel")
    with pytest.raises(ValueError, match="different λ grid"):
        s.fit_path(lambdas=grid * 2.0, ckpt_manager=CheckpointManager(
            path_dir))
    with pytest.raises(ValueError, match="different λ grid"):
        s.fit_path(lambdas=grid, lam2=0.5, ckpt_manager=CheckpointManager(
            path_dir))
    with pytest.raises(ValueError, match="written by fit_path"):
        s.fit(lam1=1.0, ckpt_manager=CheckpointManager(path_dir))
    fit_dir = tmp_path / "fit"
    _fit("port", "dense", "gauss-seidel", CheckpointManager(fit_dir),
         max_outer=STOP_AT)
    with pytest.raises(ValueError, match="written by a single fit"):
        s.fit_path(lambdas=grid, ckpt_manager=CheckpointManager(fit_dir))
    # a dense checkpoint onto bricks, and bricks onto another row block
    with pytest.raises(ValueError, match="does not match"):
        _fit("port", "bricks", "gauss-seidel", CheckpointManager(fit_dir))
    brick_dir = tmp_path / "bricks"
    _fit("port", "bricks", "gauss-seidel", CheckpointManager(brick_dir),
         max_outer=STOP_AT)
    other = _session("port", "bricks", "gauss-seidel")
    assert other._design_layout == {"kind": "bricks", "D": 1, "M": 1,
                                    "tile": T, "row_block": RB,
                                    "reorder": True}
    X, Xt, y, lam, _ = _problem("bricks")
    moved = TSolver(Xt, y, config=TConfig(tile_size=T), device="cpu",
                    fit_intercept=True, row_block=2 * RB)
    with pytest.raises(ValueError, match="does not match"):
        moved.fit(lam1=lam, ckpt_manager=CheckpointManager(brick_dir))
    # chunk-cursor saves belong to streaming sessions: an in-memory fit
    # takes ckpt_every_chunks and ignores it, as the reference does
    chunk_dir = tmp_path / "c"
    s.fit(lam1=lam, ckpt_manager=CheckpointManager(chunk_dir),
          ckpt_every_chunks=2, ckpt_every=1, max_outer=2)
    assert "stream_chunk" not in CheckpointManager(chunk_dir).read_metadata()
    # the port's layout record is JAX's
    jx = _session("jax", "bricks", "gauss-seidel")
    assert jx._design_layout == other._design_layout


def test_resume_onto_another_padding(tmp_path):
    """A dense checkpoint written with other padding (a JAX mesh pads beta
    and X beta to its own widths, and a dense layout records no layout)
    resumes exactly: real entries lead and padding trails on both
    sides."""
    full = _uninterrupted("port", "dense", "gauss-seidel", "fit")
    src = tmp_path / "src"
    _fit("port", "dense", "gauss-seidel", CheckpointManager(src),
         max_outer=STOP_AT)
    mgr = CheckpointManager(src)
    md = mgr.read_metadata()
    tree, _ = mgr.restore({"beta": np.zeros(0), "xb": np.zeros(0),
                           "mu": np.zeros(0)})
    wide = {"beta": np.pad(tree["beta"], (0, 3 * T)),
            "xb": np.pad(tree["xb"], (0, 40)), "mu": tree["mu"]}
    CheckpointManager(tmp_path / "wide").save(STOP_AT, wide, metadata=md)
    res = _fit("port", "dense", "gauss-seidel",
               CheckpointManager(tmp_path / "wide"))
    assert res.n_iter == full.n_iter
    np.testing.assert_array_equal(res.beta, full.beta)
