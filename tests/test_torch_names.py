"""The public names of the reference that the ported modules lacked, held
against the JAX package on the same numpy inputs, on the CPU.

  * ``GLMFamily.loss`` per family (and the multinomial one's) against
    JAX's within 1e-6 relative (float32 formulas, the same math);
  * ``au_prc`` bit for bit (numpy in both), with ties and with no positive;
  * ``SparseCOO.permute_cols`` and ``to_dense_blocks`` bit for bit;
  * the deprecated one-shot ``dglmnet.fit``: it warns once, equals
    ``GLMSolver(...).fit()`` bit for bit and JAX's ``dglmnet.fit`` within
    1e-5 in beta for a dense array, a ``SparseCOO`` and a prebuilt
    ``BlockSparseDesign`` with its ``design_info``; without it, the
    prebuilt design raises ``ValueError``, as the reference's
    ``tests/test_design.py`` holds.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dglmnet as jdglmnet
from repro.core import glm as jglm
from repro.core.dglmnet import DGLMNETConfig as JConfig
from repro.data import design as jdesign
from repro.data import sparse as jsparse
from repro.data import synthetic as jsynth
from repro_torch.core import dglmnet as tdglmnet
from repro_torch.core import glm as tglm
from repro_torch.core.dglmnet import DGLMNETConfig as TConfig
from repro_torch.core.solver import GLMSolver
from repro_torch.data import design as tdesign
from repro_torch.data import sparse as tsparse
from repro_torch.data import synthetic as tsynth

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labels(rng, family, n):
    if family == "poisson":
        return rng.poisson(2.0, n).astype(np.float32)
    if family == "squared":
        return rng.normal(size=n).astype(np.float32)
    return np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)


# ------------------------------------------------------------ GLMFamily.loss

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("family", ["logistic", "squared", "probit",
                                    "poisson"])
def test_family_loss_matches_jax(family, weighted):
    rng = np.random.default_rng(0)
    n = 257
    y = _labels(rng, family, n)
    m = (1.5 * rng.normal(size=n)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, n).astype(np.float32) if weighted else None
    o = (0.2 * rng.normal(size=n)).astype(np.float32) if weighted else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    fam = tglm.get_family(family)
    got = fam.loss(t(y), t(m), weights=t(w), offset=t(o)).numpy()
    want = np.asarray(jglm.get_family(family).loss(j(y), j(m), weights=j(w),
                                                   offset=j(o)))
    assert got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # stats()[0] by definition, and the deviance goes through it
    np.testing.assert_array_equal(
        got, fam.stats(t(y), t(m), weights=t(w), offset=t(o))[0].numpy())


def test_multinomial_loss_matches_jax():
    rng = np.random.default_rng(1)
    n, K = 100, 4
    y = rng.integers(0, K, n).astype(np.float32)
    m = rng.normal(size=(n, K)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    o = (0.1 * rng.normal(size=n)).astype(np.float32)
    got = tglm.MULTINOMIAL.loss(torch.from_numpy(y), torch.from_numpy(m),
                                weights=torch.from_numpy(w),
                                offset=torch.from_numpy(o)).numpy()
    want = np.asarray(jglm.MULTINOMIAL.loss(jnp.asarray(y), jnp.asarray(m),
                                            weights=jnp.asarray(w),
                                            offset=jnp.asarray(o)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------------- au_prc

@pytest.mark.parametrize("case", ["random", "ties", "no_positive",
                                  "all_positive", "perfect"])
def test_au_prc_bit_for_bit(case):
    rng = np.random.default_rng(2)
    n = 500
    y = np.where(rng.random(n) < 0.3, 1.0, -1.0)
    s = rng.normal(size=n)
    if case == "ties":
        s = np.round(s, 1)           # many equal scores: the stable order
    elif case == "no_positive":
        y = -np.ones(n)
    elif case == "all_positive":
        y = np.ones(n)
    elif case == "perfect":
        s = y + 0.01 * rng.random(n)
    got = tsynth.au_prc(y, s)
    want = jsynth.au_prc(y, s)
    assert isinstance(got, float) and got == want
    if case == "no_positive":
        assert got == 0.0
    if case in ("all_positive", "perfect"):
        assert got == 1.0


# -------------------------------------------------- permute_cols, dense tiles

def _coo_pair(seed=3, n=300, p=45, nnz=900):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz)
    cols = (rng.pareto(1.2, nnz) * p / 6).astype(np.int64) % p
    vals = rng.normal(size=nnz).astype(np.float32)
    t = tsparse.SparseCOO(rows, cols, vals, (n, p)).dedupe()
    j = jsparse.SparseCOO(rows, cols, vals, (n, p)).dedupe()
    return t, j


def test_permute_cols_bit_for_bit():
    t, j = _coo_pair()
    perm = np.random.default_rng(4).permutation(t.shape[1])
    a, b = t.permute_cols(perm), j.permute_cols(perm)
    for k in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.shape == b.shape
    # column k of the permuted matrix is column perm[k]
    np.testing.assert_array_equal(a.to_dense(), t.to_dense()[:, perm])


@pytest.mark.parametrize("tile,reorder", [(8, True), (8, False), (16, True),
                                          (64, True)])
def test_to_dense_blocks_bit_for_bit(tile, reorder):
    t, j = _coo_pair()
    dt, pt, ot = tsparse.to_dense_blocks(t, tile, reorder=reorder)
    dj, pj, oj = jsparse.to_dense_blocks(j, tile, reorder=reorder)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(pt, pj)
    assert ot == oj and 0.0 < ot <= 1.0
    assert dt.dtype == np.float32 and dt.shape[1] % tile == 0


# ------------------------------------------------------ deprecated dglmnet.fit

CFG = dict(lam1=0.5, lam2=0.1, tile_size=16, max_outer=30, tol=1e-4)


@pytest.fixture(scope="module")
def sparse_data():
    ds = tsynth.make_sparse(n=250, p=300, avg_nnz=15, k_true=20, seed=13)
    return ds.train.X, ds.train.y


def test_fit_warns_once_per_name(sparse_data):
    X, y = sparse_data
    tdglmnet._DEPRECATION_WARNED.discard("fit")
    cfg = TConfig(**dict(CFG, max_outer=2))
    with pytest.warns(DeprecationWarning, match="GLMSolver"):
        tdglmnet.fit(X.to_dense(), y, cfg, device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tdglmnet.fit(X.to_dense(), y, cfg, device=CPU)


@pytest.mark.parametrize("kind", ["dense", "coo", "prebuilt"])
def test_fit_matches_session_and_jax(sparse_data, kind):
    X, y = sparse_data
    jX = jsparse.SparseCOO(X.rows, X.cols, X.vals, X.shape)
    kw = {}
    if kind == "dense":
        tin, jin = X.to_dense(), X.to_dense()
    elif kind == "coo":
        tin, jin = X, jX
    else:
        tin, info = tdesign.build_block_sparse(X, 16, device=CPU)
        jin, jinfo = jdesign.build_block_sparse(jX, 16)
        kw = {"design_info": info}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res = tdglmnet.fit(tin, y, TConfig(**CFG), device=CPU, **kw)
        jres = jdglmnet.fit(jin, y, JConfig(**CFG),
                            **({"design_info": jinfo} if kw else {}))
    ses = GLMSolver(tin, y, config=TConfig(**CFG), device=CPU, **kw).fit()
    assert res.beta.shape == (X.shape[1],)
    np.testing.assert_array_equal(res.beta, ses.beta)
    assert res.history["f"] == ses.history["f"]
    assert res.n_iter == ses.n_iter == jres.n_iter
    np.testing.assert_allclose(res.beta, np.asarray(jres.beta), atol=1e-5)


def test_prebuilt_design_requires_info(sparse_data):
    X, y = sparse_data
    design, info = tdesign.build_block_sparse(X, 16, device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError, match="DesignInfo"):
            tdglmnet.fit(design, y, TConfig(**CFG), device=CPU)
        r_pre = tdglmnet.fit(design, y, TConfig(**CFG), device=CPU,
                             design_info=info)
        r_coo = tdglmnet.fit(X, y, TConfig(**CFG), device=CPU)
    np.testing.assert_allclose(r_pre.beta, r_coo.beta, atol=1e-6)
    assert r_pre.beta.shape == (X.shape[1],)


def test_fit_defaults_to_the_card(sparse_data, monkeypatch):
    """``device=None`` is the CUDA card: on a machine without one it
    raises, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = sparse_data
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdglmnet.fit(X.to_dense(), y, TConfig(**CFG))


def test_dist_public_names_match_jax():
    """repro_torch.dist exports the reference's public names."""
    import repro.dist as jdist
    import repro_torch.dist as tdist
    assert tdist.__all__ == jdist.__all__
    for name in jdist.__all__:
        assert hasattr(tdist, name), name


@pytest.mark.parametrize("module", ["core.alb", "dist.bootstrap",
                                    "dist.faults", "dist.launcher",
                                    "dist.telemetry", "sharding.compress",
                                    "launch.dist_run"])
def test_ported_dist_modules_keep_the_reference_names(module):
    """Each public function and class of the reference's module is in the
    port's (the jax.distributed client and the XLA flags excepted)."""
    import importlib
    import inspect
    jm = importlib.import_module(f"repro.{module}")
    tm = importlib.import_module(f"repro_torch.{module}")
    names = {n for n, v in vars(jm).items()
             if not n.startswith("_") and (inspect.isfunction(v)
                                           or inspect.isclass(v))
             and getattr(v, "__module__", "") == jm.__name__}
    missing = sorted(n for n in names if not hasattr(tm, n))
    assert missing == []
