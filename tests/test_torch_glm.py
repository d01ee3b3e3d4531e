"""repro_torch.core.glm and the small helpers of the sweep against the JAX
package: the four families' stats under weights, offsets and the poisson
curvature clip, the objective pieces, margin_score and the ALB window; the
multinomial family's stats (``kernels/ref.py`` ``multinomial_stats``) with
(n,) and (n, K) offsets; and a family added by ``register_family``, which
has no kernel body: the kernels' entry points route it to their plain
versions, and its fits equal JAX's.  Held at 1e-5 (probit 3e-4: see
tests/test_torch_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cd as jcd
from repro.core import glm as jglm
from repro.core.dglmnet import DGLMNETConfig as JConfig
from repro.core.solver import GLMSolver as JSolver
from repro.data import synthetic as jsynth
from repro.kernels import ref as jref
from repro_torch.core import cd as tcd
from repro_torch.core import glm as tglm
from repro_torch.core.dglmnet import DGLMNETConfig as TConfig
from repro_torch.core.solver import GLMSolver as TSolver
from repro_torch.data import sparse as tsparse
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

FAMS = ["logistic", "squared", "probit", "poisson"]


def _data(family, n=300, seed=0):
    rng = np.random.default_rng(seed)
    y = (rng.poisson(3.0, n) if family == "poisson"
         else rng.choice([-1.0, 1.0], n)).astype(np.float32)
    m = (rng.normal(size=n) * 2).astype(np.float32)
    if family == "poisson":
        m[:3] = 16.0                    # exp(16) > POISSON_W_CLIP
    w = rng.uniform(0.0, 2.0, n).astype(np.float32)
    o = (rng.normal(size=n) * 0.3).astype(np.float32)
    return y, m, w, o


@pytest.mark.parametrize("family", FAMS)
def test_family_stats_match_jax(family):
    y, m, w, o = _data(family)
    ours = tglm.get_family(family).stats(torch.from_numpy(y),
                                         torch.from_numpy(m),
                                         weights=torch.from_numpy(w),
                                         offset=torch.from_numpy(o))
    theirs = jglm.get_family(family).stats(jnp.asarray(y), jnp.asarray(m),
                                           weights=jnp.asarray(w),
                                           offset=jnp.asarray(o))
    tol = 3e-4 if family == "probit" else 1e-5
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol)
    if family == "poisson":
        assert float((ours[2] / torch.from_numpy(w)).max()) <= \
            tglm.POISSON_W_CLIP * (1 + 1e-6)
    np.testing.assert_allclose(
        tglm.get_family(family).predict(torch.from_numpy(m)).numpy(),
        np.asarray(jglm.get_family(family).predict(jnp.asarray(m))),
        rtol=1e-5, atol=1e-6)
    assert tglm.margin_score(family, y, m) == pytest.approx(
        jglm.margin_score(family, y, m), rel=1e-5)


@pytest.mark.parametrize("family", FAMS)
@pytest.mark.parametrize("observed", [False, True])
def test_family_deviance_matches_jax(family, observed):
    """2 sum w (l - l_sat), with weights and an offset or without; poisson
    subtracts its saturated loss (zero-count rows included)."""
    y, m, w, o = _data(family, seed=2)
    if family == "poisson":
        y[:5] = 0.0
    kt = dict(weights=torch.from_numpy(w), offset=torch.from_numpy(o)) \
        if observed else {}
    kj = dict(weights=jnp.asarray(w), offset=jnp.asarray(o)) \
        if observed else {}
    ours = tglm.get_family(family).deviance(torch.from_numpy(y),
                                            torch.from_numpy(m), **kt)
    theirs = jglm.get_family(family).deviance(jnp.asarray(y),
                                              jnp.asarray(m), **kj)
    assert ours.dim() == 0
    tol = 3e-4 if family == "probit" else 1e-5
    np.testing.assert_allclose(float(ours), float(theirs), rtol=tol)
    if family == "poisson":
        # the saturated fit m = log y has zero deviance
        ys = np.maximum(y, 1.0)
        sat = tglm.POISSON.deviance(torch.from_numpy(ys),
                                    torch.from_numpy(np.log(ys)))
        assert abs(float(sat)) < 1e-3


def test_objective_pieces_match_jax():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(50, 7)).astype(np.float32)
    y = np.where(rng.random(50) > 0.5, 1.0, -1.0).astype(np.float32)
    beta = rng.normal(size=7).astype(np.float32)
    pf = rng.uniform(0, 2, 7).astype(np.float32)
    t = torch.from_numpy
    got = tglm.objective("logistic", t(y), t(X), t(beta), 0.3, 0.2,
                         intercept=0.5, penalty_factor=t(pf))
    want = jglm.objective("logistic", jnp.asarray(y), jnp.asarray(X),
                          jnp.asarray(beta), 0.3, 0.2, intercept=0.5,
                          penalty_factor=jnp.asarray(pf))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_array_equal(
        tglm.soft_threshold(t(beta), 0.4).numpy(),
        np.asarray(jglm.soft_threshold(jnp.asarray(beta), 0.4)))
    with pytest.raises(ValueError, match="unknown GLM family"):
        tglm.get_family("no-such-family")
    assert tglm.get_family("multinomial") is tglm.MULTINOMIAL
    assert tglm.resolve_family(tglm.POISSON) is tglm.POISSON


@pytest.mark.parametrize("nt,start,budget", [(8, 0, 8), (8, 5, 3),
                                             (8, 6, 20), (5, 4, 0)])
def test_alb_live_mask_matches_jax(nt, start, budget):
    np.testing.assert_array_equal(
        tcd.alb_live_mask(nt, start, budget),
        np.asarray(jcd.alb_live_mask(nt, start, budget)))


@pytest.mark.parametrize("offset", [None, "shared", "per_class"])
@pytest.mark.parametrize("weighted", [False, True])
def test_multinomial_stats_match_jax(weighted, offset):
    """Softmax stats over (n, K) margins: loss (n,), s and w (n, K);
    weights (n,), offsets (n,) (shared by the classes) or (n, K)."""
    rng = np.random.default_rng(3)
    n, K = 200, 4
    y = rng.integers(0, K, n).astype(np.float32)
    m = (rng.normal(size=(n, K)) * 3).astype(np.float32)
    w = rng.uniform(0.0, 2.0, n).astype(np.float32) if weighted else None
    o = None if offset is None else (rng.normal(
        size=(n,) if offset == "shared" else (n, K)) * 0.5).astype(np.float32)
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    ours = tref.multinomial_stats(t(y), t(m), weights=t(w), offset=t(o))
    theirs = jref.multinomial_stats(j(y), j(m), weights=j(w), offset=j(o))
    assert [tuple(a.shape) for a in ours] == [(n,), (n, K), (n, K)]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(
        tglm.MULTINOMIAL.predict(t(m)).numpy(),
        np.asarray(jglm.MULTINOMIAL.predict(j(m))), rtol=1e-6, atol=1e-7)
    assert float(tglm.MULTINOMIAL.deviance(t(y), t(m), weights=t(w))) == \
        pytest.approx(float(jglm.MULTINOMIAL.deviance(j(y), j(m),
                                                      weights=j(w))),
                      rel=1e-5)
    assert tglm.margin_score("multinomial", y, m) == \
        jglm.margin_score("multinomial", y, m)


@pytest.fixture
def custom_squared(monkeypatch):
    """A family registered in both packages under a name no kernel knows,
    with the squared family's formulas (undone after the test)."""
    name = "custom_squared"
    fam = tglm.GLMFamily(name, tglm.SQUARED.raw_stats, lambda m: m, 1.0)
    monkeypatch.setitem(tglm.FAMILIES, name, fam)
    assert tglm.register_family(fam) is fam
    monkeypatch.setitem(jglm.FAMILIES, name, jglm.GLMFamily(
        name, jglm.SQUARED.raw_stats, lambda m: m, 1.0))
    return fam


def test_registered_family_routes_to_the_plain_versions(custom_squared):
    """The kernels' entry points give a registered family its plain
    version: the squared family's results, bit for bit, on the CPU."""
    rng = np.random.default_rng(4)
    n = 64
    y, xb, xdb, w, o = (torch.from_numpy(rng.normal(size=n)
                                         .astype(np.float32))
                        for _ in range(5))
    alphas = torch.linspace(0.0, 1.0, 7)
    for fam in (custom_squared, custom_squared.name):
        for a, b in zip(ops.glm_stats(y, xb, fam, weights=w, offset=o),
                        ops.glm_stats(y, xb, "squared", weights=w,
                                      offset=o)):
            assert torch.equal(a, b)
        assert torch.equal(
            ops.alpha_search(y, xb, xdb, alphas, fam, weights=w, offset=o),
            ops.alpha_search(y, xb, xdb, alphas, "squared", weights=w,
                             offset=o))
    with pytest.raises(ValueError, match="unknown GLM family"):
        ops.glm_stats(y, xb, "no-such-family")
    with pytest.raises(ValueError, match="unknown GLM family"):
        TSolver(np.zeros((4, 2), np.float32), np.zeros(4, np.float32),
                family="no-such-family", device="cpu")


@pytest.mark.parametrize("coupling", ["gauss-seidel", "jacobi"])
@pytest.mark.parametrize("layout", ["dense", "bricks"])
def test_registered_family_fits_like_jax(custom_squared, layout, coupling):
    """A fit under the registered family equals JAX's under its twin (beta
    within 1e-5, the same n_iter) and the port's squared fit bit for
    bit."""
    if layout == "dense":
        ds = jsynth.make_dense(n=300, p=43, k_true=8, family="squared",
                               seed=6)
        X = Xt = ds.train.X
    else:
        ds = jsynth.make_sparse(n=400, p=93, avg_nnz=10, k_true=20,
                                family="squared", seed=6)
        X = ds.train.X
        Xt = tsparse.SparseCOO(X.rows, X.cols, X.vals, X.shape)
    y = ds.train.y
    kw = dict(fit_intercept=True, row_block=32)
    fit = dict(lam1=2.0, max_outer=60, tol=1e-4)
    cfg = dict(tile_size=16, coupling=coupling)
    got = TSolver(Xt, y, family=custom_squared.name, config=TConfig(**cfg),
                  device="cpu", **kw).fit(**fit)
    plain = TSolver(Xt, y, family="squared", config=TConfig(**cfg),
                    device="cpu", **kw).fit(**fit)
    want = JSolver(X, y, family=custom_squared.name, config=JConfig(**cfg),
                   **kw).fit(**fit)
    assert got.n_iter == want.n_iter and got.converged
    np.testing.assert_allclose(got.beta, np.asarray(want.beta), rtol=0,
                               atol=1e-5)
    assert got.n_iter == plain.n_iter
    np.testing.assert_array_equal(got.beta, plain.beta)
