"""The port's FISTA oracle (``repro_torch.core.prox_ref``) against the
reference's on the CPU, and d-GLMNET held against the port's own oracle
with no JAX call, as tests/test_dglmnet.py holds the reference.

FISTA's stop test ends a run when two float32 objectives in a row are
equal; near that plateau the two packages' float32 sums (another order)
make it, and the monotone restart's ``f < f_best``, tie in one package and
not in the other, so the full runs stop an iteration apart and beta lies
up to 6e-4 apart (logistic; their last f within 1.2e-7).  So the last f
of the full runs is held at 1e-6 relative, and beta at 1e-4 after a fixed
25 iterations (tol = 0), where the paths agree.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import glm as j_glm
from repro.core import prox_ref as j_prox
from repro.data import synthetic as j_synth
from repro_torch.core import glm as t_glm
from repro_torch.core import prox_ref
from repro_torch.core.dglmnet import DGLMNETConfig
from repro_torch.core.solver import GLMSolver

FAMS = ["logistic", "squared", "probit", "poisson"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These problems are a few hundred rows: torch's intra-op threads buy
    nothing there and, beside the other test workers, spin on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(family):
    ds = j_synth.make_dense(n=500, p=80, family=family, seed=2)
    return ds.train.X, ds.train.y


@pytest.mark.parametrize("family", FAMS)
def test_fit_fista_matches_jax(family):
    X, y = _data(family)
    _, h_j = j_prox.fit_fista(X, y, family=family, lam1=0.7, lam2=0.4,
                              max_iter=4000)
    b_t, h_t = prox_ref.fit_fista(X, y, family=family, lam1=0.7, lam2=0.4,
                                  max_iter=4000, device="cpu")
    assert abs(h_t[-1] / h_j[-1] - 1) <= 1e-6, (h_t[-1], h_j[-1])
    assert abs(len(h_t) - len(h_j)) <= 1        # the stop test's tie
    f_t = float(t_glm.objective(family, torch.from_numpy(y),
                                torch.from_numpy(X), torch.from_numpy(b_t),
                                0.7, 0.4))
    assert f_t == pytest.approx(min(h_t), rel=1e-6)


@pytest.mark.parametrize("family", FAMS)
def test_fit_fista_path_matches_jax(family):
    """25 iterations, no stop test: beta within 1e-4, every f within
    1e-6 relative but poisson's within 2e-6 (f ~ -4,769 there: a few of
    its float32 steps)."""
    X, y = _data(family)
    b_j, h_j = j_prox.fit_fista(X, y, family=family, lam1=0.7, lam2=0.4,
                                max_iter=25, tol=0.0)
    b_t, h_t = prox_ref.fit_fista(X, y, family=family, lam1=0.7, lam2=0.4,
                                  max_iter=25, tol=0.0, device="cpu")
    assert len(h_t) == len(h_j) == 26
    np.testing.assert_allclose(b_t, b_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(h_t, h_j, atol=0,
                               rtol=2e-6 if family == "poisson" else 1e-6)


@pytest.mark.parametrize("lam1,lam2", [(0.7, 0.0), (0.0, 0.4), (0.3, 1.2)])
def test_prox_elastic_net_matches_jax(lam1, lam2):
    v = np.random.default_rng(0).normal(size=257).astype(np.float32)
    want = np.asarray(j_prox.prox_elastic_net(jnp.asarray(v), 0.37, lam1,
                                              lam2))
    got = prox_ref.prox_elastic_net(torch.from_numpy(v), 0.37, lam1, lam2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)


def test_lipschitz_estimate_is_the_references():
    """The power iteration in float64 from default_rng(0), as the
    reference runs it in numpy."""
    X, _ = _data("logistic")
    v = np.random.default_rng(0).normal(size=X.shape[1])
    v /= np.linalg.norm(v)
    for _ in range(50):
        v = X.T @ (X @ v)
        v /= max(np.linalg.norm(v), 1e-30)
    want = float(v @ (X.T @ (X @ v)))
    assert prox_ref.lipschitz_sigma_sq(torch.from_numpy(X)) == \
        pytest.approx(want, rel=1e-12)


def test_families_share_the_references_curvature_bounds():
    for name in FAMS:
        assert t_glm.resolve_family(name).curvature_bound == \
            j_glm.resolve_family(name).curvature_bound


@pytest.mark.parametrize("family", ["logistic", "squared", "probit"])
@pytest.mark.parametrize("coupling", ["gauss-seidel", "jacobi"])
def test_dglmnet_converges_to_port_oracle(family, coupling):
    """The port's d-GLMNET against the port's FISTA, no JAX: the bar of
    tests/test_dglmnet.py::test_converges_to_oracle."""
    ds = j_synth.make_dense(n=500, p=80, family=family, seed=2)
    X, y = ds.train.X, ds.train.y
    lam1, lam2 = 0.7, 0.4
    cfg = DGLMNETConfig(family=family, lam1=lam1, lam2=lam2, tile_size=16,
                        coupling=coupling, max_outer=120, tol=1e-12)
    res = GLMSolver(X, y, config=cfg, device="cpu").fit(lam1, lam2)
    _, hist = prox_ref.fit_fista(X, y, family=family, lam1=lam1, lam2=lam2,
                                 max_iter=4000, device="cpu")
    f_d = float(t_glm.objective(family, torch.from_numpy(y),
                                torch.from_numpy(X),
                                torch.from_numpy(res.beta), lam1, lam2))
    f_o = hist[-1]
    assert f_d <= f_o + 1e-3 * max(1.0, abs(f_o)), (f_d, f_o)
