"""repro_torch.core.glm and the small helpers of the sweep against the JAX
package: the four families' stats under weights, offsets and the poisson
curvature clip, the objective pieces, margin_score and the ALB window.
Held at 1e-5 (probit 3e-4: see tests/test_torch_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cd as jcd
from repro.core import glm as jglm
from repro_torch.core import cd as tcd
from repro_torch.core import glm as tglm

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
        tglm.get_family("multinomial")
    assert tglm.resolve_family(tglm.POISSON) is tglm.POISSON


@pytest.mark.parametrize("nt,start,budget", [(8, 0, 8), (8, 5, 3),
                                             (8, 6, 20), (5, 4, 0)])
def test_alb_live_mask_matches_jax(nt, start, budget):
    np.testing.assert_array_equal(
        tcd.alb_live_mask(nt, start, budget),
        np.asarray(jcd.alb_live_mask(nt, start, budget)))
