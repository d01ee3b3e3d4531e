"""The plain PyTorch versions of the four ported kernels (repro_torch.kernels)
against the JAX package's ``ops.*``, both its Pallas kernels (interpret mode
on the CPU) and its jnp oracles, on the same numpy inputs.

Tolerances: 1e-5, the float32 bar the reference sets for itself.  Probit
is held at 3e-4, the figure tests/test_kernels.py uses against the Pallas
body (which takes log Phi through erfc while both oracles use log_ndtr).
Against the jnp oracle it needs the same room: its curvature
w = r (r + t), r = phi/Phi, cancels for t < 0 to a value of size 1/t^2
from terms of size t^2, so at t near -8 a float32 rounding of r (however
log Phi is computed) moves w by a few 1e-5.  The left tail t < -12 has its
own test below.
The line-search losses are sums over the examples and are compared relative
to the largest loss (the summation order differs between the packages).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import alpha_search as alpha_search_k
from repro_torch.kernels import build
from repro_torch.kernels import cd_tile_solve as cd_tile_solve_k
from repro_torch.kernels import glm_stats as glm_stats_k
from repro_torch.kernels import ops, ref
from repro_torch.kernels import tile_gram as tile_gram_k

FAMS = ["logistic", "squared", "probit", "poisson"]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _obs(family, n, seed):
    rng = np.random.default_rng(seed)
    y = (rng.poisson(2.0, n) if family == "poisson"
         else rng.choice([-1.0, 1.0], n)).astype(np.float32)
    xb = (rng.normal(size=n) * 2).astype(np.float32)
    weights = rng.uniform(0.0, 2.0, n).astype(np.float32)
    weights[::5] = 0.0                  # zero weights (padding, folds)
    offset = (rng.normal(size=n) * 0.3).astype(np.float32)
    return rng, y, xb, weights, offset


@pytest.mark.parametrize("family", FAMS)
@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("n", [100, 1000])
def test_glm_stats_matches_jax(family, backend, n):
    _, y, xb, wt, off = _obs(family, n, seed=n)
    for offset in (None, off):
        ours = ops.glm_stats(_t(y), _t(xb), family, weights=_t(wt),
                             offset=None if offset is None else _t(offset))
        theirs = jops.glm_stats(
            jnp.asarray(y), jnp.asarray(xb), family,
            weights=jnp.asarray(wt),
            offset=None if offset is None else jnp.asarray(offset),
            backend=backend, block_rows=8)
        tol = 3e-4 if family == "probit" else 1e-5
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                       atol=tol)
        assert float(ours[0][::5].abs().max()) == 0.0   # zero weight -> 0


@pytest.mark.parametrize("family", FAMS)
@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("K", [1, 14, 20])
def test_alpha_search_matches_jax(family, backend, K):
    rng, y, xb, wt, off = _obs(family, 513, seed=K)
    xdb = rng.normal(size=513).astype(np.float32)
    alphas = np.logspace(-3, 0, K).astype(np.float32)
    ours = ops.alpha_search(_t(y), _t(xb), _t(xdb), _t(alphas), family,
                            weights=_t(wt), offset=_t(off)).numpy()
    theirs = np.asarray(jops.alpha_search(
        jnp.asarray(y), jnp.asarray(xb), jnp.asarray(xdb),
        jnp.asarray(alphas), family, weights=jnp.asarray(wt),
        offset=jnp.asarray(off), backend=backend, block_rows=8))
    tol = 3e-4 if family == "probit" and backend == "pallas" else 1e-5
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=tol * np.abs(theirs).max())


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_probit_left_tail(backend):
    """t = y m in [-30, -12], where the Pallas body switches to its
    asymptotic tail.  The loss (about t^2/2) is well conditioned: 1e-6
    against the oracle; the Pallas tail keeps only the leading term of the
    asymptotic series, whose relative error 1/t^2 over a loss of t^2/2 is
    below 1e-4.  s = y exp(log phi - log Phi) cancels two numbers near t^2/2
    whose float32 spacing is up to 3e-5, hence 1e-4 against the oracle (the
    leading-term tail is off by 1/t^2 in s, so s and w are not held against
    the Pallas body here).  w = r (r + t) tends to 1 but cancels to that
    from terms of size t^2 (up to 900 here), so float32 leaves it only
    within 0.1 of 1."""
    t = np.linspace(-30.0, -12.0, 64).astype(np.float32)
    y = np.where(np.arange(64) % 2, 1.0, -1.0).astype(np.float32)
    xb = (t * y).astype(np.float32)
    wt = np.ones(64, np.float32)
    loss, s, w = ops.glm_stats(_t(y), _t(xb), "probit", weights=_t(wt))
    jl, js, _ = jops.glm_stats(jnp.asarray(y), jnp.asarray(xb), "probit",
                               weights=jnp.asarray(wt), backend=backend,
                               block_rows=8)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl),
                               rtol=1e-6 if backend == "ref" else 1e-4)
    if backend == "ref":
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4)
    assert float((w - 1.0).abs().max()) <= 0.1


def _tile(seed, n, T, dead=()):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, T)).astype(np.float32)
    X[:, list(dead)] = 0.0
    w = rng.uniform(0.01, 0.25, n).astype(np.float32)
    s = rng.normal(size=n).astype(np.float32)
    beta = (rng.normal(size=T) * 0.3).astype(np.float32)
    beta[list(dead)] = 0.0
    dbeta = (rng.normal(size=T) * 0.05).astype(np.float32)
    dbeta[list(dead)] = 0.0
    G = (X.T * w) @ X
    return G, X.T @ s, np.diag(G).copy(), beta, dbeta, rng


@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("T,mu,lam1,lam2", [(8, 1.0, 0.3, 0.1),
                                            (32, 4.0, 1.5, 0.0),
                                            (64, 2.0, 0.05, 0.2)])
def test_cd_tile_solve_matches_jax(backend, T, mu, lam1, lam2):
    dead = (1, T - 1)
    G, g, h, beta, dbeta, rng = _tile(T, 200, T, dead=dead)
    penf = rng.uniform(0.5, 1.5, T).astype(np.float32)
    penf[0] = 0.0                       # an unpenalized (intercept) column
    nu = 1e-6 if lam2 else 0.0          # nu = lam2 = 0: dead den = 0
    for pf in (None, penf):
        ours = ops.cd_tile_solve(_t(G), _t(g), _t(h), _t(beta), _t(dbeta),
                                 ops.solve_params(mu, nu, lam1, lam2, _t(g)),
                                 penf=None if pf is None else _t(pf)).numpy()
        theirs = np.asarray(jops.cd_tile_solve(
            jnp.asarray(G), jnp.asarray(g), jnp.asarray(h),
            jnp.asarray(beta), jnp.asarray(dbeta), mu, nu, lam1, lam2,
            penf=None if pf is None else jnp.asarray(pf), backend=backend))
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)
        for j in dead:                  # dead columns come back exactly 0
            assert ours[j] == 0.0 and theirs[j] == 0.0


@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("K,rb,T,n_rb", [(1, 8, 16, 4), (7, 16, 8, 9),
                                         (12, 32, 32, 12)])
def test_tile_gram_matches_jax(backend, K, rb, T, n_rb):
    rng = np.random.default_rng(K)
    bricks = rng.normal(size=(K, rb, T)).astype(np.float32)
    rows = rng.integers(0, n_rb, K).astype(np.int32)
    w = rng.uniform(0.0, 0.3, n_rb * rb).astype(np.float32)
    r = rng.normal(size=n_rb * rb).astype(np.float32)
    for n_valid in (0, K // 2, K):
        G, g = ops.tile_gram(_t(bricks), torch.from_numpy(rows), n_valid,
                             _t(w), _t(r))
        Gj, gj = jops.tile_gram(
            jnp.asarray(bricks), jnp.asarray(rows), jnp.int32(n_valid),
            jnp.asarray(w.reshape(n_rb, rb)),
            jnp.asarray(r.reshape(n_rb, rb)), backend=backend)
        np.testing.assert_allclose(G.numpy(), np.asarray(Gj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-5,
                                   atol=1e-5)


def test_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    ops.reset_launch_counts()
    G, g, h, beta, dbeta, _ = _tile(0, 50, 16)
    ops.cd_tile_solve(_t(G), _t(g), _t(h), _t(beta), _t(dbeta),
                      ops.solve_params(1.0, 1e-6, 0.1, 0.1, _t(g)))
    ops.glm_stats(_t(beta), _t(dbeta), "logistic")
    assert ops.launch_counts() == {
        **{k: 0 for k in ops.KERNELS},
        **{f"{k}/plain": 0 for k in ops.PLAIN_ROUTES}}
    assert glm_stats_k.plain is ref.glm_stats
    assert cd_tile_solve_k.plain is ref.cd_tile_solve
    assert tile_gram_k.plain is ref.tile_gram
    assert alpha_search_k.plain is ref.alpha_search


@pytest.mark.parametrize("launch,args", [
    (glm_stats_k.launch, lambda v: (v, v, v, "logistic")),
    (alpha_search_k.launch, lambda v: (v, v, v, v, v[:3], "logistic")),
    (cd_tile_solve_k.launch,
     lambda v: (v[:16].reshape(4, 4), v[:4], v[:4], v[:4], v[:4], v[:4],
                v[:4])),
    (tile_gram_k.launch,
     lambda v: (v.reshape(1, 8, 8), v[:1].to(torch.int32), 1, v[:8],
                v[:8])),
])
def test_kernel_launchers_refuse_cpu_tensors(launch, args):
    """A launcher never runs the plain version: a CPU tensor is refused
    before any build or launch."""
    with pytest.raises(ValueError, match="CUDA"):
        launch(*args(torch.zeros(64)))


def test_other_devices_are_refused():
    v = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.glm_stats(v, v, "logistic")


def test_build_flags_target_hopper_and_hash_the_sources():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for name in build.SOURCES + build.HEADERS:
        assert (build.CSRC / name).is_file()
    assert build.library_path().parent.name == build.source_hash()
