"""The CUDA kernels of repro_torch against their plain PyTorch versions on
the card, and a small fit on the card against the same fit on the CPU.

Marked ``gpu``: on a machine without a CUDA device each test skips (the
check runs inside the fixture, so every pytest worker collects the same
tests).  On the card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.

Tolerances: K2 is rounded step by step like its plain version and is held
bit for bit; K1 at 1e-5 (probit 3e-4: erfc against log_ndtr); K3 and K4
are float32 sums in another order, held at 1e-5 relative to the largest
entry.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.dglmnet import DGLMNETConfig
from repro_torch.core.solver import GLMSolver
from repro_torch.data import synthetic
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu
FAMS = ["logistic", "squared", "probit", "poisson"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _vec(rng, n, dev, scale=1.0):
    return torch.from_numpy((rng.normal(size=n) * scale)
                            .astype(np.float32)).to(dev)


@pytest.mark.parametrize("family", FAMS)
def test_glm_stats_kernel(cuda, family):
    rng = np.random.default_rng(0)
    n = 100_003
    y = torch.from_numpy((rng.poisson(2.0, n) if family == "poisson"
                          else rng.choice([-1.0, 1.0], n))
                         .astype(np.float32)).to(cuda)
    xb, off = _vec(rng, n, cuda, 2.0), _vec(rng, n, cuda, 0.3)
    wt = torch.rand(n, device=cuda)
    before = ops.launch_counts()["glm_stats"]
    got = ops.glm_stats(y, xb, family, weights=wt, offset=off)
    assert ops.launch_counts()["glm_stats"] == before + 1
    want = ref.glm_stats(y, xb, wt, family, offset=off)
    tol = 3e-4 if family == "probit" else 1e-5
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("family", FAMS)
@pytest.mark.parametrize("K", [14, 20, 40])
def test_alpha_search_kernel(cuda, family, K):
    rng = np.random.default_rng(K)
    n = 70_001
    y = torch.from_numpy((rng.poisson(2.0, n) if family == "poisson"
                          else rng.choice([-1.0, 1.0], n))
                         .astype(np.float32)).to(cuda)
    xb, xdb, off = (_vec(rng, n, cuda) for _ in range(3))
    wt = torch.rand(n, device=cuda)
    alphas = torch.logspace(-3, 0, K, device=cuda)
    got = ops.alpha_search(y, xb, xdb, alphas, family, weights=wt,
                           offset=off)
    want = ref.alpha_search(y, xb, xdb, wt, alphas, family, offset=off)
    tol = 3e-4 if family == "probit" else 1e-5
    torch.testing.assert_close(got, want, rtol=0,
                               atol=tol * float(want.abs().max()))


@pytest.mark.parametrize("T", [64, 256])
def test_cd_tile_solve_kernel_is_bit_exact(cuda, T):
    rng = np.random.default_rng(T)
    X = rng.normal(size=(500, T)).astype(np.float32)
    X[:, 3] = 0.0
    w = rng.uniform(0.01, 0.25, 500).astype(np.float32)
    G = torch.from_numpy((X.T * w) @ X).to(cuda)
    g = torch.from_numpy(X.T @ rng.normal(size=500).astype(np.float32)) \
        .to(cuda)
    h = torch.diagonal(G).contiguous()
    beta = _vec(rng, T, cuda, 0.3)
    beta[3] = 0.0
    penf = torch.ones(T, device=cuda)
    penf[0] = 0.0
    mu = torch.tensor(2.0, device=cuda)
    got = ops.cd_tile_solve(G, g, h, beta, torch.zeros_like(beta), mu, 1e-6,
                            0.3, 0.1, penf=penf)
    want = ref.cd_tile_solve(G, g, h, beta, torch.zeros_like(beta), mu, 1e-6,
                             0.3, 0.1, penf=penf)
    assert torch.equal(got, want)
    assert float(got[3]) == 0.0


@pytest.mark.parametrize("K,n_valid", [(40, 40), (40, 7), (5, 0)])
def test_tile_gram_kernel(cuda, K, n_valid):
    rng = np.random.default_rng(K + n_valid)
    rb, T, n_rb = 256, 256, 64
    bricks = _vec(rng, K * rb * T, cuda).reshape(K, rb, T)
    rows = torch.from_numpy(rng.integers(0, n_rb, K).astype(np.int32)) \
        .to(cuda)
    w = torch.rand(n_rb * rb, device=cuda)
    r = _vec(rng, n_rb * rb, cuda)
    G, g = ops.tile_gram(bricks, rows, n_valid, w, r)
    G2, g2 = ref.tile_gram(bricks, rows, n_valid, w.reshape(n_rb, rb),
                           r.reshape(n_rb, rb))
    for a, b in ((G, G2), (g, g2)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * max(float(b.abs().max()), 1))


@pytest.mark.parametrize("sparse", [False, True])
def test_fit_on_the_card_matches_the_cpu(cuda, sparse):
    if sparse:
        ds = synthetic.make_sparse(n=3000, p=600, avg_nnz=20, k_true=30,
                                   seed=1)
    else:
        ds = synthetic.make_dense(n=3000, p=300, k_true=20, seed=1)
    cfg = DGLMNETConfig(tile_size=128)
    fits = []
    for dev in ("cpu", cuda):
        s = GLMSolver(ds.train.X, ds.train.y, config=cfg, device=dev,
                      fit_intercept=True, row_block=256)
        ops.reset_launch_counts()
        res = s.fit(lam1=0.05 * s.lambda_max(), max_outer=6, tol=0.0)
        fits.append((res, ops.launch_counts(), s.design.n_tiles))
    (rc, cc, _), (rg, cg, nt) = fits
    assert sum(cc.values()) == 0
    assert cg["glm_stats"] >= 6 and cg["alpha_search"] >= 12
    assert cg["cd_tile_solve"] >= 6 * nt
    assert (cg["tile_gram"] > 0) == sparse
    np.testing.assert_allclose(rg.history["f"], rc.history["f"], rtol=1e-4)
    np.testing.assert_allclose(rg.beta, rc.beta, atol=1e-3)
