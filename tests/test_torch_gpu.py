"""The CUDA kernels of repro_torch against their plain PyTorch versions on
the card, and a small fit on the card against the same fit on the CPU.

Marked ``gpu``: on a machine without a CUDA device each test skips (the
check runs inside the fixture, so every pytest worker collects the same
tests).  On the card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.

Tolerances: K2 is rounded step by step like its plain version and is held
bit for bit; K1 at 1e-5 (probit 3e-4: erfc against log_ndtr); K3 and K4
are float32 sums in another order, held at 1e-5 relative to the largest
entry (K3's and K5's products are 3xTF32 on the tensor cores, which keep
about 22 bits a product; their G must also come out exactly symmetric and
within 1e-5 of float64 sums).  K5 holds its stats like K1 and G, g like
K3; its step runs the K2 chain on a G summed in another order, so it is
held at 1e-4 of the largest step.  K6 and K7 are float32 sums in another order (1e-5).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import linesearch
from repro_torch.core.dglmnet import DGLMNETConfig
from repro_torch.core.solver import GLMSolver
from repro_torch.data import design as tdesign
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
    assert torch.equal(G, G.T)


def _rel64(G, G64):
    """max |G - G64| over max |G64| (1 for an all-zero G64)."""
    return float((G.double() - G64).abs().max()) / max(
        float(G64.abs().max()), 1.0)


@pytest.mark.parametrize("T,rb,K,n_valid", [
    (64, 256, 9, 9),        # T = 64: one 64-wide block, one warpgroup
    (128, 100, 40, 3),      # rb not a multiple of the 32-row slab
    (256, 256, 300, 250),   # the sparse fit's tiling, many splits
    (512, 64, 30, 1),       # n_valid below the split count
    (256, 40, 6, 0),        # no live brick
])
def test_tile_gram_kernel_edges(cuda, T, rb, K, n_valid):
    """K3 at the tensor-core tiling's ragged edges: G exactly symmetric and
    within 1e-5 of float64 sums (an intercept column, w spread over 1e-6
    to 0.25) as well as of the plain version."""
    rng = np.random.default_rng(T + rb + K + n_valid)
    n_rb = 50
    b_np = rng.normal(size=(K, rb, T)).astype(np.float32)
    b_np[:, :, 0] = 1.0
    rows_np = rng.integers(0, n_rb, K).astype(np.int32)
    w_np = rng.uniform(1e-6, 0.25, n_rb * rb).astype(np.float32)
    r_np = rng.normal(size=n_rb * rb).astype(np.float32)
    bricks = torch.from_numpy(b_np).to(cuda)
    rows = torch.from_numpy(rows_np).to(cuda)
    w, r = torch.from_numpy(w_np).to(cuda), torch.from_numpy(r_np).to(cuda)
    G, g = ops.tile_gram(bricks, rows, n_valid, w, r)
    G2, g2 = ref.tile_gram(bricks, rows, n_valid, w.reshape(n_rb, rb),
                           r.reshape(n_rb, rb))
    assert torch.equal(G, G.T)
    for a, b in ((G, G2), (g, g2)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * max(float(b.abs().max()), 1))
    wk = w_np.reshape(n_rb, rb)[rows_np[:n_valid]].astype(np.float64)
    bk = b_np[:n_valid].astype(np.float64)
    G64 = np.einsum("kit,ki,kiu->tu", bk, wk, bk)
    assert _rel64(G.cpu(), torch.from_numpy(G64)) <= 1e-5


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


def _labels(rng, family, n, dev):
    y = rng.poisson(1.0, n) if family == "poisson" \
        else rng.choice([-1.0, 1.0], n)
    return torch.from_numpy(y.astype(np.float32)).to(dev)


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


@pytest.mark.parametrize("family", FAMS)
@pytest.mark.parametrize("T", [128, 256])
def test_stats_gram_solve_kernel(cuda, family, T):
    rng = np.random.default_rng(T)
    n, nt = 20_003, 3
    X = (0.1 * rng.normal(size=(n, nt * T))).astype(np.float32)
    design, _ = tdesign.dense_design(X, T, device=cuda)
    y = _labels(rng, family, n, cuda)
    beta = _vec(rng, nt * T, cuda, 0.1)
    xb, off = design.matvec(beta), _vec(rng, n, cuda, 0.1)
    wt = torch.rand(n, device=cuda)
    penf = torch.rand(nt * T, device=cuda) + 0.5
    live = np.array([True, False, True])
    kw = dict(mu=torch.tensor(1.5, device=cuda), nu=1e-6, lam1=0.02,
              lam2=0.01)
    before = ops.launch_counts()["stats_gram_solve"]
    got = ops.fused_stats_sweep(design, y, xb, beta, family, weights=wt,
                                offset=off, penf=penf, tile_live=live, **kw)
    assert ops.launch_counts()["stats_gram_solve"] == before + 1
    want = ref.stats_gram_solve(design.tiles3(), y, xb, wt, beta, family,
                                offset=off, penf=penf, tile_live=live, **kw)
    tol = 3e-4 if family == "probit" else 1e-5
    for a, b in zip(got[:3], want[:3]):
        assert _rel(a, b) <= tol
    assert _rel(got[4], want[3]) <= tol and _rel(got[5], want[4]) <= tol
    assert not got[4][1].any() and not got[5][1].any()
    assert torch.equal(got[4], got[4].transpose(1, 2))
    d, dw = got[3], want[5]
    assert float((d - dw).abs().max()) <= 1e-4 * max(
        float(dw.abs().max()), 1e-3)
    assert not d[T:2 * T].any() and d.abs().max() > 0


@pytest.mark.parametrize("T,n,live", [
    (64, 4_097, [True, False, True, True]),   # T = 64, one dead tile
    (128, 50, [False, True]),                 # n under one slab
    (256, 33_333, [True, False, False]),      # n_live < nt, ragged ranges
    (512, 9_001, [True, True]),               # T = 512
])
def test_stats_gram_solve_kernel_edges(cuda, T, n, live):
    """K5 at the tensor-core tiling's ragged edges: n not a multiple of the
    slab or of the row range, dead tiles, every band edge; G exactly
    symmetric, within 1e-5 of float64 sums with an intercept column, and
    the stats, G, g and step held as in test_stats_gram_solve_kernel."""
    rng = np.random.default_rng(T + n)
    nt = len(live)
    X = (0.3 * rng.normal(size=(n, nt * T))).astype(np.float32)
    X[:, 0] = 1.0
    design, _ = tdesign.dense_design(X, T, device=cuda)
    y = _labels(rng, "logistic", n, cuda)
    beta = _vec(rng, nt * T, cuda, 0.1)
    xb, off = design.matvec(beta), _vec(rng, n, cuda, 0.1)
    wt = torch.rand(n, device=cuda)
    penf = torch.rand(nt * T, device=cuda) + 0.5
    live = np.array(live)
    kw = dict(mu=torch.tensor(1.5, device=cuda), nu=1e-6, lam1=0.02,
              lam2=0.01)
    got = ops.fused_stats_sweep(design, y, xb, beta, "logistic", weights=wt,
                                offset=off, penf=penf, tile_live=live, **kw)
    want = ref.stats_gram_solve(design.tiles3(), y, xb, wt, beta, "logistic",
                                offset=off, penf=penf, tile_live=live, **kw)
    for a, b in zip(got[:3], want[:3]):
        assert _rel(a, b) <= 1e-5
    assert _rel(got[4], want[3]) <= 1e-5 and _rel(got[5], want[4]) <= 1e-5
    assert torch.equal(got[4], got[4].transpose(1, 2))
    w64 = got[2].double().cpu()
    for t in range(nt):
        if not live[t]:
            assert not got[4][t].any() and not got[5][t].any()
            assert not got[3][t * T:(t + 1) * T].any()
            continue
        Xt = torch.from_numpy(X[:, t * T:(t + 1) * T]).double()
        assert _rel64(got[4][t].cpu(), (Xt * w64[:, None]).T @ Xt) <= 1e-5
    d, dw = got[3], want[5]
    assert float((d - dw).abs().max()) <= 1e-4 * max(
        float(dw.abs().max()), 1e-3)


@pytest.mark.parametrize("family", FAMS)
def test_margin_ls_kernel(cuda, family):
    rng = np.random.default_rng(7)
    n, p = 70_001, 384
    X = (0.1 * rng.normal(size=(n, p))).astype(np.float32)
    design, _ = tdesign.dense_design(X, 128, device=cuda)
    y = _labels(rng, family, n, cuda)
    xb, off, dbeta = _vec(rng, n, cuda), _vec(rng, n, cuda, 0.1), \
        _vec(rng, p, cuda, 0.3)
    wt = torch.rand(n, device=cuda)
    cand = linesearch.full_candidates(1e-3, 13, 0.5, 20, device=cuda)
    xdb, losses = ops.fused_ls(design, y, xb, dbeta, cand, family,
                               weights=wt, offset=off)
    xdb2, losses2 = ref.fused_ls_dense(design.tiles3(), y, xb, dbeta, wt,
                                       cand, family, offset=off)
    assert _rel(xdb, xdb2) <= 1e-5 and _rel(losses, losses2) <= 1e-5


@pytest.mark.parametrize("family", FAMS)
@pytest.mark.parametrize("kind", ["link", "response"])
def test_predict_tile_kernel(cuda, family, kind):
    rng = np.random.default_rng(3)
    A, L, B, J = 1000, 11, 3001, 45
    table = np.zeros((A + 1, L), np.float32)
    table[:-1] = 0.2 * rng.normal(size=(A, L))
    slots = torch.from_numpy(rng.integers(0, A + 1, size=(B, J))
                             .astype(np.int32)).to(cuda)
    vals, b0 = _vec(rng, B * J, cuda).reshape(B, J), _vec(rng, L, cuda)
    table = torch.from_numpy(table).to(cuda)
    got = ops.predict_tile(slots, vals, table, b0, family, kind=kind)
    want = ref.predict_tile(slots, vals, table, b0, family, kind=kind)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_jacobi_fit_on_the_card_matches_the_cpu(cuda, sparse, fused):
    if sparse:
        ds = synthetic.make_sparse(n=3000, p=600, avg_nnz=20, k_true=30,
                                   seed=1)
    else:
        ds = synthetic.make_dense(n=3000, p=300, k_true=20, seed=1)
    cfg = DGLMNETConfig(tile_size=128, coupling="jacobi",
                        fuse_superstep=fused)
    fits = []
    for dev in ("cpu", cuda):
        s = GLMSolver(ds.train.X, ds.train.y, config=cfg, device=dev,
                      fit_intercept=True, row_block=256)
        ops.reset_launch_counts()
        res = s.fit(lam1=0.05 * s.lambda_max(), max_outer=6, tol=0.0)
        fits.append((res, ops.launch_counts()))
    (rc, cc), (rg, cg) = fits
    assert sum(cc.values()) == 0
    dense_fused = fused and not sparse
    assert (cg["stats_gram_solve"] > 0) == dense_fused
    assert (cg["margin_ls"] > 0) == dense_fused
    assert (cg["tile_gram"] > 0) == sparse
    np.testing.assert_allclose(rg.history["f"], rc.history["f"], rtol=1e-4)
    np.testing.assert_allclose(rg.beta, rc.beta, atol=1e-3)
