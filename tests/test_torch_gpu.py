"""The CUDA kernels of repro_torch against their plain PyTorch versions on
the card, and a small fit on the card against the same fit on the CPU.

Marked ``gpu``: on a machine without a CUDA device each test skips (the
check runs inside the fixture, so every pytest worker collects the same
tests).  On the card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.

Tolerances: K2 is rounded step by step like its plain version and is held
bit for bit (so is K5's solve pass, the same chain, on K5's own G and g);
K1 at 1e-5 (probit 3e-4: erfc against log_ndtr); K3 and K4
are float32 sums in another order, held at 1e-5 relative to the largest
entry (K3's and K5's products are 3xTF32 on the tensor cores, which keep
about 22 bits a product; their G must also come out exactly symmetric and
within 1e-5 of float64 sums).  K5 holds its stats like K1 and G, g like
K3; its step runs the K2 chain on a G summed in another order, so it is
held at 1e-4 of the largest step.  K6 and K7 are float32 sums in another
order (1e-5); two K6 runs must give the same bits (fixed-order sums), and
so must two K4 runs, which also leave K4's ticket counter at 0.
The bf16 modes of K3, K5 and K6 (``precision="bf16"``) are held against
their plain bf16 versions the same way; their G is not symmetric.
A traced fit (``repro_torch.obs``) must equal the untraced one bit for
bit, and its spans must be ``torch.profiler`` ranges that hold the host
launches of K1-K4, with one NVTX push and pop a span.
The audits of ``repro_torch.analysis`` pass on the card (kernel_smem runs
there: every kernel within the card's limits, as ptxas reported it).
The recurrences' scans (ssm_scan, mlstm_scan, slstm_scan) are held at 1e-5
of the largest |value| where both are finite, the non-finite positions
equal, at small and ragged shapes, and their routing: frozen inputs
launch, an input that requires a gradient runs the plain loop, counted.
"""
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.core import linesearch
from repro_torch.core.dglmnet import DGLMNETConfig
from repro_torch.core.solver import GLMSolver
from repro_torch.data import design as tdesign
from repro_torch.data import synthetic
from repro_torch.kernels import alpha_search, margin_ls, ops, ref

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


def _alpha_inputs(rng, family, n, dev):
    y = torch.from_numpy((rng.poisson(2.0, n) if family == "poisson"
                          else rng.choice([-1.0, 1.0], n))
                         .astype(np.float32)).to(dev)
    xb, xdb, off = (_vec(rng, n, dev) for _ in range(3))
    return y, xb, xdb, torch.rand(n, device=dev), off


def _candidates(K, dev):
    """The fused superstep's 294 candidates, then more chains past them."""
    full = linesearch.full_candidates(1e-3, 13, 0.5, 20, device=dev)
    extra = linesearch.backtrack_chains(full[:1], 0.5, max(K - 294, 1))[0]
    return torch.cat([full, extra])[:K]


@pytest.mark.parametrize("family", FAMS)
@pytest.mark.parametrize("K", [294, 321])
@pytest.mark.parametrize("n", [131_072, 70_003])
def test_alpha_search_kernel_many_candidates(cuda, family, K, n):
    """K4 with the candidates across lanes: every candidate of the fused
    superstep, and past one pass of 320; n a multiple of the blocks' 256
    rows, and n % 4 = 3."""
    rng = np.random.default_rng(K + n)
    y, xb, xdb, wt, off = _alpha_inputs(rng, family, n, cuda)
    alphas = _candidates(K, cuda)
    got = ops.alpha_search(y, xb, xdb, alphas, family, weights=wt,
                           offset=off)
    want = ref.alpha_search(y, xb, xdb, wt, alphas, family, offset=off)
    tol = 3e-4 if family == "probit" else 1e-5
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("K", [14, 20, 294])
def test_alpha_search_kernel_one_launch_same_bits(cuda, K):
    """One logical launch is counted a call; two calls give the same bits
    (fixed rows, fixed-order sums, no float atomics); the last block sets
    the ticket counter back to 0."""
    rng = np.random.default_rng(K)
    y, xb, xdb, wt, off = _alpha_inputs(rng, "logistic", 400_000, cuda)
    alphas = _candidates(K, cuda)
    before = ops.launch_counts()["alpha_search"]
    runs = [ops.alpha_search(y, xb, xdb, alphas, "logistic", weights=wt,
                             offset=off) for _ in range(2)]
    assert ops.launch_counts()["alpha_search"] == before + 2
    assert torch.equal(runs[0], runs[1])
    torch.cuda.synchronize()
    assert int(alpha_search.ticket(cuda).item()) == 0


@pytest.mark.parametrize("K", [20, 294])
def test_alpha_search_kernel_on_another_stream(cuda, K):
    """A launch on a second stream takes that stream's own ticket counter
    and scratch, gives the bits of a launch on the default stream, and
    leaves both counters at 0."""
    rng = np.random.default_rng(5)
    y, xb, xdb, wt, off = _alpha_inputs(rng, "logistic", 100_001, cuda)
    alphas = _candidates(K, cuda)
    got = ops.alpha_search(y, xb, xdb, alphas, "logistic", weights=wt,
                           offset=off)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        other = ops.alpha_search(y, xb, xdb, alphas, "logistic", weights=wt,
                                 offset=off)
        side_ticket = alpha_search.ticket(cuda)
    torch.cuda.synchronize()
    assert side_ticket.data_ptr() != alpha_search.ticket(cuda).data_ptr()
    assert torch.equal(got, other)
    assert int(side_ticket.item()) == 0
    assert int(alpha_search.ticket(cuda).item()) == 0


@pytest.mark.parametrize("family", FAMS)
@pytest.mark.parametrize("n", [131_073, 400_002])
def test_glm_stats_kernel_misaligned_offset(cuda, family, n):
    """n % 4 != 0, and an offset view whose storage offset leaves it off a
    16-byte boundary: the element path, still right (max error over the
    largest entry, as chip_smoke.py holds K1), and the same bits as the
    vector path on aligned copies."""
    rng = np.random.default_rng(n)
    y = torch.from_numpy((rng.poisson(2.0, n) if family == "poisson"
                          else rng.choice([-1.0, 1.0], n))
                         .astype(np.float32)).to(cuda)
    xb, wt = _vec(rng, n, cuda, 2.0), torch.rand(n, device=cuda)
    off = _vec(rng, n + 3, cuda, 0.3)[3:]
    assert off.data_ptr() % 16 != 0 and off.is_contiguous()
    got = ops.glm_stats(y, xb, family, weights=wt, offset=off)
    want = ref.glm_stats(y, xb, wt, family, offset=off)
    if family == "probit":
        # loss and s as K1 is held (3e-4: erfc against log_ndtr); w = r (r
        # + t) cancels in float32 from terms of size t^2
        # (test_torch_kernels.py::test_probit_left_tail), so past |t| of
        # about 7 its error grows like t^4
        assert max(_rel(a, b) for a, b in zip(got[:2], want[:2])) <= 3e-4
        t = (y * (xb + off)).abs()
        assert bool(((got[2] - want[2]).abs()
                     <= 3e-4 + 2e-7 * t ** 4).all())
    else:
        assert max(_rel(a, b) for a, b in zip(got, want)) <= 1e-5
    # aligned copies take the vector path and give the same bits
    again = ops.glm_stats(y, xb, family, weights=wt, offset=off.clone())
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _chain_tile(rng, T, dev, n=500):
    X = rng.normal(size=(n, T)).astype(np.float32)
    X[:, 3] = 0.0
    w = rng.uniform(0.01, 0.25, n).astype(np.float32)
    G = torch.from_numpy((X.T * w) @ X).to(dev)
    g = torch.from_numpy(X.T @ rng.normal(size=n).astype(np.float32)) \
        .to(dev)
    return G, g


@pytest.mark.parametrize("T", [64, 100, 256, 512, 1024])
def test_cd_tile_solve_kernel_is_bit_exact(cuda, T):
    """K2's panel chain gives the plain version's bits, at a ragged last
    panel (T = 100) and up to 32 panels; h contiguous or the strided
    diagonal view of G; an entering step as Gauss-Seidel has."""
    rng = np.random.default_rng(T)
    G, g = _chain_tile(rng, T, cuda)
    beta = _vec(rng, T, cuda, 0.3)
    beta[3] = 0.0
    penf = torch.ones(T, device=cuda)
    penf[0] = 0.0
    mu = torch.tensor(2.0, device=cuda)
    params = ops.solve_params(mu, 1e-6, 0.3, 0.1, g)
    for dbeta in (torch.zeros_like(beta), _vec(rng, T, cuda, 0.05)):
        dbeta[3] = 0.0
        want = ref.cd_tile_solve(G, g, torch.diagonal(G).contiguous(), beta,
                                 dbeta, mu, 1e-6, 0.3, 0.1, penf=penf)
        for h in (torch.diagonal(G).contiguous(), torch.diagonal(G)):
            before = ops.launch_counts()["cd_tile_solve"]
            got = ops.cd_tile_solve(G, g, h, beta, dbeta, params, penf=penf)
            assert ops.launch_counts()["cd_tile_solve"] == before + 1
            assert torch.equal(got, want)
            assert float(got[3]) == 0.0
    # penf None is all ones
    got = ops.cd_tile_solve(G, g, torch.diagonal(G), beta, dbeta, params)
    want = ref.cd_tile_solve(G, g, torch.diagonal(G), beta, dbeta, mu, 1e-6,
                             0.3, 0.1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("nu", [0.0, 1e-6])
def test_cd_tile_solve_kernel_slow_division(cuda, nu):
    """Columns scaled by 2^31 and 2^-40 put their divisors outside the
    range of the chain's fast division: their panels run again with
    __fdiv_rn, and the step keeps the plain version's bits."""
    rng = np.random.default_rng(5)
    T, n = 96, 400
    X = rng.normal(size=(n, T)).astype(np.float32)
    X[:, 5] *= np.float32(2.0 ** 31)
    X[:, 40] *= np.float32(2.0 ** -40)
    w = rng.uniform(0.01, 0.25, n).astype(np.float32)
    G = torch.from_numpy((X.T * w) @ X).to(cuda)
    g = torch.from_numpy(X.T @ rng.normal(size=n).astype(np.float32)) \
        .to(cuda)
    beta = _vec(rng, T, cuda, 0.3)
    dbeta = torch.zeros_like(beta)
    params = ops.solve_params(1.0, nu, 0.0, 0.0, g)
    got = ops.cd_tile_solve(G, g, torch.diagonal(G), beta, dbeta, params)
    want = ref.cd_tile_solve(G, g, torch.diagonal(G), beta, dbeta, 1.0, nu,
                             0.0, 0.0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("T,live", [(256, [True] * 3 + [False] + [True] * 4),
                                    (100, [False, True, True]),
                                    (1024, [True, False])])
def test_cd_tile_solve_batched_launch(cuda, T, live):
    """The Jacobi sweep's solves in one K2 launch: each live tile equal to
    the plain chain from a zero step, dead tiles exactly 0."""
    rng = np.random.default_rng(T + len(live))
    nt = len(live)
    tiles = [_chain_tile(rng, T, cuda) for _ in range(nt)]
    G_all = torch.stack([t[0] for t in tiles])
    g_all = torch.stack([t[1] for t in tiles])
    beta = _vec(rng, nt * T, cuda, 0.3)
    penf = torch.rand(nt * T, device=cuda) + 0.5
    mu = torch.tensor(1.5, device=cuda)
    lam1 = 0.05 * float(g_all.abs().max())
    before = ops.launch_counts()["cd_tile_solve"]
    got = ops.jacobi_tile_solves(
        G_all, g_all, beta, ops.solve_params(mu, 1e-6, lam1, 0.01, g_all),
        penf=penf, tile_live=np.array(live))
    assert ops.launch_counts()["cd_tile_solve"] == before + 1
    want = ref.jacobi_tile_solves(G_all, g_all, beta, mu, 1e-6, lam1, 0.01,
                                  penf=penf, tile_live=np.array(live))
    assert torch.equal(got, want)
    for t in range(nt):
        if not live[t]:
            assert not got[t * T:(t + 1) * T].any()
    assert got.abs().max() > 0


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
    # K5's solve pass is K2's chain: on K5's own G and g, the plain chain
    # gives its bits
    chain = ref.jacobi_tile_solves(got[4], got[5], beta, penf=penf,
                                   tile_live=live, **kw)
    assert torch.equal(d, chain)


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


# (n, p, K, offset, weights): the fused fit's shape at a small n, rows of
# one 16-byte vector and rows over several 1,024-column copies (4 x 1,024
# + 8), one row and one block's worth less one, no offset, zero weights
# (all and every other row), one candidate and more than the lanes hold
# (320)
MARGIN_LS_CASES = {
    "fit": (70_001, 384, 294, True, "rand"),
    "p4": (5_000, 4, 294, True, "rand"),
    "p4104": (3_000, 4_104, 294, True, "rand"),
    "n1": (1, 384, 294, True, "rand"),
    "n1023": (1_023, 384, 294, True, "rand"),
    "no_offset": (20_000, 256, 294, False, "rand"),
    "zero_weights": (20_000, 256, 294, True, "zero"),
    "half_zero_weights": (20_000, 256, 294, True, "half"),
    "K1": (20_000, 256, 1, True, "rand"),
    "K400": (20_000, 256, 400, True, "rand"),
}


def _margin_ls_inputs(rng, n, p, K, offset, weights, family, dev):
    X = torch.from_numpy((0.1 * rng.normal(size=(n, p))).astype(np.float32)) \
        .to(dev)
    y = _labels(rng, family, n, dev)
    xb, dbeta = _vec(rng, n, dev), _vec(rng, p, dev, 0.3)
    off = _vec(rng, n, dev, 0.1) if offset else None
    wt = torch.rand(n, device=dev)
    if weights == "zero":
        wt.zero_()
    elif weights == "half":
        wt[::2] = 0.0
    if K == 294:
        cand = linesearch.full_candidates(1e-3, 13, 0.5, 20, device=dev)
    else:
        cand = torch.from_numpy(rng.uniform(0.0, 1.5, K).astype(np.float32)) \
            .to(dev)
    return X, dbeta, y, xb, wt, cand, off


@pytest.mark.parametrize("family", FAMS)
@pytest.mark.parametrize("case", list(MARGIN_LS_CASES))
def test_margin_ls_kernel(cuda, family, case):
    rng = np.random.default_rng(7)
    n, p, K, offset, weights = MARGIN_LS_CASES[case]
    X, dbeta, y, xb, wt, cand, off = _margin_ls_inputs(
        rng, n, p, K, offset, weights, family, cuda)
    assert cand.shape == (K,)
    xdb, losses = margin_ls.launch(X, dbeta, y, xb, wt, cand, family,
                                   offset=off)
    xdb2, losses2 = margin_ls.plain(X.view(n, 1, p).transpose(0, 1), y, xb,
                                    dbeta, wt, cand, family, offset=off)
    assert _rel(xdb, xdb2) <= 1e-5 and _rel(losses, losses2) <= 1e-5
    if weights == "zero":
        assert not losses.any()


@pytest.mark.parametrize("case", ["fit", "p4104", "K400"])
def test_margin_ls_kernel_is_deterministic(cuda, case):
    """Fixed row ranges and fixed-order sums: two runs give the same bits."""
    rng = np.random.default_rng(11)
    n, p, K, offset, weights = MARGIN_LS_CASES[case]
    X, dbeta, y, xb, wt, cand, off = _margin_ls_inputs(
        rng, n, p, K, offset, weights, "logistic", cuda)
    runs = [margin_ls.launch(X, dbeta, y, xb, wt, cand, "logistic",
                             offset=off) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


# (B, J, L): the serving shapes (one request, the batcher's largest bucket
# and a bulk-scoring chunk, over its three nnz buckets, 4 model columns)
# and a ragged case (J not a multiple of 4, L over one pass of 4 outputs)
PREDICT_TILE_SHAPES = [(3001, 45, 11)] + [
    (B, J, 4) for B in (1, 64, 4096) for J in (32, 64, 128)]


@pytest.mark.parametrize("family", FAMS)
@pytest.mark.parametrize("kind", ["link", "response"])
@pytest.mark.parametrize("B,J,L", PREDICT_TILE_SHAPES)
def test_predict_tile_kernel(cuda, family, kind, B, J, L):
    rng = np.random.default_rng(3)
    A = 1000
    table = np.zeros((A + 1, L), np.float32)
    table[:-1] = 0.2 * rng.normal(size=(A, L))
    slots_h = rng.integers(0, A + 1, size=(B, J)).astype(np.int32)
    # a malformed request: slots outside the table read the zero row
    bad = rng.random((B, J)) < 0.05
    slots_h[bad] = rng.choice([-7, A + 1, A + 50], size=int(bad.sum()))
    in_table = np.where(bad, A, slots_h).astype(np.int32)
    slots = torch.from_numpy(slots_h).to(cuda)
    vals, b0 = _vec(rng, B * J, cuda).reshape(B, J), _vec(rng, L, cuda)
    table = torch.from_numpy(table).to(cuda)
    got = ops.predict_tile(slots, vals, table, b0, family, kind=kind)
    want = ref.predict_tile(torch.from_numpy(in_table).to(cuda), vals, table,
                            b0, family, kind=kind)
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


# ------------------------------------------------- precision="bf16" modes
# K3, K5 and K6 with bf16 product inputs against their plain bf16 versions
# (the same roundings, summed in float64 or float32): 1e-5 relative to the
# largest entry, as in float32 (a product of two bf16 values is exact in
# float32); K5's G and g at the kernel's own stats, its step at 1e-4 of
# the largest step; G is not symmetric, and two runs give the same bits.


@pytest.mark.parametrize("family", FAMS)
@pytest.mark.parametrize("T,n,live", [
    (256, 20_003, [True, False, True]),
    (128, 33_333, [True, True]),
    (64, 4_097, [True, False, True, True]),
])
def test_stats_gram_solve_kernel_bf16(cuda, family, T, n, live):
    rng = np.random.default_rng(T + n)
    nt = len(live)
    X = (0.3 * rng.normal(size=(n, nt * T))).astype(np.float32)
    X[:, 0] = 1.0
    design, _ = tdesign.dense_design(X, T, device=cuda)
    y = _labels(rng, family, n, cuda)
    beta = _vec(rng, nt * T, cuda, 0.1)
    xb, off = design.matvec(beta), _vec(rng, n, cuda, 0.1)
    wt = torch.rand(n, device=cuda)
    penf = torch.rand(nt * T, device=cuda) + 0.5
    live = np.array(live)
    kw = dict(mu=torch.tensor(1.5, device=cuda), nu=1e-6, lam1=0.02,
              lam2=0.01)
    before = ops.launch_counts()
    got = ops.fused_stats_sweep(design, y, xb, beta, family, weights=wt,
                                offset=off, penf=penf, tile_live=live,
                                precision="bf16", **kw)
    after = ops.launch_counts()
    assert after["stats_gram_solve_bf16"] == \
        before["stats_gram_solve_bf16"] + 1
    assert after["stats_gram_solve"] == before["stats_gram_solve"]
    want = ref.stats_gram_solve(design.tiles3(), y, xb, wt, beta, family,
                                offset=off, penf=penf, tile_live=live,
                                precision="bf16", **kw)
    tol = 3e-4 if family == "probit" else 1e-5
    for a, b in zip(got[:3], want[:3]):
        assert _rel(a, b) <= tol
    # G and g against the plain bf16 Gram at the kernel's own w and s: an
    # s one ulp off the plain version's may round to another bf16 value
    G_own, g_own = ref.shaped_tile_grams(
        nt, lambda ids: ref.gram_dense_tiles(design.tiles3()[ids], got[2],
                                             got[1], "bf16"), live)
    assert _rel(got[4], G_own) <= 1e-5 and _rel(got[5], g_own) <= 1e-5
    for t in range(nt):
        if not live[t]:
            assert not got[4][t].any() and not got[5][t].any()
            assert not got[3][t * T:(t + 1) * T].any()
        else:
            assert not torch.equal(got[4][t], got[4][t].T)
    d, dw = got[3], want[5]
    assert float((d - dw).abs().max()) <= 1e-4 * max(
        float(dw.abs().max()), 1e-3)
    chain = ref.jacobi_tile_solves(got[4], got[5], beta, penf=penf,
                                   tile_live=live, **kw)
    assert torch.equal(d, chain)
    again = ops.fused_stats_sweep(design, y, xb, beta, family, weights=wt,
                                  offset=off, penf=penf, tile_live=live,
                                  precision="bf16", **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("T,rb,K,n_valid", [
    (256, 256, 40, 40), (256, 256, 300, 250), (64, 256, 9, 9),
    (128, 100, 40, 3), (512, 64, 30, 1), (256, 40, 6, 0),
])
def test_tile_gram_kernel_bf16(cuda, T, rb, K, n_valid):
    rng = np.random.default_rng(T + rb + K + n_valid)
    n_rb = 50
    b_np = rng.normal(size=(K, rb, T)).astype(np.float32)
    b_np[:, :, 0] = 1.0
    bricks = torch.from_numpy(b_np).to(cuda)
    rows = torch.from_numpy(rng.integers(0, n_rb, K).astype(np.int32)) \
        .to(cuda)
    w = torch.from_numpy(rng.uniform(1e-6, 0.25, n_rb * rb)
                         .astype(np.float32)).to(cuda)
    r = _vec(rng, n_rb * rb, cuda)
    before = ops.launch_counts()["tile_gram_bf16"]
    G, g = ops.tile_gram(bricks, rows, n_valid, w, r, precision="bf16")
    assert ops.launch_counts()["tile_gram_bf16"] == before + 1
    G2, g2 = ref.tile_gram(bricks, rows, n_valid, w.reshape(n_rb, rb),
                           r.reshape(n_rb, rb), precision="bf16")
    for a, b in ((G, G2), (g, g2)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * max(float(b.abs().max()), 1))
    if n_valid:
        assert not torch.equal(G, G.T)
    G3, g3 = ops.tile_gram(bricks, rows, n_valid, w, r, precision="bf16")
    assert torch.equal(G, G3) and torch.equal(g, g3)


# past 8,192 columns dbeta is read from global memory, not staged
MARGIN_LS_BF16_CASES = dict(MARGIN_LS_CASES,
                            p8704=(2_000, 8_704, 294, True, "rand"))


@pytest.mark.parametrize("family", FAMS)
@pytest.mark.parametrize("case", list(MARGIN_LS_BF16_CASES))
def test_margin_ls_kernel_bf16(cuda, family, case):
    rng = np.random.default_rng(7)
    n, p, K, offset, weights = MARGIN_LS_BF16_CASES[case]
    X, dbeta, y, xb, wt, cand, off = _margin_ls_inputs(
        rng, n, p, K, offset, weights, family, cuda)
    before = ops.launch_counts()["margin_ls_bf16"]
    xdb, losses = margin_ls.launch(X, dbeta, y, xb, wt, cand, family,
                                   offset=off, precision="bf16")
    assert ops.launch_counts()["margin_ls_bf16"] == before + 1
    xdb2, losses2 = margin_ls.plain(X.view(n, 1, p).transpose(0, 1), y, xb,
                                    dbeta, wt, cand, family, offset=off,
                                    precision="bf16")
    assert _rel(xdb, xdb2) <= 1e-5 and _rel(losses, losses2) <= 1e-5
    again = margin_ls.launch(X, dbeta, y, xb, wt, cand, family, offset=off,
                             precision="bf16")
    assert torch.equal(xdb, again[0]) and torch.equal(losses, again[1])


@pytest.mark.parametrize("sparse", [False, True])
def test_bf16_jacobi_fit_on_the_card_matches_the_cpu(cuda, sparse):
    if sparse:
        ds = synthetic.make_sparse(n=3000, p=600, avg_nnz=20, k_true=30,
                                   seed=1)
    else:
        ds = synthetic.make_dense(n=3000, p=300, k_true=20, seed=1)
    cfg = DGLMNETConfig(tile_size=128, coupling="jacobi", precision="bf16")
    fits = []
    for dev in ("cpu", cuda):
        s = GLMSolver(ds.train.X, ds.train.y, config=cfg, device=dev,
                      fit_intercept=True, row_block=256)
        ops.reset_launch_counts()
        res = s.fit(lam1=0.05 * s.lambda_max(), max_outer=6, tol=0.0)
        fits.append((res, ops.launch_counts()))
    (rc, cc), (rg, cg) = fits
    assert sum(cc.values()) == 0
    for k in ("stats_gram_solve", "margin_ls", "tile_gram"):
        assert cg[k] == 0
    assert (cg["stats_gram_solve_bf16"] > 0) == (not sparse)
    assert (cg["margin_ls_bf16"] > 0) == (not sparse)
    assert (cg["tile_gram_bf16"] > 0) == sparse
    np.testing.assert_allclose(rg.history["f"], rc.history["f"], rtol=1e-4)
    np.testing.assert_allclose(rg.beta, rc.beta, atol=1e-3)


@pytest.mark.parametrize("sparse,coupling", [(True, "gauss-seidel"),
                                             (False, "gauss-seidel"),
                                             (True, "jacobi"),
                                             (False, "jacobi")])
def test_screened_path_on_the_card_matches_the_cpu(cuda, sparse, coupling):
    """A screened fit_path on the card against the same path on the CPU,
    with the bar of chip_smoke.py's path_reference phase: per lambda f
    within 1e-4 relative, beta within 1e-3, nnz equal; the card's sweeps
    skip the screened tiles and launch the tile kernels for the live ones
    only.  ``tol=1e-4`` stops each lambda before its sums reach float32
    resolution, so both devices take the same steps."""
    if sparse:
        ds = synthetic.make_sparse(n=3000, p=700, avg_nnz=20, k_true=30,
                                   seed=1)
    else:
        ds = synthetic.make_dense(n=3000, p=300, k_true=20, seed=1)
    cfg = DGLMNETConfig(tile_size=256, coupling=coupling)
    paths = []
    for dev in ("cpu", cuda):
        s = GLMSolver(ds.train.X, ds.train.y, config=cfg, device=dev,
                      fit_intercept=True)
        grid = dict(lambdas=paths[0][0].lambdas) if paths else \
            dict(n_lambdas=6, lam_ratio=0.05)
        ops.reset_launch_counts()
        path = s.fit_path(**grid, max_outer=30, tol=1e-4)
        paths.append((path, ops.launch_counts(), dict(s.launch_stats)))
    (pc, cc, _), (pg, cg, st) = paths
    assert sum(cc.values()) == 0
    np.testing.assert_allclose(pg.f, pc.f, rtol=1e-4)
    np.testing.assert_allclose(pg.betas, pc.betas, atol=1e-3)
    np.testing.assert_array_equal(pg.nnz, pc.nnz)
    if coupling == "gauss-seidel":
        assert st["sweep_tiles_skipped"] > 0
        assert cg["cd_tile_solve"] == st["sweep_tile_launches"]
        if sparse:
            assert cg["tile_gram"] == st["sweep_tile_launches"]
    elif not sparse:
        assert cg["stats_gram_solve"] == cg["margin_ls"] == st["supersteps"]


@pytest.mark.parametrize("coupling", ["gauss-seidel", "jacobi"])
def test_registered_family_takes_the_plain_route(cuda, coupling,
                                                 monkeypatch):
    """A family without a kernel body runs the plain versions on the card,
    counted apart, and fits like its built-in twin; the built-in family
    never takes that route."""
    from repro_torch.core import glm as tglm
    custom = tglm.GLMFamily("custom_squared", tglm.SQUARED.raw_stats,
                            lambda m: m, 1.0)
    monkeypatch.setitem(tglm.FAMILIES, custom.name, custom)
    ds = synthetic.make_dense(n=2000, p=200, k_true=20, seed=3)
    cfg = DGLMNETConfig(tile_size=128, coupling=coupling)
    fits = {}
    for fam in ("squared", custom.name):
        s = GLMSolver(ds.train.X, ds.train.y, family=fam, config=cfg,
                      device=cuda, fit_intercept=True)
        ops.reset_launch_counts()
        res = s.fit(lam1=5.0, max_outer=6, tol=0.0)
        fits[fam] = (res, ops.launch_counts())
    (rs, cs), (rc, cc) = fits["squared"], fits[custom.name]
    assert sum(v for k, v in cs.items() if k.endswith("/plain")) == 0
    steps = rc.n_iter
    if coupling == "jacobi":
        assert cs["stats_gram_solve"] == steps and cc["stats_gram_solve"] == 0
        assert cc["stats_gram_solve/plain"] == cc["margin_ls/plain"] == steps
    else:
        assert cs["glm_stats"] == steps and cc["glm_stats"] == 0
        assert cc["glm_stats/plain"] == steps
        assert cc["alpha_search/plain"] == 2 * steps
        assert cc["cd_tile_solve"] == cs["cd_tile_solve"] > 0
    assert rc.n_iter == rs.n_iter
    np.testing.assert_allclose(rc.history["f"], rs.history["f"], rtol=1e-4)
    np.testing.assert_allclose(rc.beta, rs.beta, atol=1e-3)


# ---------------------------------------------------------------- streaming


def test_streaming_double_buffer_gives_the_serial_bits(cuda):
    """Two pinned staging buffers and a side copy stream give the chunks of
    the serial pageable copy bit for bit (a staging buffer rewritten under
    its copy would not), centered and scaled on the card, ragged last
    chunk included; chunks held by the caller stay valid."""
    rng = np.random.default_rng(9)
    X = rng.normal(size=(1000, 70)).astype(np.float32)
    sd, _ = tdesign.streaming_design(X, 32, chunk_rows=96, device=cuda)
    sd = sd.with_ones_column().scale_columns(
        rng.uniform(0.5, 2.0, 96).astype(np.float32),
        rng.normal(size=96).astype(np.float32))
    held = [c for _, c in sd.iter_chunks()]
    serial = [c for _, c in sd.iter_chunks(prefetch=False)]
    cpu = tdesign.StreamingDesign(
        sd._chunk_fn, n_rows=1000, n_cols=70, chunk_rows=96, tile_size=32,
        add_ones=True, scale=sd._scale, center=sd._center, device="cpu")
    assert len(held) == sd.n_chunks == 11
    for a, b, (_, c) in zip(held, serial, cpu.iter_chunks()):
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), c)


@pytest.mark.parametrize("coupling", ["gauss-seidel", "jacobi"])
def test_streaming_fit_card_vs_cpu(cuda, coupling):
    """A streaming fit on the card against the same fit on the CPU; K1 and
    K4 once a chunk, K2 once a swept tile (Gauss-Seidel) or once a
    superstep (Jacobi)."""
    ds = synthetic.make_dense(n=3000, p=300, k_true=20, seed=4)
    cfg = DGLMNETConfig(tile_size=128, coupling=coupling)
    res, counts = {}, None
    for dev in ("cpu", cuda):
        sd, _ = tdesign.streaming_design(ds.train.X, 128, chunk_rows=512,
                                         device=dev)
        s = GLMSolver(sd, ds.train.y, config=cfg, fit_intercept=True,
                      device=dev)
        ops.reset_launch_counts()
        res[str(dev)] = s.fit(lam1=5.0, max_outer=5, tol=0.0)
        counts = ops.launch_counts()
    r_cpu, r_gpu = res["cpu"], res[str(cuda)]
    chunks = sd.n_chunks
    steps = r_gpu.n_iter
    assert counts["glm_stats"] == counts["alpha_search"] == chunks * steps
    assert counts["cd_tile_solve"] == steps * (
        sd.n_tiles if coupling == "gauss-seidel" else 1)
    assert sum(v for k, v in counts.items() if k.endswith("/plain")) == 0
    np.testing.assert_allclose(r_gpu.history["f"], r_cpu.history["f"],
                               rtol=1e-4)
    np.testing.assert_allclose(r_gpu.beta, r_cpu.beta, atol=1e-3)


def test_streaming_resume_on_the_card(cuda, tmp_path):
    """A chunk-cursor checkpoint written on the card resumes there to the
    uninterrupted fit's bits."""
    from repro_torch.checkpoint import CheckpointManager

    ds = synthetic.make_dense(n=2000, p=100, k_true=10, seed=5)
    cfg = DGLMNETConfig(tile_size=64, max_outer=6, tol=0.0)

    def fit(mgr=None):
        sd, _ = tdesign.streaming_design(ds.train.X, 64, chunk_rows=256,
                                         device=cuda)
        return GLMSolver(sd, ds.train.y, config=cfg, device=cuda).fit(
            lam1=2.0, ckpt_manager=mgr, ckpt_every_chunks=3)

    full, again = fit(), fit()
    mgr = CheckpointManager(tmp_path)
    orig = mgr.save

    def save(step, tree, **kw):
        orig(step, tree, **kw)
        if (kw["metadata"].get("stream_chunk"), step) == (6, 4):
            raise KeyboardInterrupt

    mgr.save = save
    with pytest.raises(KeyboardInterrupt):
        fit(mgr)
    res = fit(CheckpointManager(tmp_path))
    if np.array_equal(full.beta, again.beta):
        np.testing.assert_array_equal(res.beta, full.beta)
    np.testing.assert_allclose(res.beta, full.beta, atol=1e-6)
    assert res.history["alpha"] == full.history["alpha"][3:]


# --------------------------------------------------------- observability

K1_K4 = {"glm_stats": "glm_stats_", "tile_gram": "tile_gram_",
         "cd_tile_solve": "cd_tile_solve_", "alpha_search": "alpha_search_"}


def _traced_sparse_solver(cuda):
    ds = synthetic.make_sparse(n=3000, p=700, avg_nnz=20, k_true=30, seed=1)
    return GLMSolver(ds.train.X, ds.train.y, family="logistic",
                     config=DGLMNETConfig(tile_size=256), fit_intercept=True,
                     device=cuda)


def test_traced_fit_equals_untraced_on_the_card(cuda, tmp_path):
    """Spans, record_function and NVTX ranges and the convergence stream
    change nothing on the card: beta, f, alpha, n_iter and the launch
    counts are the same bits."""
    from repro_torch.obs import convergence, trace

    s = _traced_sparse_solver(cuda)
    lam1 = 0.05 * s.lambda_max()
    runs = []
    for traced in (False, True):
        if traced:
            trace.enable(tmp_path)
            s.set_convergence_stream(tmp_path / "c.jsonl")
        try:
            ops.reset_launch_counts()
            r = s.fit(lam1=lam1, max_outer=4, tol=0.0)
            runs.append((r, ops.launch_counts()))
        finally:
            trace.disable()
    s._conv.close()
    (a, ca), (b, cb) = runs
    assert np.array_equal(a.beta, b.beta) and a.n_iter == b.n_iter == 4
    assert a.history["f"] == b.history["f"]
    assert a.history["alpha"] == b.history["alpha"]
    assert ca == cb
    evs = convergence.read_events(tmp_path / "c.jsonl")
    assert [e["f"] for e in evs] == b.history["f"]
    assert all(e["step_us"] > 0 for e in evs)


def test_spans_are_profiler_and_nvtx_ranges_on_the_card(cuda, monkeypatch):
    """A traced small fit under torch.profiler: one ``solver/superstep``
    range a superstep, each K1-K4 record launched from the host inside
    one, and an NVTX push and pop a span on the span's thread."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace

    pushes = []
    push, pop = torch.cuda.nvtx.range_push, torch.cuda.nvtx.range_pop
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: (
        pushes.append(("push", name)), push(name))[1])
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: (
        pushes.append(("pop", None)), pop())[1])
    s = _traced_sparse_solver(cuda)
    lam1 = 0.05 * s.lambda_max()
    s.fit(lam1=lam1, max_outer=1)
    torch.cuda.synchronize()
    tr = trace.enable()
    try:
        assert tr._nvtx is torch.cuda.nvtx
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.1)
            res = s.fit(lam1=lam1, max_outer=3, tol=0.0)
            torch.cuda.synchronize()
            time.sleep(0.1)
    finally:
        trace.disable()
    assert pushes == [("push", "solver/superstep"), ("pop", None)] * 3
    evs = prof.events()
    ranges = [(e.time_range.start, e.time_range.end) for e in evs
              if e.name == "solver/superstep"
              and e.device_type == DeviceType.CPU]
    assert len(ranges) == res.n_iter == 3
    launch_at = {e.id: e.time_range.start for e in evs
                 if e.device_type == DeviceType.CPU and "aunch" in e.name}
    seen = {k: 0 for k in K1_K4}
    for e in evs:
        if e.device_type != DeviceType.CUDA:
            continue
        for k, pre in K1_K4.items():
            if e.name.startswith(pre) or f" {pre}" in e.name or \
                    f"::{pre}" in e.name:
                seen[k] += 1
                t = launch_at[e.id]
                assert any(a <= t <= b for a, b in ranges), (k, t, ranges)
    assert all(seen.values()), seen


def _dist_demo(tmp_path, tag, n, *extra):
    """``dist_run``'s demo fit as an ``n``-process world; its record."""
    from repro_torch.dist import launcher
    out = tmp_path / f"{tag}.json"
    res = launcher.run_local(
        n, "repro_torch.launch.dist_run",
        args=["--demo", "--steps", "6", "--out", str(out), *extra],
        timeout_s=300)
    assert res.ok, res.summary()
    import json
    return json.loads(out.read_text())


def test_dist_nccl_world_of_one_matches_the_cpu(cuda, tmp_path):
    """A (1, 1) mesh over NCCL on the card against the same world over
    gloo on the CPU: the same alphas and supersteps, f within 1e-5."""
    gpu = _dist_demo(tmp_path, "nccl", 1)
    cpu = _dist_demo(tmp_path, "cpu", 1, "--backend", "gloo",
                     "--device", "cpu")
    assert gpu["backend"] == "cpu:gloo,cuda:nccl"
    assert gpu["alpha"] == cpu["alpha"] and gpu["n_iter"] == cpu["n_iter"]
    assert abs(gpu["f"] - cpu["f"]) <= 1e-5 * abs(cpu["f"])


def test_dist_two_gloo_ranks_share_one_card(cuda, tmp_path):
    """Two ranks on one card over gloo (NCCL would refuse them) against
    the same world on the CPU."""
    gpu = _dist_demo(tmp_path, "gloo2", 2, "--backend", "gloo")
    cpu = _dist_demo(tmp_path, "cpu2", 2, "--backend", "gloo",
                     "--device", "cpu")
    assert gpu["device"] == "cuda" and gpu["mesh"] == [1, 2]
    assert gpu["alpha"] == cpu["alpha"] and gpu["n_iter"] == cpu["n_iter"]
    assert abs(gpu["f"] - cpu["f"]) <= 1e-5 * abs(cpu["f"])


def test_sharded_trainer_world_of_one_is_the_single_device_run(cuda,
                                                               tmp_path):
    """``launch.train --devices 1``: ``Trainer(mesh=)`` on a world of one
    over NCCL (mesh (1, 1)) against the trainer without a mesh on the
    card: the same losses, grad norms and final checkpoint, bit for
    bit."""
    from repro_torch.launch import train
    args = ["--arch", "phi4-mini-3.8b", "--smoke", "--steps", "3",
            "--batch", "2", "--seq-len", "16", "--ckpt-every", "3"]
    assert train.main(args + ["--ckpt-dir", str(tmp_path / "one")]) == 0
    assert train.main(args + ["--devices", "1", "--ckpt-dir",
                              str(tmp_path / "mesh")]) == 0
    logs = [[(r["loss"], r["grad_norm"], r["lr"]) for r in map(
        json.loads, (tmp_path / d / "train.jsonl").read_text()
        .splitlines())] for d in ("one", "mesh")]
    assert logs[0] == logs[1] and len(logs[0]) == 3
    z = [np.load(tmp_path / d / "ckpt_3" / "shard_0.npz")
         for d in ("one", "mesh")]
    assert sorted(z[0].files) == sorted(z[1].files)
    for k in z[0].files:
        np.testing.assert_array_equal(z[0][k], z[1][k])


# --- the two scans of the competing algorithms -----------------------------
# Tolerances: each kernel step's dot is a float32 sum over the rows (ADMM)
# or features (online) in another order than the plain version's, and the
# scan carries the difference on: 1e-4 of the largest weight for the ADMM
# x-update (dots over up to 10^6 rows), 1e-5 for the online epoch.


def _admm_inputs(rng, M, n, pb, dev):
    A = rng.normal(size=(M, pb, n)).astype(np.float32)
    A[0, pb // 2] = 0.0                         # a dead column
    x0 = (0.2 * rng.normal(size=(M, pb))).astype(np.float32)
    v = rng.normal(size=(M, n)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)
    At = t(A)
    return At, t(x0), t(v), (At * At).sum(2)


@pytest.mark.parametrize("M,n,pb,passes,lam1,lam2", [
    (3, 2_999, 13, 3, 40.0, 0.0),       # one CTA a block
    (2, 5_001, 37, 1, 20.0, 5.0),       # clusters of 4
    (1, 17_001, 9, 2, 60.0, 1.0),       # 16 where the card schedules them
    (2, 1_000_003, 3, 1, 500.0, 0.0),   # r past shared memory: global
    (4, 4_096, 5, 0, 1.0, 0.0)])        # no pass: x as it came
def test_admm_shooting_kernel(cuda, M, n, pb, passes, lam1, lam2):
    from repro_torch.kernels import admm_shooting
    rng = np.random.default_rng(n)
    At, x0, v, csq = _admm_inputs(rng, M, n, pb, cuda)
    before = ops.launch_counts()["admm_shooting"]
    got = ops.admm_shooting(At, x0, v, csq, lam1, lam2, passes)
    torch.cuda.synchronize()
    assert ops.launch_counts()["admm_shooting"] == before + 1
    want = ref.shooting_pass(At, x0, v, csq, lam1, lam2, passes)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * max(
        1.0, float(want.abs().max())))
    if passes:
        assert float(got[0, pb // 2]) == 0.0
    cluster, in_smem = admm_shooting.plan(n)
    assert cluster in (1, 2, 4, 8, 16) and n >= cluster * 1024 or \
        cluster == 1
    assert in_smem == (-(-n // cluster) * 4 <= 220 * 1024)
    # fixed-order sums: the same bits again
    assert torch.equal(got, ops.admm_shooting(At, x0, v, csq, lam1, lam2,
                                              passes))


@pytest.mark.parametrize("family", FAMS)
@pytest.mark.parametrize("M,n_per,p", [(4, 301, 45), (3, 57, 2_000),
                                       (2, 20, None)])
def test_online_tg_kernel(cuda, family, M, n_per, p):
    """Small odd shapes, the paper's p, and p past the shared-memory limit
    of the kernel's weights (None: that limit + 13)."""
    from repro_torch.kernels import online_tg
    if p is None:
        p = online_tg.smem_features() + 13
    rng = np.random.default_rng(n_per)
    X = torch.from_numpy((rng.normal(size=(M, n_per, p)) / np.sqrt(p))
                         .astype(np.float32)).to(cuda)
    yv = (rng.poisson(1.5, M * n_per) if family == "poisson"
          else rng.choice([-1.0, 1.0], M * n_per)).astype(np.float32)
    y = torch.from_numpy(yv.reshape(M, n_per)).to(cuda)
    w0 = _vec(rng, p, cuda, 0.05)
    t0 = np.float32(1 + 7 * n_per)
    kw = dict(lr=0.3, power=0.6, lam1=1e-3, lam2=0.05)
    before = ops.launch_counts()["online_tg"]
    got = ops.online_tg_epoch(X, y, w0, t0, family, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["online_tg"] == before + 1
    want = ref.online_tg_epoch(X, y, w0, t0, family, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * max(
        1.0, float(want.abs().max())))
    assert torch.equal(got, ops.online_tg_epoch(X, y, w0, t0, family, **kw))


def _baseline_data():
    ds = synthetic.make_dense(n=500, p=61, seed=21)
    return ds.train.X, ds.train.y


def _baseline_fits(device):
    from repro_torch.baselines import (fit_admm, fit_lbfgs,
                                       fit_online_tg,
                                       fit_online_warmstart_lbfgs)
    from repro_torch.baselines.admm import ADMMConfig
    from repro_torch.baselines.lbfgs import LBFGSConfig
    from repro_torch.baselines.online_tg import OnlineTGConfig
    from repro_torch.core import prox_ref
    X, y = _baseline_data()
    oc = OnlineTGConfig(lam1=0.2, lam2=0.1, epochs=5, lr=0.3)
    return {
        "admm": lambda: fit_admm(X, y, ADMMConfig(lam1=0.5, lam2=0.1,
                                                  max_outer=10),
                                 device=device),
        "online_tg": lambda: fit_online_tg(X, y, oc, device=device),
        "lbfgs": lambda: fit_lbfgs(X, y, LBFGSConfig(lam2=0.8, max_iter=12),
                                   device=device),
        "warmstart": lambda: fit_online_warmstart_lbfgs(
            X, y, LBFGSConfig(lam2=0.5, max_iter=5),
            OnlineTGConfig(lam1=0.0, lam2=0.5, epochs=3, lr=0.3),
            device=device),
        "fista": lambda: prox_ref.fit_fista(X, y, lam1=0.7, lam2=0.4,
                                            max_iter=20, tol=0.0,
                                            device=device)}


@pytest.mark.parametrize("name", ["admm", "online_tg", "lbfgs", "warmstart",
                                  "fista"])
def test_baseline_fit_card_vs_cpu(cuda, name):
    """Each fit_* on the card against the same call on the CPU: beta
    within 1e-4, each f within 1e-5 relative, the same iteration count."""
    b_g, h_g = _baseline_fits(cuda)[name]()
    b_c, h_c = _baseline_fits("cpu")[name]()
    f_g = h_g["f"] if isinstance(h_g, dict) else h_g
    f_c = h_c["f"] if isinstance(h_c, dict) else h_c
    assert len(f_g) == len(f_c)
    np.testing.assert_allclose(f_g, f_c, rtol=1e-5, atol=0)
    np.testing.assert_allclose(b_g, b_c, rtol=0, atol=1e-4)


def test_baselines_launch_the_kernels(cuda):
    """On the card the scans run their kernels, never the plain route:
    ADMM one admm_shooting launch an outer iteration and K1 newton_iters
    + 1; online TG one online_tg launch an epoch and K1 one."""
    from repro_torch.baselines import fit_admm, fit_online_tg
    from repro_torch.baselines.admm import ADMMConfig
    from repro_torch.baselines.online_tg import OnlineTGConfig
    X, y = _baseline_data()
    ops.reset_launch_counts()
    fit_admm(X, y, ADMMConfig(lam1=0.5, max_outer=3), device=cuda)
    c = ops.launch_counts()
    assert c["admm_shooting"] == 3 and c["glm_stats"] == 3 * 13
    ops.reset_launch_counts()
    fit_online_tg(X, y, OnlineTGConfig(epochs=4), device=cuda)
    c = ops.launch_counts()
    assert c["online_tg"] == 4 and c["glm_stats"] == 5
    assert c["glm_stats/plain"] == 0 and "online_tg/plain" not in c


def test_online_tg_registered_family_raises_on_the_card(cuda, monkeypatch):
    """A registered family with no body in the online kernel raises on the
    card (its plain version is a loop over rows) and runs on the CPU."""
    from repro_torch.baselines import fit_online_tg
    from repro_torch.baselines.online_tg import OnlineTGConfig
    from repro_torch.core import glm as tglm
    custom = tglm.GLMFamily("custom_squared", tglm.SQUARED.raw_stats,
                            lambda m: m, 1.0)
    monkeypatch.setitem(tglm.FAMILIES, custom.name, custom)
    X, y = _baseline_data()
    cfg = OnlineTGConfig(epochs=2, family=custom.name)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="no CUDA body"):
        fit_online_tg(X, y, cfg, device=cuda)
    assert ops.launch_counts()["online_tg"] == 0
    _, h = fit_online_tg(X, y, cfg, device="cpu")
    assert len(h["f"]) == 3 and np.isfinite(h["f"]).all()


# ------------------------------------------------- repro_torch.analysis


def test_audits_pass_on_the_card(cuda):
    """Every audit on the card: launch units, the kernels' launches and
    the profiler's records; kernel_smem runs (no skip) and every kernel is
    within the card's limits and agrees with ptxas; the collective
    sequence, the scoring entry points and zero steady-state rebuilds."""
    from repro_torch.analysis import audit
    res = {r.name: r for r in audit.run_audit()}
    assert audit.passed(list(res.values())), {
        k: (r.status, r.details) for k, r in res.items() if r.status != "ok"}
    assert all(r.status == "ok" for r in res.values())
    for name in ("launches_fused", "launches_unfused"):
        d = res[name].details
        assert d["records_off"] == {} and d["kernel_launches"] == \
            d["kernel_target"]
    k = res["kernel_smem"].details
    assert k["over_budget"] == k["regs_over"] == k["ptxas_mismatch"] == []
    assert k["n_kernels"] == sum(
        len(v) for v in ops.kernel_resources().values())


def test_lint_and_audit_cli_on_the_card(cuda, tmp_path):
    from repro_torch.analysis import lint
    out = tmp_path / "s.json"
    assert lint.main(["--check", "--audit", "--json", str(out)]) == 0
    s = json.loads(out.read_text())
    assert {v["status"] for v in s["audit"].values()} == {"ok"}


def test_kernel_resources_record_the_launches(cuda):
    """The running maxima of a source's resources entry: a launch of K1
    shows its block size and no dynamic shared memory; K6's stream kernel
    its dynamic shared bytes, within the card's opt-in limit."""
    from repro_torch.roofline import hlo
    rng = np.random.default_rng(0)
    n, p = 4096, 256
    X = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.choice([-1.0, 1.0], n)
                         .astype(np.float32)).to(cuda)
    xb = torch.zeros(n, device=cuda)
    ops.glm_stats(y, xb, "logistic")
    ops.fused_ls(tdesign.DenseDesign(X, 256), y, xb,
                 torch.full((p,), 1e-3, device=cuda),
                 linesearch.full_candidates(1e-3, 13, 0.5, 20, cuda),
                 "logistic")
    torch.cuda.synchronize()
    res = ops.kernel_resources()
    k1 = {r["name"]: r for r in res["glm_stats"]}["glm_stats_kernel<0>"]
    assert k1["launches"] >= 1 and k1["requested_threads"] == 256
    assert k1["requested_dynamic_smem"] == 0
    k6 = {r["name"]: r for r in res["margin_ls"]}["margin_ls_stream<0,false>"]
    assert 0 < k6["requested_dynamic_smem"] + k6["static_smem"] \
        <= hlo.shared_memory_budget(cuda)


def test_lm_smoke_and_head_probe_on_the_card(cuda):
    """The gemma3 smoke model on the card against the same weights on the
    CPU, then the head probe on its pooled features: K1, K2 and K4
    launched, and the fit held against the same fit on the CPU (the same
    alphas and n_iter, beta within 1e-5) at 8 supersteps, under the
    float32 plateau.  One layer's hidden states and logits are held to
    5e-4 of the largest (the bar of tests/test_torch_models.py); through
    six layers the reference's init (attention logits with a std of tens)
    amplifies the two devices' roundings as it does two packages', so the
    six-layer features are held to be finite, and the probe fits on the
    very same features."""
    from repro_torch.configs.registry import smoke_variant
    from repro_torch.core import head_probe
    from repro_torch.models import lm

    def on_both(cfg):
        cpu = lm.build_model(cfg, generator=torch.Generator().manual_seed(0))
        return cpu, lm.build_model(cfg, state={
            k: v.to(cuda) for k, v in cpu.state_dict().items()})

    rng = np.random.default_rng(0)
    labels = rng.choice([-1.0, 1.0], 256).astype(np.float32)
    tok = torch.from_numpy(np.where(
        labels[:, None] > 0, rng.integers(0, 128, (256, 32)),
        rng.integers(128, 256, (256, 32))))
    cfg = smoke_variant("gemma3-12b")
    cpu1, gpu1 = on_both(cfg.replace(n_layers=1))
    for hidden in (True, False):
        want = cpu1(tok, return_hidden=hidden)[0]
        got = gpu1(tok.to(cuda), return_hidden=hidden)[0]
        assert float((got.cpu() - want).abs().max()) <= \
            5e-4 * float(want.abs().max())
    _, gpu = on_both(cfg)
    feats = head_probe.extract_features(
        lambda m, t: m(t, return_hidden=True)[0], gpu,
        [tok[i:i + 64].to(cuda) for i in range(0, 256, 64)])
    assert feats.is_cuda and feats.shape == (256, 64)
    assert bool(torch.isfinite(feats).all())
    cfg_glm = DGLMNETConfig(lam1=0.05, lam2=0.05, tile_size=16, max_outer=8,
                            tol=0.0)
    ops.reset_launch_counts()
    r_gpu = head_probe.fit_probe(feats, labels, cfg_glm)
    counts = ops.launch_counts()
    r_cpu = head_probe.fit_probe(feats.cpu(), labels, cfg_glm, device="cpu")
    for k in ("glm_stats", "cd_tile_solve", "alpha_search"):
        assert counts[k] > 0, counts
    assert r_gpu.n_iter == r_cpu.n_iter == 8
    assert r_gpu.history["alpha"] == r_cpu.history["alpha"]
    np.testing.assert_allclose(r_gpu.beta, r_cpu.beta, rtol=0, atol=1e-5)
    p = head_probe.predict_proba(feats, r_gpu.beta)
    assert p.is_cuda and bool(torch.isfinite(p).all())


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "mixtral-8x7b",
                                  "zamba2-1.2b", "xlstm-1.3b",
                                  "llama-3.2-vision-11b", "whisper-tiny"])
def test_lm_family_smoke_forward_on_the_card(cuda, name):
    """Each family's smoke model on the card against the same weights and
    inputs on the CPU (the modality stubs too), logits and hidden states
    within 5e-4 of the largest (the bar of tests/test_torch_families.py),
    then prefill and three decode steps on the card against its own
    forward at the reference's ``_DECODE_TOL``, with capacity for every
    MoE token."""
    from repro_torch.configs.registry import smoke_variant
    from repro_torch.launch import serve
    from repro_torch.models import lm, moe

    cfg = smoke_variant(name)
    cpu = lm.build_model(cfg, generator=torch.Generator().manual_seed(0))
    gpu = lm.build_model(cfg, state={k: v.to(cuda) for k, v in
                                     cpu.state_dict().items()})
    tok = torch.randint(0, cfg.vocab_size, (2, 24),
                        generator=torch.Generator().manual_seed(1))
    extra = serve.modality_inputs(cfg, 2, torch.Generator().manual_seed(2))
    extra_gpu = {k: v.to(cuda) for k, v in extra.items()}
    for hidden in (True, False):
        want = cpu(tok, return_hidden=hidden, **extra)[0]
        got = gpu(tok.to(cuda), return_hidden=hidden, **extra_gpu)[0]
        assert got.is_cuda
        assert float((got.cpu() - want).abs().max()) <= \
            5e-4 * float(want.abs().max())
    old = moe.CAPACITY_FACTOR
    moe.CAPACITY_FACTOR = 16.0
    try:
        full = gpu(tok.to(cuda), **extra_gpu)[0]
        caches = lm.init_cache(cfg, 2, 24)
        prefill = lm.make_prefill_step(gpu)
        decode = lm.make_decode_step(gpu)
        _, caches = prefill(caches, {"tokens": tok[:, :21].to(cuda),
                                     **extra_gpu})
        errs = []
        for i in range(21, 24):
            logits, caches = decode(caches, tok[:, i:i + 1].to(cuda), i,
                                    extra_gpu)
            errs.append(float((logits - full[:, i]).abs().max()))
    finally:
        moe.CAPACITY_FACTOR = old
    tol = {"xlstm-1.3b": 2e-2, "zamba2-1.2b": 5e-3}.get(name, 1e-3)
    assert max(errs) < tol, errs


@pytest.mark.parametrize("kw", [dict(), dict(window=40, softcap=30.0),
                                dict(H=4, Hkv=4, hd_v=24)])
def test_flash_backward_on_the_card(cuda, kw):
    """``FlashAttention``'s forward and dq, dk, dv on the card against the
    same inputs on the CPU, within 1e-5 of the largest entry (float32 sums
    in another order): GQA, a window with a softcap, hd_v != hd."""
    from repro_torch.models import common

    H, Hkv, hd_v = kw.pop("H", 6), kw.pop("Hkv", 2), kw.pop("hd_v", 32)
    rng = np.random.default_rng(0)
    shapes = ((2, 100, H, 32), (2, 100, Hkv, 32), (2, 100, Hkv, hd_v))
    host = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in shapes]
    dout = torch.from_numpy(rng.normal(size=(2, 100, H, hd_v))
                            .astype(np.float32))
    outs = []
    for dev in ("cpu", cuda):
        qkv = [t.to(dev).requires_grad_() for t in host]
        o = common.chunked_attention(*qkv, chunk=32, **kw)
        outs.append([o.detach()]
                    + list(torch.autograd.grad(o, qkv, dout.to(dev))))
    for want, got in zip(*outs):
        assert got.is_cuda
        assert float((got.detach().cpu() - want).abs().max()) <= \
            1e-5 * float(want.abs().max())


@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "deepseek-v2-lite-16b"])
def test_train_step_on_the_card(cuda, name):
    """One ``make_train_step`` step of a smoke model on the card against
    the same weights and batch on the CPU: loss 1e-5 relative, grad norm
    1e-4, gradients 1e-4 of each leaf's largest entry, every parameter on
    the card and moved (tests/test_torch_train_archs.py's bars)."""
    from repro_torch.configs.registry import smoke_variant
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cfg = smoke_variant(name)
    ref = lm.build_model(cfg, generator=torch.Generator().manual_seed(0))
    state = {k: v.mul(0.02 / max(float(v.std()), 1e-12))
             if v.dim() >= 2 else v.clone() for k, v in
             ref.state_dict().items()}
    batch = TokenPipeline(cfg.vocab_size, 2, 24).batch_at(0)
    out = []
    for dev in ("cpu", cuda):
        model = lm.build_model(cfg, state={k: v.to(dev, copy=True)
                                           for k, v in state.items()})
        params = lm.trainable_params(model)
        step = lm.make_train_step(model, adamw.AdamWConfig(lr=1e-3))
        _, grads = lm.loss_and_grads(model, params,
                                     lm.batch_to_device(batch, dev))
        _, m = step(adamw.adamw_init(params), batch)
        assert all(p.device.type == torch.device(dev).type
                   for p in params.values())
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: g.cpu() for k, g in grads.items()},
                    {k: p.detach().cpu() for k, p in params.items()}))
    (lc, gc, gradc, pc), (lg, gg, gradg, pg) = out
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert abs(gg - gc) <= 1e-4 * gc
    for k, want in gradc.items():
        assert float((gradg[k] - want).abs().max()) <= \
            1e-4 * max(float(want.abs().max()), 1e-30), k
    assert all(not torch.equal(pg[k], state[k]) for k in pg)


# ---------------------------------------------------------------------------
# the recurrences' scans (ssm_scan, mlstm_scan, slstm_scan): each kernel
# against its plain version on the card, within 1e-5 of the largest
# |value| (float32, the sums in another order) where both are finite, the
# non-finite positions equal; the final state also written into a cache's
# leaves in place
# ---------------------------------------------------------------------------

def _scan_rel(got, want) -> float:
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    if not bool(fin.any()):
        return 0.0
    return float((got - want).abs()[fin].max()
                 / want.abs()[fin].max().clamp_min(1e-30))


def _scan_close(got, want, tol=1e-5):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert _scan_rel(g, w) <= tol


def _randn(rng, shape, dev, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.normal(size=shape) * scale + shift)
                            .astype(np.float32)).to(dev)


@pytest.mark.parametrize("B,S,H,hd,ds,warm", [
    (2, 37, 3, 64, 64, True), (2, 37, 3, 64, 64, False),
    (1, 1, 2, 24, 5, True), (1, 9, 1, 100, 100, True)])
def test_ssm_scan_kernel(cuda, B, S, H, hd, ds, warm):
    from repro_torch.kernels import ssm_scan
    rng = np.random.default_rng(S + hd)
    xh = _randn(rng, (B, S, H, hd), cuda)
    Bm, Cm = _randn(rng, (B, S, ds), cuda), _randn(rng, (B, S, ds), cuda)
    dt = torch.nn.functional.softplus(_randn(rng, (B, S, H), cuda))
    A = torch.exp(_randn(rng, (H,), cuda, 0.5))
    D = _randn(rng, (H,), cuda)
    s0 = _randn(rng, (B, H, hd, ds), cuda) if warm \
        else torch.zeros((B, H, hd, ds), device=cuda)
    want = ref.ssm_scan(xh, Bm, Cm, dt, A, D, s0)
    got = ssm_scan.launch(xh, Bm, Cm, dt, A, D, s0)
    torch.cuda.synchronize()
    _scan_close(got[0], want[0])
    _scan_close(got[1], want[1])
    cache = s0.clone()
    y, st = ssm_scan.launch(xh, Bm, Cm, dt, A, D, cache, out=cache)
    assert st is cache
    _scan_close(y, want[0])
    _scan_close(cache, want[1])


@pytest.mark.parametrize("B,S,H,hd_k,hd_v,warm", [
    (2, 17, 2, 64, 64, True), (2, 17, 2, 64, 64, False),
    (1, 1, 1, 24, 24, True), (1, 9, 2, 48, 24, True),
    (1, 5, 1, 512, 80, True)])
def test_mlstm_scan_kernel(cuda, B, S, H, hd_k, hd_v, warm):
    from repro_torch.kernels import mlstm_scan
    rng = np.random.default_rng(S + hd_k + hd_v)
    q = _randn(rng, (B, S, H, hd_k), cuda)
    k = _randn(rng, (B, S, H, hd_k), cuda) / hd_k ** 0.5
    v = _randn(rng, (B, S, H, hd_v), cuda)
    i_pre = _randn(rng, (B, S, H), cuda, 2.0)
    f_pre = _randn(rng, (B, S, H), cuda, 2.0, 1.0)
    if warm:
        state = (_randn(rng, (B, H, hd_k, hd_v), cuda),
                 _randn(rng, (B, H, hd_k), cuda), _randn(rng, (B, H), cuda))
    else:
        state = (torch.zeros((B, H, hd_k, hd_v), device=cuda),
                 torch.zeros((B, H, hd_k), device=cuda),
                 torch.full((B, H), -1e30, device=cuda))
    want = ref.mlstm_scan(q, k, v, i_pre, f_pre, state)
    got = mlstm_scan.launch(q, k, v, i_pre, f_pre, state)
    torch.cuda.synchronize()
    _scan_close(got[0], want[0])
    _scan_close(got[1], want[1])
    cache = tuple(s.clone() for s in state)
    hs, st = mlstm_scan.launch(q, k, v, i_pre, f_pre, cache, out=cache)
    assert all(a is b for a, b in zip(st, cache))
    _scan_close(hs, want[0])
    _scan_close(cache, want[1])


@pytest.mark.parametrize("B,S,H,hd,warm,scale", [
    (2, 13, 2, 64, True, 1.0), (2, 13, 2, 64, False, 1.0),
    (1, 1, 1, 24, True, 1.0), (1, 7, 1, 512, True, 1.0),
    (2, 9, 2, 40, False, 60.0)])
def test_slstm_scan_kernel(cuda, B, S, H, hd, warm, scale):
    from repro_torch.kernels import slstm_scan
    rng = np.random.default_rng(S + hd)
    r = _randn(rng, (H, 4, hd, hd), cuda, 0.3 / hd ** 0.5)
    gates = _randn(rng, (B, S, 4, H, hd), cuda, scale)
    if warm:
        state = (_randn(rng, (B, H, hd), cuda),
                 _randn(rng, (B, H, hd), cuda).abs() + 0.5,
                 _randn(rng, (B, H, hd), cuda), _randn(rng, (B, H), cuda))
    else:
        z = torch.zeros((B, H, hd), device=cuda)
        state = (z, z.clone(), z.clone(),
                 torch.full((B, H), -1e30, device=cuda))
    want = ref.slstm_scan(r, state, gates, S)
    got = slstm_scan.launch(r, state, gates, S)
    torch.cuda.synchronize()
    _scan_close(got[0], want[0])
    _scan_close(got[1], want[1])
    if scale > 1:
        assert not bool(torch.isfinite(want[0]).all())
    cache = tuple(s.clone() for s in state)
    hs, st = slstm_scan.launch(r, cache, gates, S, out=cache)
    assert all(a is b for a, b in zip(st, cache))
    _scan_close(hs, want[0])
    _scan_close(cache, want[1])


def test_slstm_scan_kernel_block_with_given_stabilizers(cuda):
    """One step of a block of hd (hd_v = hd / 2, the whole h in, the
    head-level means given), what a rank of a model axis past 1 runs."""
    from repro_torch.kernels import slstm_scan
    rng = np.random.default_rng(9)
    B, H, hd, half = 2, 2, 64, 32
    r = _randn(rng, (H, 4, hd, half), cuda, 0.3 / hd ** 0.5)
    gates = _randn(rng, (B, 3, 4, H, half), cuda)
    state = (_randn(rng, (B, H, half), cuda),
             _randn(rng, (B, H, half), cuda).abs() + 0.5,
             _randn(rng, (B, H, hd), cuda), _randn(rng, (B, H), cuda))
    sc = _randn(rng, (B, 2, H), cuda)
    want = ref.slstm_scan(r, state, gates[:, 1:2], 1, sc=sc)
    got = slstm_scan.launch(r, state, gates[:, 1:2], 1, sc=sc)
    torch.cuda.synchronize()
    _scan_close(got[0], want[0])
    _scan_close(got[1], want[1])


def test_scan_routing_on_the_card(cuda):
    """Frozen inputs launch the kernel; an input that requires a gradient
    under grad mode runs the plain loop, counted ``"<name>/plain"``, and
    its output carries the gradient; under no_grad it launches."""
    rng = np.random.default_rng(10)
    B, S, H, hd = 1, 4, 2, 16
    r = _randn(rng, (H, 4, hd, hd), cuda, 0.1)
    gates = _randn(rng, (B, S, 4, H, hd), cuda)
    z = torch.zeros((B, H, hd), device=cuda)
    state = (z, z, z, torch.full((B, H), -1e30, device=cuda))
    ops.reset_launch_counts()
    ops.slstm_scan(r, state, gates, S)
    assert ops.launch_counts()["slstm_scan"] == 1
    g = gates.clone().requires_grad_(True)
    hs, _ = ops.slstm_scan(r, state, g, S)
    counts = ops.launch_counts()
    assert counts["slstm_scan"] == 1 and counts["slstm_scan/plain"] == 1
    hs.sum().backward()
    assert g.grad is not None and bool(torch.isfinite(g.grad).all())
    with torch.no_grad():
        ops.slstm_scan(r, state, g, S)
    assert ops.launch_counts()["slstm_scan"] == 2
    x = _randn(rng, (B, S, H, hd), cuda).requires_grad_(True)
    Bm = _randn(rng, (B, S, 8), cuda)
    ops.ssm_scan(x, Bm, Bm, torch.ones((B, S, H), device=cuda),
                 torch.ones(H, device=cuda), torch.ones(H, device=cuda),
                 torch.zeros((B, H, hd, 8), device=cuda))
    q = _randn(rng, (B, S, H, hd), cuda).requires_grad_(True)
    gt = _randn(rng, (B, S, H), cuda)
    ops.mlstm_scan(q, q.detach(), q.detach(), gt, gt, (
        torch.zeros((B, H, hd, hd), device=cuda),
        torch.zeros((B, H, hd), device=cuda),
        torch.full((B, H), -1e30, device=cuda)))
    counts = ops.launch_counts()
    assert counts["ssm_scan"] == counts["mlstm_scan"] == 0
    assert counts["ssm_scan/plain"] == counts["mlstm_scan/plain"] == 1
