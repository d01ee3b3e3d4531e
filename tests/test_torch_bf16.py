"""precision="bf16" of the fused Jacobi superstep in repro_torch, on the CPU,
against the JAX package.

The mode gives the Gram and margin products bfloat16 inputs: w x is formed
in float32 and then rounded, x, s and dbeta are rounded (to nearest even),
and the products are summed in float32 or wider; the stats, the solves and
the 294 candidate losses stay float32.  A product of two bfloat16 values is
exact in float32, so the port's plain versions and the reference's differ
only in the order of their sums: 1e-5 relative to the largest entry.  The
reference's Pallas route (interpret mode) is held at 1e-4, as in
``test_torch_fused.py``: its stats bodies differ from the oracle's in the
tails.

The reference casts the margin too only on its Pallas route; its ``ref``
route keeps the margin in float32 (``repro/core/dglmnet.py``).  The port's
dense fused path is the one-pass route, so its dense bf16 fit is held
against JAX's Pallas route; the brick route is the same on both of JAX's
routes (bf16 Gram, then a float32 matvec and the candidate losses).

The bf16 G is not symmetric (the weight is rounded into one side of each
product only), and the solve reads both triangles: the kernels compute
every block of it, and a test below holds the port's G against JAX's in
both triangles.  The last part emulates on the CPU the rounding and the
order of sums of the kernels' bf16 mode (``kernels/csrc/gram_tc.cuh``,
``margin_ls.cu``), as ``test_torch_gram_split.py`` does for 3xTF32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (design <-> ops import cycle: core first)
from repro.core.dglmnet import DGLMNETConfig as JConfig
from repro.core.solver import GLMSolver as JSolver
from repro.data import design as jdesign
from repro.data import synthetic as jsynth
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import linesearch as tls
from repro_torch.core.dglmnet import DGLMNETConfig as TConfig
from repro_torch.core.solver import GLMSolver as TSolver
from repro_torch.data import design as tdesign
from repro_torch.kernels import gram_tc, ops, ref
from test_torch_fused import (FAMILIES, _brick_pair, _dense_case,
                              _fit_problem, _labels, _obs, t)

BF = "bf16"


def _rel(a, b):
    """max |a - b| over max(max |b|, 1)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


# ------------------------------------------------ plain versions vs JAX


@pytest.mark.parametrize("family", FAMILIES)
def test_stats_gram_dense_bf16_matches_jax_ref(family):
    X, y, beta, w, off, _, live, jd, td = _dense_case(family)
    xb = X @ beta
    got = ref.fused_stats_gram_dense(td.tiles3(), t(y), t(xb), t(w), family,
                                     offset=t(off), tile_live=live,
                                     precision=BF)
    want = jref.fused_stats_gram_dense(
        jd.tiles3(), jnp.asarray(y), jnp.asarray(xb), jnp.asarray(w), family,
        offset=jnp.asarray(off), tile_live=jnp.asarray(live), precision=BF)
    # JAX leaves a dead tile's G and g unspecified below 8 tiles
    for a, b, name in zip(got, want[:3] + (want[3][:1], want[4][:1]),
                          ("loss", "s", "w", "G", "g")):
        assert _rel(a.numpy()[:b.shape[0]], b) <= 1e-5, name
    assert not got[3][1].any() and not got[4][1].any()


@pytest.mark.parametrize("family", FAMILIES)
def test_stats_gram_bricks_bf16_matches_jax_ref(family):
    jd, td = _brick_pair(12)
    n, p = td.shape
    rng = np.random.default_rng(13)
    y = _labels(rng, family, n)
    w, off, _ = _obs(rng, n, p)
    beta = (0.3 * rng.normal(size=p) * (rng.random(p) < 0.3)) \
        .astype(np.float32)
    xb = td.matvec(t(beta)).numpy()
    b3, rows, valid = td.gather_all_tiles()
    jb3, jrows, jvalid = jd.gather_all_tiles()
    got = ref.fused_stats_gram_bricks(b3, rows, valid, t(y), t(xb), t(w),
                                      family, offset=t(off), precision=BF)
    want = jref.fused_stats_gram_bricks(
        jb3, jrows, jvalid, jnp.asarray(y), jnp.asarray(xb), jnp.asarray(w),
        family, offset=jnp.asarray(off), precision=BF)
    for a, b, name in zip(got, want, ("loss", "s", "w", "G", "g")):
        assert _rel(a.numpy(), b) <= 1e-5, name
    # K3's plain version, tile by tile, is the same function
    for tid in range(td.n_tiles):
        tb, trows = td.tile_bricks(tid)
        G, g = ops.tile_gram(tb, trows, tb.shape[0], got[2], got[1],
                             precision=BF)
        assert _rel(G.numpy(), want[3][tid]) <= 1e-5
        assert _rel(g.numpy(), want[4][tid]) <= 1e-5


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_ls_dense_bf16_matches_jax_ref(family):
    X, y, beta, w, off, _, _, jd, td = _dense_case(family, seed=10)
    rng = np.random.default_rng(11)
    xb = X @ beta
    dbeta = (0.3 * rng.normal(size=X.shape[1])).astype(np.float32)
    cand = tls.full_candidates(1e-3, 13, 0.5, 20, device="cpu")
    got = ref.fused_ls_dense(td.tiles3(), t(y), t(xb), t(dbeta), t(w), cand,
                             family, offset=t(off), precision=BF)
    want = jref.fused_ls_dense(
        jd.tiles3(), jnp.asarray(y), jnp.asarray(xb), jnp.asarray(dbeta),
        jnp.asarray(w), jnp.asarray(cand.numpy()), family,
        offset=jnp.asarray(off), precision=BF)
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b) <= 1e-5
    # the mode really rounds: fp32 gives another xdb
    fp32 = ref.fused_ls_dense(td.tiles3(), t(y), t(xb), t(dbeta), t(w),
                              cand, family, offset=t(off))
    assert _rel(fp32[0].numpy(), want[0]) > 1e-4


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_stats_sweep_dense_bf16_matches_jax_pallas(family):
    """The port's fused op (K5's plain version on the CPU) against the
    reference's Pallas kernel in interpret mode, bf16 branch."""
    X, y, beta, w, off, pf, live, jd, td = _dense_case(family)
    T = 128
    xb = X @ beta
    kw = dict(mu=1.5, nu=1e-6, lam1=0.1, lam2=0.05)
    got = ops.fused_stats_sweep(td, t(y), t(xb), t(beta), family,
                                weights=t(w), offset=t(off), penf=t(pf),
                                tile_live=live, precision=BF, **kw)
    want = jops.fused_stats_sweep(
        jd, jnp.asarray(y), jnp.asarray(xb), jnp.asarray(beta), family,
        weights=jnp.asarray(w), offset=jnp.asarray(off),
        penf=jnp.asarray(pf), tile_live=jnp.asarray(live), backend="pallas",
        precision=BF, **kw)
    for a, b, name in zip(got[:3], want[:3], ("loss", "s", "w")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0,
                               atol=1e-4, err_msg="dbeta")
    assert not got[3][T:].any() and np.abs(got[3].numpy()).max() > 0
    for a, b in ((got[4], want[4]), (got[5], want[5])):
        assert _rel(a.numpy()[0], np.asarray(b)[0]) <= 1e-4
        assert not a[1].any()


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_ls_dense_bf16_matches_jax_pallas(family):
    X, y, beta, w, off, _, _, jd, td = _dense_case(family, seed=10)
    rng = np.random.default_rng(11)
    xb = X @ beta
    dbeta = (0.3 * rng.normal(size=X.shape[1])).astype(np.float32)
    cand = tls.full_candidates(1e-3, 13, 0.5, 20, device="cpu")
    xdb, losses = ops.fused_ls(td, t(y), t(xb), t(dbeta), cand, family,
                               weights=t(w), offset=t(off), precision=BF)
    jxdb, jlosses = jops.fused_ls(
        jd, jnp.asarray(y), jnp.asarray(xb), jnp.asarray(dbeta),
        jnp.asarray(cand.numpy()), family, weights=jnp.asarray(w),
        offset=jnp.asarray(off), backend="pallas", precision=BF)
    np.testing.assert_allclose(xdb.numpy(), np.asarray(jxdb), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["dense", "bricks"])
def test_bf16_G_matches_jax_in_both_triangles(kind):
    """G_ij = sum bf16(w x_i) bf16(x_j) is not G_ji: a G mirrored from one
    triangle would miss JAX's other triangle by the asymmetry, which is as
    large as bf16's whole error.  The port's G matches JAX's in each
    triangle, and so does its asymmetry."""
    rng = np.random.default_rng(21)
    if kind == "dense":
        n, T = 600, 64
        X = rng.normal(size=(n, 2 * T)).astype(np.float32)
        X[:, 0] = 1.0
        w = np.exp(rng.uniform(np.log(1e-4), np.log(0.25), n)) \
            .astype(np.float32)
        s = rng.normal(size=n).astype(np.float32)
        jd, _ = jdesign.dense_design(jnp.asarray(X), T)
        td, _ = tdesign.dense_design(X, T, device="cpu")
        G, _ = ref.gram_dense_tiles(td.tiles3(), t(w), t(s), BF)
        Gj, _ = jref.gram_dense_tiles(jd.tiles3(), jnp.asarray(w),
                                      jnp.asarray(s), BF)
    else:
        jd, td = _brick_pair(22)
        n = td.shape[0]
        w = np.exp(rng.uniform(np.log(1e-4), np.log(0.25), n)) \
            .astype(np.float32)
        s = rng.normal(size=n).astype(np.float32)
        b3, rows, valid = td.gather_all_tiles()
        G, _ = ref.gram_brick_tiles(b3, rows, valid, t(w), t(s), BF)
        Gj, _ = jref.gram_brick_tiles(*jd.gather_all_tiles(), jnp.asarray(w),
                                      jnp.asarray(s), BF)
    G, Gj = G.numpy(), np.asarray(Gj)
    lower = np.tril(np.ones(G.shape[-1], bool), -1)
    for tri in (lower, lower.T):
        assert _rel(G[:, tri], Gj[:, tri]) <= 1e-5
    asym = G - G.transpose(0, 2, 1)
    asym_j = Gj - Gj.transpose(0, 2, 1)
    scale = np.abs(Gj).max()
    assert np.abs(asym).max() > 1e-4 * scale        # not symmetric
    assert np.abs(asym - asym_j).max() <= 1e-5 * scale
    # mirrored, the lower triangle would miss JAX's by the asymmetry
    mirrored = np.where(lower, G.transpose(0, 2, 1), G)
    assert np.abs(mirrored - Gj).max() > 10 * np.abs(G - Gj).max()


def test_dense_tile_gram_refuses_bf16():
    """The dense bf16 Gram is K5's; the per-tile matrix product is float32
    only and takes no precision, instead of running as float32."""
    td, _ = tdesign.dense_design(np.ones((8, 4), np.float32), 4,
                                 device="cpu")
    with pytest.raises(TypeError, match="precision"):
        td.all_tile_grams(torch.ones(8), torch.ones(8), precision=BF)
    with pytest.raises(ValueError, match="precision"):
        ops.fused_ls(td, torch.ones(8), torch.zeros(8), torch.zeros(4),
                     torch.ones(3), "logistic", precision="fp16")


# ----------------------------------------------------------------- fits


def _fit_pair(kind, family, seed, steps, jax_backend):
    X, Xt, y, obs = _fit_problem(kind, family, seed)
    T = 16 if kind == "dense" else 32
    kw = dict(fit_intercept=True, row_block=32, **obs)
    js = JSolver(X, y, family=family, config=JConfig(
        family=family, tile_size=T, coupling="jacobi", precision=BF,
        kernel_backend=jax_backend), **kw)
    ts = TSolver(Xt, y, family=family, config=TConfig(
        family=family, tile_size=T, coupling="jacobi", precision=BF),
        device="cpu", **kw)
    lam1 = 0.1 * float(ts.lambda_max())
    ra = js.fit(lam1=lam1, lam2=0.05, max_outer=steps, tol=0.0)
    rb = ts.fit(lam1=lam1, lam2=0.05, max_outer=steps, tol=0.0)
    return ra, rb


@pytest.mark.parametrize("kind,family,seed,backend", [
    ("dense", "logistic", 5, "pallas"), ("dense", "poisson", 5, "pallas"),
    ("sparse", "logistic", 7, None), ("sparse", "squared", 7, None)])
def test_bf16_fit_matches_jax(kind, family, seed, backend):
    """4 supersteps at tol=0: the same alpha every superstep, f within
    1e-5 relative and beta within 1e-5 (the bar of test_torch_fused.py)."""
    ra, rb = _fit_pair(kind, family, seed, 4, backend)
    assert rb.n_iter == ra.n_iter == 4
    assert rb.history["alpha"] == ra.history["alpha"]
    np.testing.assert_allclose(rb.history["f"], ra.history["f"], rtol=1e-5)
    np.testing.assert_allclose(rb.beta, ra.beta, rtol=0, atol=1e-5)
    assert np.abs(rb.beta).max() > 0


def test_bf16_tracks_fp32_alpha_sequence():
    """The reference's own bar (tests/test_fused.py), on the port: the
    accepted-alpha sequence of a bf16 fit tracks the fp32 one (the line
    search decides on float32 sums) and beta lands within bf16 resolution
    of the fp32 fit."""
    ds = jsynth.make_dense(n=300, p=48, k_true=8, seed=12)
    fits = {}
    for prec in ("fp32", BF):
        s = TSolver(ds.train.X, ds.train.y, device="cpu", config=TConfig(
            family="logistic", tile_size=16, coupling="jacobi",
            max_outer=60, tol=1e-10, precision=prec))
        fits[prec] = s.fit(lam1=0.1 * s.lambda_max(), lam2=0.05)
    a32 = np.asarray(fits["fp32"].history["alpha"])
    a16 = np.asarray(fits[BF].history["alpha"])
    k = min(len(a32), len(a16))
    assert k > 5
    match = float(np.mean(np.isclose(a32[:k], a16[:k], rtol=1e-6)))
    assert match >= 0.8, (match, a32[:k], a16[:k])
    err = float(np.abs(fits[BF].beta - fits["fp32"].beta).max())
    scale = float(np.abs(fits["fp32"].beta).max())
    assert err <= 0.05 * max(scale, 1.0), (err, scale)
    assert err > 0                     # the mode did round


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("coupling,fused", [("gauss-seidel", True),
                                            ("jacobi", False)])
def test_bf16_is_inert_off_the_fused_superstep(kind, coupling, fused):
    """As in the reference, precision is read only by the fused Jacobi
    superstep: Gauss-Seidel and unfused Jacobi fits give the same bits."""
    X, Xt, y, obs = _fit_problem(kind, "logistic", 5)
    T = 16 if kind == "dense" else 32
    betas = []
    for prec in ("fp32", BF):
        s = TSolver(Xt, y, device="cpu", fit_intercept=True, row_block=32,
                    config=TConfig(tile_size=T, coupling=coupling,
                                   fuse_superstep=fused, precision=prec),
                    **obs)
        r = s.fit(lam1=0.1 * s.lambda_max(), lam2=0.05, max_outer=5,
                  tol=0.0)
        betas.append((r.beta, r.history["f"]))
    assert np.array_equal(betas[0][0], betas[1][0])
    assert betas[0][1] == betas[1][1]


# ------------------------------------- the kernels' arithmetic, emulated

N_ROWS = 12_500
T_EMU = 16
K_STEP = 16                     # rows of a bf16 wgmma k step
CHUNK = 4 * gram_tc.SLAB        # rows between drains of the accumulators


def bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bfloat16 on its bits, to nearest with ties to
    even, as cvt.rn.bf16.f32 (the kernels' __float2bfloat16_rn) does for
    finite inputs: add 0x7FFF plus the lowest kept bit, drop 16 bits."""
    bits = x.contiguous().view(torch.int32)
    keep_lsb = (bits >> 16) & 1
    rounded = (bits + 0x7FFF + keep_lsb) & ~0xFFFF
    return rounded.view(torch.float32)


def test_bf16_rounding_ties_subnormals_and_large_values():
    ulp = 2.0 ** -7                  # bf16's spacing just above 1
    x = torch.tensor([
        1.0 + ulp / 2,               # a tie: to even, 1
        1.0 + 3 * ulp / 2,           # a tie: to even, 1 + 2 ulp
        -(1.0 + 3 * ulp / 2),        # its negative twin
        1.0 + ulp / 2 + 2.0 ** -20,  # just past the tie: up
        1.0 / 3.0,
        1e-40, -1e-40,               # float32 subnormals
        2.0 ** -133,                 # the smallest bf16 subnormal, exact
        2.0 ** -134,                 # a tie between 0 and it: to even, 0
        3.0e38,                      # large, finite
        3.4e38,                      # past bf16's largest: to infinity
        0.0, -0.0], dtype=torch.float32)
    got = bf16_bits(x)
    assert torch.equal(got.view(torch.int32) & 0xFFFF,
                       torch.zeros(x.shape[0], dtype=torch.int32))
    assert got[:4].tolist() == [1.0, 1.0 + 2 * ulp, -(1.0 + 2 * ulp),
                                1.0 + ulp]
    assert float(got[7]) == 2.0 ** -133 and float(got[8]) == 0.0
    assert torch.isfinite(got[9]) and torch.isinf(got[10])
    # torch's own conversion agrees bit for bit, subnormals included
    assert torch.equal(got.view(torch.int32),
                       x.to(torch.bfloat16).float().view(torch.int32))
    rng = np.random.default_rng(0)
    r = torch.from_numpy((rng.normal(size=100_000)
                          * np.exp(rng.uniform(-80, 80, 100_000)))
                         .astype(np.float32))
    assert torch.equal(bf16_bits(r).view(torch.int32),
                       r.to(torch.bfloat16).float().view(torch.int32))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N_ROWS, T_EMU)).astype(np.float32)
    X[:, 0] = 1.0                                    # intercept
    X[:, 1] = rng.integers(0, 4, N_ROWS) / np.float32(3.0)
    w = np.exp(rng.uniform(np.log(1e-6), np.log(0.25), N_ROWS))
    s = rng.normal(size=N_ROWS)
    return (torch.from_numpy(X), torch.from_numpy(w.astype(np.float32)),
            torch.from_numpy(s.astype(np.float32)))


def _gram_emulated(X, w):
    """G as the bf16 mode sums it: A = bf16(w x) (w x in float32), B =
    bf16(x); one k step of 16 rows a product (its 16 exact products added
    at once, modelled in float64, then to the float32 accumulator), the
    accumulator drained every 128 rows into a float32 range sum, the
    ranges added in order (the reduce pass)."""
    A, B = bf16_bits(X * w[:, None]), bf16_bits(X)
    G = torch.zeros(T_EMU, T_EMU)
    for r0 in range(0, X.shape[0], gram_tc.MAX_RANGE_ROWS):
        tot = torch.zeros(T_EMU, T_EMU)
        r1 = min(r0 + gram_tc.MAX_RANGE_ROWS, X.shape[0])
        for c0 in range(r0, r1, CHUNK):
            acc = torch.zeros(T_EMU, T_EMU)
            for k0 in range(c0, min(c0 + CHUNK, r1), K_STEP):
                k1 = min(k0 + K_STEP, r1)
                step = A[k0:k1].double().T @ B[k0:k1].double()
                acc = (acc.double() + step).float()
            tot = tot + acc
        G = G + tot
    return G


def _g_emulated(X, s):
    """g as a diagonal block sums it on the FMA pipes: a float32 chain of
    bf16(x) bf16(s) over a slab's 32 rows, then into a running float32
    total, ranges added in order."""
    A, S = bf16_bits(X), bf16_bits(s)
    g = torch.zeros(T_EMU)
    for r0 in range(0, X.shape[0], gram_tc.MAX_RANGE_ROWS):
        r1 = min(r0 + gram_tc.MAX_RANGE_ROWS, X.shape[0])
        tot = torch.zeros(T_EMU)
        for k0 in range(r0, r1, gram_tc.SLAB):
            gs = torch.zeros(T_EMU)
            for k in range(k0, min(k0 + gram_tc.SLAB, r1)):
                gs = gs + A[k] * S[k]
            tot = tot + gs
        g = g + tot
    return g


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_mode_sums_match_the_plain_version(seed):
    """With the operands rounded alike, the kernel's order of float32 sums
    stays within 1e-6 of the plain version's float64 sums (1e-5 is the
    tolerance the card is held to), in both triangles of G and in g."""
    X, w, s = _inputs(seed)
    G_plain, g_plain = ref.gram_dense_tiles(X[None], w, s, BF)
    assert _rel(_gram_emulated(X, w), G_plain[0]) <= 1e-6
    assert _rel(_g_emulated(X, s), g_plain[0]) <= 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_rounding_is_what_separates_the_modes(seed):
    """The rounding, not the sums, is the mode's error: G is off the
    float64 Gram of the unrounded inputs by far more than 1e-5, and its
    asymmetry is of the same order."""
    X, w, _ = _inputs(seed)
    Xd = X.double()
    G64 = (Xd * w.double()[:, None]).T @ Xd
    G = _gram_emulated(X, w).double()
    err = float((G - G64).abs().max() / G64.abs().max())
    asym = float((G - G.T).abs().max() / G64.abs().max())
    assert err > 1e-5 and asym > 1e-5
    assert err < 2.0 ** -7           # within bf16's relative spacing


def test_margin_ls_bf16_emulated():
    """K6's bf16 mode: X rounded as read, dbeta as staged, fp32 products
    (exact) summed in lane order, four partial sums a lane over columns
    4 lane + 128 q, then a butterfly; held against the plain version."""
    rng = np.random.default_rng(3)
    n, p = 64, 1024
    X = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32))
    d = torch.from_numpy((0.3 * rng.normal(size=p)).astype(np.float32))
    Xr, dr = bf16_bits(X), bf16_bits(d)
    # lane l, component c: columns 4 l + c + 128 q, a float32 FMA chain
    part = torch.zeros(n, 32, 4)
    for q in range(p // 128):
        cols = (torch.arange(32)[:, None] * 4 + torch.arange(4)[None, :]
                + 128 * q)
        part = part + Xr[:, cols] * dr[cols]
    lane = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
    for o in (16, 8, 4, 2, 1):
        lane = lane + lane[:, torch.arange(32) ^ o]
    xdb = lane[:, 0]
    plain, _ = ref.fused_ls_dense(X.view(n, 1, p).transpose(0, 1),
                                  torch.ones(n), torch.zeros(n), d,
                                  torch.ones(n), torch.ones(1), "squared",
                                  precision=BF)
    assert _rel(xdb.numpy(), plain.numpy()) <= 1e-6
