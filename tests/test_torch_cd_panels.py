"""The K2 chain's order of operations (``kernels/csrc/cd_chain.cuh``),
emulated on the CPU.

The kernel runs the tile's coordinate chain in panels of 32 coordinates,
one warp each.  Inside a panel, step j's mu*delta goes to every lane and
each lane k > j applies g_k -= (mu*delta_j) G[k, j]; a later panel applies
the earlier panels' updates deferred, one element at a time in increasing
j; updates j > k are never made (g_k is dead after step k), and the
divisor of a dead column (den <= 0) is 1, its quotient being replaced by
beta_j.  Lanes past T are zero coordinates.  The emulation below follows
that schedule in numpy float32, each multiply and subtract rounded on its
own as the kernel's __fmul_rn / __fsub_rn are, and must give the bits of
the port's plain version, ``kernels/ref.py::cd_tile_solve``
(``np.array_equal``).  That is the kernel's bit-exactness argument run on
the CPU; the card's own bits are checked by the ``gpu`` tests and
``chip_smoke.py`` (tolerance 0).

Against the JAX package's chain (``repro.kernels.ops.cd_tile_solve``, its
``ref`` route and its Pallas kernel in interpret mode) the bar is 1e-5, as
in ``tests/test_torch_kernels.py``: XLA on the CPU may fuse a multiply and
a subtract, so bit-equality with JAX is not promised.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

PANEL = 32
F = np.float32


def emulate_panels(G, g, h, beta, dbeta, mu, nu, lam1, lam2, penf):
    """The kernel's schedule of the chain, in numpy float32."""
    T = g.shape[0]
    nw = -(-T // PANEL)
    P = nw * PANEL

    def pad(v):
        return np.concatenate([np.asarray(v, F), np.zeros(P - T, F)])

    Gp = np.zeros((P, P), F)
    Gp[:T, :T] = G
    gk, hk, bk, d, pf = (pad(v) for v in (g, h, beta, dbeta, penf))
    mu, nu, lam1, lam2 = F(mu), F(nu), F(lam1), F(lam2)
    muh = mu * hk
    den = (muh + nu) + lam2 * pf
    a = muh * (bk + d)
    b = nu * bk
    l1 = lam1 * pf
    live = den > 0
    div = np.where(live, np.maximum(den, F(1e-30)), F(1.0))
    md = np.zeros(P, F)
    for w in range(nw):
        lo, hi = w * PANEL, (w + 1) * PANEL
        for j in range(lo):                 # deferred, in increasing j
            gk[lo:hi] = gk[lo:hi] - md[j] * Gp[lo:hi, j]
        for j in range(lo, hi):             # the warp-synchronous panel
            num = (gk[j] + a[j]) + b[j]
            mag = max(F(abs(num) - l1[j]), F(0.0))
            sgn = F(1.0) if num > 0 else (F(-1.0) if num < 0 else F(0.0))
            u = (sgn * mag) / div[j]
            if not live[j]:
                u = bk[j]
            dnew = u - bk[j]
            md[j] = mu * (dnew - d[j])
            d[j] = dnew
            # only lanes k > j: g_k is dead after step k
            gk[j + 1:hi] = gk[j + 1:hi] - md[j] * Gp[j + 1:hi, j]
    return d[:T]


def _tile(T, seed, n=None):
    rng = np.random.default_rng(seed)
    n = n or max(2 * T, 200)
    X = rng.normal(size=(n, T)).astype(F)
    w = rng.uniform(0.01, 0.25, n).astype(F)
    G = (X.T * w) @ X
    g = X.T @ rng.normal(size=n).astype(F)
    beta = (rng.normal(size=T) * 0.3).astype(F)
    penf = rng.uniform(0.5, 1.5, T).astype(F)
    return rng, X, G, g, beta, penf


CASES = {
    # name: (mu, nu, lam1 over max |g|, lam2, entering step, dead column,
    #        unpenalized column 0)
    "plain": (1.0, 1e-6, 0.05, 0.0, False, False, False),
    # an all-zero column with nu = lam2 = 0 (den = 0: its step stays 0) and
    # an unpenalized intercept
    "dead_column": (2.0, 0.0, 0.1, 0.0, False, True, True),
    # a Gauss-Seidel tile entered with a nonzero step, mu a 0-d tensor
    "entering_step": (None, 1e-6, 0.02, 0.1, True, False, True),
    # lam1 near max |g| on a tile at beta = 0: most coordinates stay at 0
    "sparse_step": (4.0, 1e-6, 0.9, 0.0, False, True, False),
}


def _inputs(T, case):
    mu, nu, frac, lam2, entering, dead, unpen = CASES[case]
    rng, X, G, g, beta, penf = _tile(T, seed=T + len(case))
    if dead:
        X[:, T // 3] = 0.0
        G[T // 3, :] = 0.0
        G[:, T // 3] = 0.0
        g[T // 3] = 0.0
        beta[T // 3] = 0.0
    if unpen:
        penf[0] = 0.0
    if case == "sparse_step":
        beta[:] = 0.0
    dbeta = (rng.normal(size=T) * 0.05).astype(F) if entering \
        else np.zeros(T, F)
    if dead:
        dbeta[T // 3] = 0.0
    mu_t = torch.tensor(2.5) if mu is None else mu
    lam1 = float(frac * np.abs(g).max())
    return G, g, np.diag(G).copy(), beta, dbeta, penf, mu_t, nu, lam1, lam2


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("T", [32, 64, 100, 256, 512])
def test_panel_schedule_is_bit_exact(T, case):
    G, g, h, beta, dbeta, penf, mu, nu, lam1, lam2 = _inputs(T, case)
    mu_f = float(mu)
    want = ref.cd_tile_solve(torch.from_numpy(G), torch.from_numpy(g),
                             torch.from_numpy(h), torch.from_numpy(beta),
                             torch.from_numpy(dbeta), mu, nu, lam1, lam2,
                             penf=torch.from_numpy(penf)).numpy()
    got = emulate_panels(G, g, h, beta, dbeta, mu_f, nu, lam1, lam2, penf)
    assert np.array_equal(got, want)
    # the entry point on CPU tensors: the plain version, with the (4,)
    # params built once a sweep and h a strided view of G's diagonal
    Gt = torch.from_numpy(G)
    via_ops = ops.cd_tile_solve(
        Gt, torch.from_numpy(g), torch.diagonal(Gt), torch.from_numpy(beta),
        torch.from_numpy(dbeta),
        ops.solve_params(mu, nu, lam1, lam2, torch.from_numpy(g)),
        penf=torch.from_numpy(penf)).numpy()
    assert np.array_equal(via_ops, want)
    if CASES[case][5]:
        assert want[T // 3] == 0.0
    if case == "sparse_step":
        assert (want == 0.0).mean() > 0.5
    for backend in ("ref", "pallas"):
        theirs = np.asarray(jops.cd_tile_solve(
            jnp.asarray(G), jnp.asarray(g), jnp.asarray(h),
            jnp.asarray(beta), jnp.asarray(dbeta), mu_f, nu, lam1, lam2,
            penf=jnp.asarray(penf), backend=backend))
        np.testing.assert_allclose(want, theirs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,live", [(64, [True, False, True, True]),
                                    (100, [False, True, True])])
def test_jacobi_tile_solves_match_jax_vmap(T, live):
    """The batched Jacobi solve (one K2 launch on the card): each live tile
    the panel chain from a zero step, bit for bit; dead tiles exactly 0;
    within 1e-5 of JAX's vmapped solve masked as its sweep_jacobi does."""
    nt = len(live)
    rng = np.random.default_rng(T + nt)
    G_all = np.stack([_tile(T, seed=T + t)[2] for t in range(nt)])
    g_all = np.stack([_tile(T, seed=T + t)[3] for t in range(nt)])
    beta = (rng.normal(size=nt * T) * 0.3).astype(F)
    penf = rng.uniform(0.5, 1.5, nt * T).astype(F)
    penf[0] = 0.0
    mu, nu, lam2 = 1.5, 1e-6, 0.05
    lam1 = float(0.05 * np.abs(g_all).max())
    live = np.array(live)
    g_t = torch.from_numpy(g_all)
    got = ops.jacobi_tile_solves(
        torch.from_numpy(G_all), g_t, torch.from_numpy(beta),
        ops.solve_params(torch.tensor(mu), nu, lam1, lam2, g_t),
        penf=torch.from_numpy(penf), tile_live=live).numpy()
    for t in range(nt):
        sl = slice(t * T, (t + 1) * T)
        if not live[t]:
            assert not got[sl].any()
            continue
        want = emulate_panels(G_all[t], g_all[t], np.diag(G_all[t]),
                              beta[sl], np.zeros(T, F), mu, nu, lam1, lam2,
                              penf[sl])
        assert np.array_equal(got[sl], want)
    h_all = np.stack([np.diag(G) for G in G_all])
    for backend in ("ref", "pallas"):
        solve = jax.vmap(lambda Gt, gt, ht, bt, pt: jops.cd_tile_solve(
            Gt, gt, ht, bt, jnp.zeros_like(gt), mu, nu, lam1, lam2,
            penf=pt, backend=backend))
        theirs = solve(jnp.asarray(G_all), jnp.asarray(g_all),
                       jnp.asarray(h_all), jnp.asarray(beta.reshape(nt, T)),
                       jnp.asarray(penf.reshape(nt, T)))
        theirs = np.asarray(jnp.where(jnp.asarray(live)[:, None], theirs,
                                      0.0)).reshape(-1)
        np.testing.assert_allclose(got, theirs, rtol=1e-5, atol=1e-5)
