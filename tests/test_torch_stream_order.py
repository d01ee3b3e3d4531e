"""The schedules of K6 ``margin_ls`` and K7 ``predict_tile``
(``kernels/csrc/margin_ls.cu``, ``kernels/csrc/predict_tile.cu``),
emulated on the CPU.

K6 streams fixed row ranges: nb = min(ceil(n / 1024), grid) blocks (the
grid: 4 blocks an SM slot), block b the fixed rows [n b / nb, n (b + 1) /
nb); a block's rows go out in items (as many whole rows as fit in 1,024
floats, or a wider row in 1,024-column chunks), item i to warp i mod 16.
A row's dot product is lane l's four partial sums over the columns
4 l + 128 q (q rising, one fused multiply-add each), added pairwise, then
a butterfly of shuffles.  The candidates sit across lanes; each lane adds
16 rows' losses apart and then into its total, the block adds its 16
warps' totals in warp order, and the finishing pass adds the blocks'
partials in 32 strided runs and a shuffle tree.  Candidates past 320 take
further passes over the rows in the same order, so every candidate's sum
has the same shape.  The emulation below follows that in numpy float32 on
the plain version's own per-row losses and must agree with
``kernels/ref.py::fused_ls_dense`` within 1e-5 relative (a float32 sum in
another order), and with the JAX package's oracle.

K7 gives each request row a group of G lanes (8, 16 or 32: one 4-pair
vector a lane for a batch of up to 256 rows, two above); with J a multiple
of 4 lane i takes the 4-pair vectors i + G q, else the pairs i + G q, and a
slot outside the table reads the table's zero row.  The emulation checks
that every (b, j) pair is taken exactly once per pass of 4 outputs and
that the margins agree with the plain version within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core import glm as glm_lib
from repro_torch.core import linesearch
from repro_torch.kernels import margin_ls, predict_tile, ref

F = np.float32
# the constants of csrc/margin_ls.cu
STAGE, WARPS, PER_LANE, INNER, ROWS_PER_BLOCK = 1024, 16, 10, 16, 1024
H100_GRID = 4 * 132     # the grid cap on an H100: 4 waves of one block an SM
# the constants of csrc/predict_tile.cu
K7_Q, K7_L = 2, 4


def n_blocks(n, grid):
    return min(-(-n // ROWS_PER_BLOCK), grid)


def block_edges(n, nb):
    """Block b takes rows [edges[b], edges[b + 1])."""
    return n * np.arange(nb + 1, dtype=np.int64) // nb


def warp_rows(nrows, p, w):
    """The block-relative rows warp ``w`` takes, in its order."""
    rows_per = STAGE // p if p <= STAGE else 1
    items = -(-nrows // rows_per)
    its = np.arange(w, items, WARPS, dtype=np.int64)
    r = (its[:, None] * rows_per + np.arange(rows_per)[None, :]).ravel()
    return r[r < nrows]


def fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(F)


def butterfly(v):
    """A shuffle-xor tree over the last axis (32 lanes, or a lane group)."""
    lanes = np.arange(v.shape[-1])
    o = v.shape[-1] // 2
    while o:
        v = v + v[..., lanes ^ o]
        o //= 2
    return v


def row_dots(X, dbeta):
    """Each row's dot product as a consumer warp forms it."""
    n, p = X.shape
    Q = -(-p // 128)
    Xp = np.zeros((n, Q * 128), F)
    Xp[:, :p] = X
    dp = np.zeros(Q * 128, F)
    dp[:p] = dbeta
    Xl, dl = Xp.reshape(n, Q, 32, 4), dp.reshape(Q, 32, 4)
    s = np.zeros((n, 32, 4), F)
    for q in range(Q):
        s = fma(Xl[:, q], dl[q], s)
    v = (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])
    v = butterfly(v)
    assert (v == v[:, :1]).all()          # every lane holds the row's sum
    return v[:, 0]


def warp_total(Lw):
    """One lane's sum of its candidates over a warp's rows (K, rows): 16
    rows apart, then into the running total."""
    K, m = Lw.shape
    pad = -(-m // INNER) * INNER
    Lp = np.zeros((K, pad), F)
    Lp[:, :m] = Lw
    Lp = Lp.reshape(K, -1, INNER)
    part = np.zeros(Lp.shape[:2], F)
    for t in range(INNER):
        part = part + Lp[:, :, t]
    tot = np.zeros(K, F)
    for c in range(part.shape[1]):
        tot = tot + part[:, c]
    return tot


def emulate_k6(X, y, xb, dbeta, weights, alphas, family, offset, grid):
    n, p = X.shape
    xdb = row_dots(X, dbeta)
    fam = glm_lib.resolve_family(family)
    base = torch.from_numpy(xb)
    if offset is not None:
        base = base + torch.from_numpy(offset)
    a = torch.from_numpy(alphas)
    m = base[None, :] + a[:, None] * torch.from_numpy(xdb)[None, :]
    loss, _, _ = fam.stats(torch.from_numpy(y)[None, :], m)
    L = (loss * torch.from_numpy(weights)[None, :]).numpy()   # (K, n)
    nb = n_blocks(n, grid)
    edges = block_edges(n, nb)
    partials = np.zeros((nb, alphas.shape[0]), F)
    for b in range(nb):
        r0, r1 = edges[b], edges[b + 1]
        tot = np.zeros(alphas.shape[0], F)
        for w in range(WARPS):
            tot = tot + warp_total(L[:, r0 + warp_rows(r1 - r0, p, w)])
        partials[b] = tot
    lanes = np.zeros((alphas.shape[0], 32), F)
    for b in range(nb):
        lanes[:, b % 32] = lanes[:, b % 32] + partials[b]
    return xdb, butterfly(lanes)[:, 0]


@pytest.mark.parametrize("n", [1, 100, 1023, 70_001, 400_000])
@pytest.mark.parametrize("grid", [H100_GRID, 132, 4 * 114])
@pytest.mark.parametrize("p", [4, 384, 2048, 4104])
def test_k6_split_covers_every_row_once(n, grid, p):
    """Index arithmetic only: the blocks' ranges tile [0, n), each block
    non-empty, and a block's consumer warps take each of its rows once."""
    nb = n_blocks(n, grid)
    assert 1 <= nb <= grid
    edges = block_edges(n, nb)
    assert edges[0] == 0 and edges[-1] == n
    sizes = np.diff(edges)
    assert (sizes >= 1).all()
    assert sizes.max() - sizes.min() <= 1
    for nrows in np.unique(sizes):
        rows = np.concatenate([warp_rows(int(nrows), p, w)
                               for w in range(WARPS)])
        assert np.array_equal(np.sort(rows), np.arange(nrows))


CASES = {
    # (n, p, K, grid): one row; n under the grid; rows of one vector; the
    # fit's 8 KB rows (two chunks); chunked rows (4 x 1,024 + 8);
    # more candidates than the lanes hold (320); many rows and blocks
    "n1": (1, 384, 294, H100_GRID),
    "n_under_grid": (100, 64, 14, H100_GRID),
    "p4": (20_000, 4, 294, H100_GRID),
    "p2048": (5_000, 2048, 294, H100_GRID),
    "p4104": (3_000, 4104, 1, H100_GRID),
    "K400": (20_000, 256, 400, 4 * 114),
    "n70001": (70_001, 8, 14, H100_GRID),
}


def _inputs(rng, n, p, K, family):
    X = (0.1 * rng.normal(size=(n, p))).astype(F)
    y = (rng.poisson(1.0, n) if family == "poisson"
         else rng.choice([-1.0, 1.0], n)).astype(F)
    xb = rng.normal(size=n).astype(F)
    off = (0.1 * rng.normal(size=n)).astype(F)
    dbeta = (0.3 * rng.normal(size=p)).astype(F)
    w = rng.random(n).astype(F)
    w[::7] = 0.0
    if K == 294:
        alphas = linesearch.full_candidates(1e-3, 13, 0.5, 20,
                                            device="cpu").numpy()
    else:
        alphas = rng.uniform(0.0, 1.5, K).astype(F)
    return X, y, xb, off, dbeta, w, alphas


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


@pytest.mark.parametrize("case", list(CASES))
def test_k6_schedule_matches_plain(case):
    n, p, K, grid = CASES[case]
    rng = np.random.default_rng(5)
    X, y, xb, off, dbeta, w, alphas = _inputs(rng, n, p, K, "logistic")
    assert alphas.shape == (K,)
    xdb, losses = emulate_k6(X, y, xb, dbeta, w, alphas, "logistic", off,
                             grid)
    t = torch.from_numpy
    want = ref.fused_ls_dense(t(X).view(n, 1, p).transpose(0, 1), t(y),
                              t(xb), t(dbeta), t(w), t(alphas), "logistic",
                              offset=t(off))
    assert _rel(xdb, want[0].numpy()) <= 1e-5
    assert _rel(losses, want[1].numpy()) <= 1e-5


@pytest.mark.parametrize("family", ["logistic", "squared", "probit",
                                    "poisson"])
def test_k6_schedule_matches_jax_oracle(family):
    n, p = 3_000, 4104
    rng = np.random.default_rng(9)
    X, y, xb, off, dbeta, w, alphas = _inputs(rng, n, p, 294, family)
    xdb, losses = emulate_k6(X, y, xb, dbeta, w, alphas, family, off,
                             H100_GRID)
    jxdb, jlosses = jref.fused_ls_dense(
        jnp.asarray(X).reshape(n, 1, p).transpose(1, 0, 2), jnp.asarray(y),
        jnp.asarray(xb), jnp.asarray(dbeta), jnp.asarray(w),
        jnp.asarray(alphas), family, offset=jnp.asarray(off))
    assert _rel(xdb, np.asarray(jxdb)) <= 1e-5
    assert _rel(losses, np.asarray(jlosses)) <= 1e-5


def emulate_k7(slots, vals, table, b0):
    """K7's margins by its lane groups, and how often each (b, j) pair was
    taken in each pass of 4 outputs."""
    B, J = slots.shape
    A1, L = table.shape
    blocks, threads = predict_tile.grid(B, J)
    G = predict_tile.lanes_per_row(B, J)
    t = np.arange(blocks * threads)
    b_of, li_of = t // G, t % G
    assert np.array_equal(np.bincount(b_of[b_of < B], minlength=B),
                          np.full(B, G))          # every row has its group
    li = np.arange(G)
    nv = J // 4 if J % 4 == 0 else 0
    safe = np.where((slots >= 0) & (slots < A1), slots, A1 - 1)
    out = np.zeros((B, L), F)
    for l0 in range(0, L, K7_L):
        lw = min(K7_L, L - l0)
        rows = np.zeros((A1, K7_L), F)
        rows[:, :lw] = table[:, l0:l0 + lw]
        acc = np.zeros((B, G, K7_L), F)
        taken = np.zeros((B, J), np.int64)

        def take(j):                  # j (G,) pair of each lane, -1 none
            ok = j >= 0
            jj = np.where(ok, j, 0)
            v = np.where(ok[None, :], vals[:, jj], F(0))
            r = rows[np.where(ok[None, :], safe[:, jj], A1 - 1)]
            np.add.at(taken, (slice(None), jj[ok]), 1)
            return fma(v[..., None], r, acc)

        for v0 in range(0, nv, G * K7_Q):
            for q in range(K7_Q):
                v = v0 + li + G * q
                for e in range(4):
                    acc = take(np.where(v < nv, 4 * v + e, -1))
        for j0 in range(4 * nv, J, G * 4 * K7_Q):
            for q in range(4 * K7_Q):
                j = j0 + li + G * q
                acc = take(np.where(j < J, j, -1))
        assert (taken == 1).all()
        acc = butterfly(acc.transpose(0, 2, 1))[..., 0]     # (B, 4)
        out[:, l0:l0 + lw] = acc[:, :lw] + b0[l0:l0 + lw]
    return out


@pytest.mark.parametrize("J", [1, 3, 45, 64, 128])
@pytest.mark.parametrize("L", [1, 4, 11])
@pytest.mark.parametrize("B", [37, 300])
def test_k7_lane_groups_take_each_pair_once(J, L, B):
    # 37 rows: the last block's groups partly dead; 300 rows: two 4-pair
    # vectors a lane
    rng = np.random.default_rng(J * 100 + L)
    A = 300
    table = np.zeros((A + 1, L), F)
    table[:-1] = 0.2 * rng.normal(size=(A, L))
    slots = rng.integers(0, A + 1, size=(B, J)).astype(np.int32)
    vals = rng.normal(size=(B, J)).astype(F)
    b0 = rng.normal(size=L).astype(F)
    want_in = ref.predict_tile(torch.from_numpy(slots), torch.from_numpy(vals),
                               torch.from_numpy(table), torch.from_numpy(b0),
                               "logistic").numpy()
    jwant = jref.predict_tile(jnp.asarray(slots), jnp.asarray(vals),
                              jnp.asarray(table), jnp.asarray(b0)[None, :],
                              "logistic")
    assert _rel(emulate_k7(slots, vals, table, b0), want_in) <= 1e-5
    assert _rel(want_in, np.asarray(jwant)) <= 1e-5
    # slots outside the table read the zero row
    bad = rng.random((B, J)) < 0.2
    slots[bad] = rng.choice([-3, A + 1, 10 * A], size=int(bad.sum()))
    clamped = np.where(bad, A, slots).astype(np.int32)
    want = ref.predict_tile(torch.from_numpy(clamped), torch.from_numpy(vals),
                            torch.from_numpy(table), torch.from_numpy(b0),
                            "logistic").numpy()
    assert _rel(emulate_k7(slots, vals, table, b0), want) <= 1e-5


def test_wrappers_refuse_cpu_tensors():
    """No fall back: the kernels' wrappers take CUDA tensors or raise (the
    CPU runs the plain versions through ``kernels/ops.py``)."""
    X = torch.zeros(8, 4)
    v = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        margin_ls.launch(X, torch.zeros(4), v, v, v, torch.ones(3),
                         "logistic")
    with pytest.raises(ValueError, match="CUDA"):
        predict_tile.launch(torch.zeros((2, 4), dtype=torch.int32),
                            torch.zeros(2, 4), torch.zeros(5, 4),
                            torch.zeros(4), "logistic")
