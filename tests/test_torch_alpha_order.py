"""The order of sums of K4 ``alpha_search`` (``kernels/csrc/alpha_search.cu``),
emulated on the CPU.

With nb = max(1, min(wave, ceil(n / 256))) blocks (``wave``: the blocks of
one wave on the card), block b takes the rows [n b / nb, n (b + 1) / nb).

* K <= 32 (rows layout, 256 threads a block): thread t takes the block's
  rows t, t + 256, ...; it adds its rows' losses 16 at a time apart, then
  into its running total; each warp
  adds its 32 threads' totals by a shuffle-xor tree, and the block adds
  its 8 warps' values in warp order.
* K > 32 (lanes layout, 512 threads, one block an SM): warp w takes the
  block's rows [r0 + nr w / 16, r0 + nr (w + 1) / 16); the lane holding a
  candidate adds the warp's rows 16 at a time apart, then into its total;
  the block adds its 16 warps' totals in warp order (candidates past 320 in
  further passes: the same shape of sum for every candidate).
* Finish, by the last block: lane l adds a candidate's partials of blocks
  l, l + 32, ... in order, then a shuffle-xor tree.

The emulation follows that in numpy float32 on the plain version's own
per-row losses (the margin and the weight rounded as the kernel rounds
them), equals the same order written out with scalar loops, and must agree
with ``kernels/ref.py::alpha_search`` and with the JAX package's
``alpha_search`` (its ``backend="ref"`` route) within 1e-5 relative: a
float32 sum in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import glm as glm_lib
from repro_torch.core import linesearch
from repro_torch.kernels import alpha_search, ref

F = np.float32
# the constants of csrc/alpha_search.cu
ROWS_THREADS, LANES_THREADS, MAX_ROWS_K, MIN_ROWS = 256, 512, 32, 256
INNER = 16
H100_SMS = 132


def n_blocks(n, wave):
    return max(1, min(wave, -(-n // MIN_ROWS)))


def block_rows(n, nb):
    """Block b takes rows [edges[b], edges[b + 1])."""
    return n * np.arange(nb + 1, dtype=np.int64) // nb


def thread_rows(r0, r1, t):
    """The rows thread t of a rows-layout block over [r0, r1) takes, in
    its order: t, t + 256, ..."""
    return np.arange(r0 + t, r1, ROWS_THREADS)


def warp_rows(r0, r1, w):
    """The rows warp w of a lanes-layout block over [r0, r1) takes."""
    nr = r1 - r0
    warps = LANES_THREADS // 32
    return np.arange(r0 + nr * w // warps, r0 + nr * (w + 1) // warps)


def butterfly(v):
    """A shuffle-xor tree over the last axis (32 lanes)."""
    lanes = np.arange(v.shape[-1])
    o = v.shape[-1] // 2
    while o:
        v = v + v[..., lanes ^ o]
        o //= 2
    assert (v == v[..., :1]).all()       # every lane holds the sum
    return v[..., 0]


def run_total(Lr):
    """Sums (K, m) rows in order, INNER rows apart, then into the total."""
    K, m = Lr.shape
    tot = np.zeros(K, F)
    for g in range(0, m, INNER):
        part = np.zeros(K, F)
        for j in range(g, min(g + INNER, m)):
            part = part + Lr[:, j]
        tot = tot + part
    return tot


def row_losses(y, xb, xdb, w, alphas, family, offset):
    """(K, n) c_i l(y_i, b_i + alpha_k xdb_i) in float32, each step
    rounded as the kernel rounds it, from the plain version's loss."""
    t = torch.from_numpy
    base = t(xb) if offset is None else t(xb) + t(offset)
    m = base[None, :] + t(alphas)[:, None] * t(xdb)[None, :]
    loss, _, _ = glm_lib.resolve_family(family).stats(t(y)[None, :], m)
    return (loss * t(w)[None, :]).numpy()


def emulate(L, wave):
    """K4's losses from the per-row losses L (K, n), in its order."""
    K, n = L.shape
    rows_layout = K <= MAX_ROWS_K
    nb = n_blocks(n, wave)
    edges = block_rows(n, nb)
    partials = np.zeros((K, nb), F)
    for b in range(nb):
        r0, r1 = int(edges[b]), int(edges[b + 1])
        if rows_layout:
            tots = np.stack([run_total(L[:, thread_rows(r0, r1, t)])
                             for t in range(ROWS_THREADS)], axis=1)
            warps = butterfly(tots.reshape(K, ROWS_THREADS // 32, 32))
        else:
            warps = np.stack([run_total(L[:, warp_rows(r0, r1, w)])
                              for w in range(LANES_THREADS // 32)], axis=1)
        s = np.zeros(K, F)
        for w in range(warps.shape[1]):
            s = s + warps[:, w]
        partials[:, b] = s
    lanes = np.zeros((K, 32), F)
    for b in range(nb):
        lanes[:, b % 32] = lanes[:, b % 32] + partials[:, b]
    return butterfly(lanes)


def emulate_scalar(L, wave):
    """The same order with scalar float32 loops, one candidate at a time."""
    K, n = L.shape
    rows_layout = K <= MAX_ROWS_K
    nb = n_blocks(n, wave)
    out = np.zeros(K, F)
    for k in range(K):
        partial = []
        for b in range(nb):
            r0, r1 = n * b // nb, n * (b + 1) // nb
            owners = []        # each thread's or warp's rows, in order
            if rows_layout:
                for t in range(ROWS_THREADS):
                    owners.append(list(range(r0 + t, r1, ROWS_THREADS)))
            else:
                nr = r1 - r0
                for w in range(16):
                    owners.append(list(range(r0 + nr * w // 16,
                                             r0 + nr * (w + 1) // 16)))
            tots = []
            for rows in owners:
                tot, part = F(0), F(0)
                for j, i in enumerate(rows):
                    part = F(part + L[k, i])
                    if (j + 1) % INNER == 0:
                        tot, part = F(tot + part), F(0)
                tots.append(F(tot + part))
            if rows_layout:
                vals = []
                for w in range(8):
                    v = tots[32 * w:32 * w + 32]
                    for o in (16, 8, 4, 2, 1):
                        v = [F(v[i] + v[i ^ o]) for i in range(32)]
                    vals.append(v[0])
            else:
                vals = tots
            s = F(0)
            for v in vals:
                s = F(s + v)
            partial.append(s)
        lanes = [F(0)] * 32
        for b, v in enumerate(partial):
            lanes[b % 32] = F(lanes[b % 32] + v)
        for o in (16, 8, 4, 2, 1):
            lanes = [F(lanes[i] + lanes[i ^ o]) for i in range(32)]
        out[k] = lanes[0]
    return out


def _inputs(rng, n, K, family, offset=True):
    y = (rng.poisson(2.0, n) if family == "poisson"
         else rng.choice([-1.0, 1.0], n)).astype(F)
    xb = (1.5 * rng.normal(size=n)).astype(F)
    xdb = rng.normal(size=n).astype(F)
    w = rng.random(n).astype(F)
    w[::7] = 0.0
    off = (0.1 * rng.normal(size=n)).astype(F) if offset else None
    if K == 294:
        alphas = linesearch.full_candidates(1e-3, 13, 0.5, 20,
                                            device="cpu").numpy()
    else:
        alphas = rng.uniform(0.0, 1.5, K).astype(F)
    return y, xb, xdb, w, off, alphas


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


@pytest.mark.parametrize("n", [1, 5, 255, 256, 257, 1023, 33_793, 70_001,
                               131_072, 400_000])
@pytest.mark.parametrize("wave", [H100_SMS, 2 * H100_SMS, 4 * 114])
def test_blocks_threads_and_warps_cover_every_row_once(n, wave):
    """Index arithmetic only: the blocks tile [0, n) in contiguous ranges,
    each non-empty, at most one block per 256 rows, their sizes within one
    row of each other; each block's threads (rows layout) and warps (lanes
    layout) take each of its rows once, a thread's rows in rising order."""
    nb = n_blocks(n, wave)
    assert 1 <= nb <= min(wave, -(-n // MIN_ROWS))
    edges = block_rows(n, nb)
    assert edges[0] == 0 and edges[-1] == n
    sizes = np.diff(edges)
    assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1
    for b in {0, nb // 2, nb - 1}:
        r0, r1 = int(edges[b]), int(edges[b + 1])
        by_t = [thread_rows(r0, r1, t) for t in range(ROWS_THREADS)]
        rows = np.concatenate(by_t)
        assert np.array_equal(np.sort(rows), np.arange(r0, r1))
        for r in by_t:
            assert (np.diff(r) == ROWS_THREADS).all()
        rows = np.concatenate([warp_rows(r0, r1, w) for w in range(16)])
        assert np.array_equal(rows, np.arange(r0, r1))


@pytest.mark.parametrize("K", [3, 40])
@pytest.mark.parametrize("n,wave", [(3_001, H100_SMS), (9_000, 4)])
def test_emulation_is_the_order_written_out(n, wave, K):
    """The vectorized emulation gives the bits of the same order written
    with scalar loops: both layouts, blocks of uneven sizes, blocks near
    their 256-row minimum and, at wave 4, blocks of many rows a thread."""
    rng = np.random.default_rng(n + K)
    y, xb, xdb, w, off, alphas = _inputs(rng, n, K, "logistic")
    L = row_losses(y, xb, xdb, w, alphas, "logistic", off)
    assert np.array_equal(emulate(L, wave), emulate_scalar(L, wave))


CASES = {
    # (n, K, wave, offset): the Gauss-Seidel grid and chain, the lanes
    # layout, every candidate of the fused superstep, past one 320 pass;
    # one block; n neither a multiple of 4 nor of 256
    "K14": (20_000, 14, 2 * H100_SMS, True),
    "K20": (20_000, 20, H100_SMS, True),
    "K40": (20_000, 40, H100_SMS, True),
    "K294": (20_000, 294, H100_SMS, True),
    "K330": (20_000, 330, H100_SMS, False),
    "one_block": (200, 21, H100_SMS, True),
    "n_ragged": (20_003, 20, 4 * 114, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_order_matches_plain(case):
    n, K, wave, offset = CASES[case]
    rng = np.random.default_rng(3)
    y, xb, xdb, w, off, alphas = _inputs(rng, n, K, "logistic", offset)
    got = emulate(row_losses(y, xb, xdb, w, alphas, "logistic", off), wave)
    t = torch.from_numpy
    want = ref.alpha_search(t(y), t(xb), t(xdb), t(w), t(alphas),
                            "logistic",
                            offset=None if off is None else t(off))
    assert _rel(got, want.numpy()) <= 1e-5


@pytest.mark.parametrize("family", ["logistic", "squared", "probit",
                                    "poisson"])
@pytest.mark.parametrize("K", [14, 40, 294])
def test_order_matches_plain_and_jax(family, K):
    n = 20_000
    rng = np.random.default_rng(K)
    y, xb, xdb, w, off, alphas = _inputs(rng, n, K, family)
    got = emulate(row_losses(y, xb, xdb, w, alphas, family, off),
                  2 * H100_SMS)
    t = torch.from_numpy
    want = ref.alpha_search(t(y), t(xb), t(xdb), t(w), t(alphas), family,
                            offset=t(off)).numpy()
    jwant = np.asarray(jops.alpha_search(
        jnp.asarray(y), jnp.asarray(xb), jnp.asarray(xdb),
        jnp.asarray(alphas), family, weights=jnp.asarray(w),
        offset=jnp.asarray(off), backend="ref"))
    assert _rel(got, want) <= 1e-5
    assert _rel(got, jwant) <= 1e-5
    assert _rel(want, jwant) <= 1e-5


def test_wrapper_refuses_cpu_tensors():
    """No fall back: the wrapper takes CUDA tensors or raises (the CPU
    runs the plain version through ``kernels/ops.py``)."""
    v = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        alpha_search.launch(v, v, v, v, torch.ones(3), "logistic")
