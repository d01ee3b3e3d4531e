"""The 3xTF32 split of K3 and K5 (``kernels/csrc/gram_tc.cuh``), emulated
on the CPU.

The kernels form G = X^T diag(w) X on the tensor cores from TF32 operands:
each operand a (A = w x, B = x) is split once into hi = tf32(a) and
lo = tf32(a - hi), where tf32 rounds the low 13 mantissa bits to nearest
(ties away from zero, as ``cvt.rna.tf32.f32`` does), and G accumulates
lo*hi + hi*lo + hi*hi in float32.  The emulation below follows the kernel's
order: 8-row k steps, the three products of a step added in turn to an
accumulator that restarts every 4 slabs of 32 rows (128 rows) and is then
added to a second float32 sum; row ranges of ``gram_tc.MAX_RANGE_ROWS``
rows are summed last, in order, as the reduce pass does.

Not modelled: how the tensor cores round inside one k step, and the order
in which they add its 8 products; only the card's phase of
``chip_smoke.py`` (G within 1e-5 of float64 sums) and the ``gpu`` tests
see those.

The inputs stress the sums: a 12,500-row range, an intercept column, a
feature of a few repeated values (a quantized or hashed feature, whose
TF32 rounding error does not average out) and logistic weights spread
over 1e-6 to 0.25.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gram_tc

N_ROWS = 12_500
T = 16
K_STEP = 8
CHUNK = 4 * gram_tc.SLAB


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 explicit mantissa bits): to nearest on the
    low 13 bits, ties away from zero, as cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    # adding half a TF32 ulp to the magnitude bits carries into the kept
    # bits exactly when the dropped ones are at least half
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N_ROWS, T)).astype(np.float32)
    X[:, 0] = 1.0                                    # intercept
    X[:, 1] = rng.integers(0, 4, N_ROWS) / np.float32(3.0)   # 0, 1/3, ...
    w = np.exp(rng.uniform(np.log(1e-6), np.log(0.25), N_ROWS))
    return torch.from_numpy(X), torch.from_numpy(w.astype(np.float32))


def gram64(X, w):
    Xd = X.double()
    return (Xd * w.double()[:, None]).T @ Xd


def gram_emulated(X, w, products):
    """G as the kernel sums it; ``products(A, B)`` gives the float32 terms
    of one k step (A = w x and B = x over its 8 rows)."""
    A = X * w[:, None]                     # the A side, rounded in float32
    G = torch.zeros(T, T)
    for r0 in range(0, X.shape[0], gram_tc.MAX_RANGE_ROWS):
        tot = torch.zeros(T, T)            # second level: the range
        r1 = min(r0 + gram_tc.MAX_RANGE_ROWS, X.shape[0])
        for c0 in range(r0, r1, CHUNK):
            acc = torch.zeros(T, T)        # first level: 128 rows
            for k0 in range(c0, min(c0 + CHUNK, r1), K_STEP):
                for term in products(A[k0:k0 + K_STEP], X[k0:k0 + K_STEP]):
                    acc = acc + term
            tot = tot + acc
        G = G + tot                        # third level: the reduce pass
    return G


def split3(A, B):
    a_hi, b_hi = tf32(A), tf32(B)
    a_lo, b_lo = tf32(A - a_hi), tf32(B - b_hi)
    return a_lo.T @ b_hi, a_hi.T @ b_lo, a_hi.T @ b_hi


def single(A, B):
    return (tf32(A).T @ tf32(B),)


def rel_err(G, G64):
    return float((G.double() - G64).abs().max() / G64.abs().max())


def test_tf32_rounds_to_nearest_on_the_low_13_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 3 * 2.0 ** -12), 1.0 + 2.0 ** -12,
                      1.0 / 3.0, 0.0, 3.0e-39])
    got = tf32(x)
    assert torch.equal(got.view(torch.int32) & 0x1FFF,
                       torch.zeros(8, dtype=torch.int32))
    # 1 + 3 * 2^-12 is past the midpoint between 1 and 1 + 2^-10; the tie
    # 1 + 2^-11 rounds away from zero, as does its negative twin
    want = [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
            1.0]
    assert got[:5].tolist() == want
    rel = float(((got[5] - x[5]) / x[5]).abs())
    assert 0 < rel <= 2.0 ** -11
    assert float(got[6]) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_split_keeps_hi_plus_lo_to_22_bits(seed):
    X, w = inputs(seed)
    A = X * w[:, None]
    for a in (A, X):
        hi = tf32(a)
        lo = tf32(a - hi)
        err = ((hi.double() + lo.double()) - a.double()).abs()
        assert bool((err <= 2.0 ** -22 * a.double().abs()).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_holds_G_within_1e_6_of_float64(seed):
    X, w = inputs(seed)
    G64 = gram64(X, w)
    assert rel_err(gram_emulated(X, w, split3), G64) <= 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_a_single_tf32_product_misses_1e_5(seed):
    """Why the split: one TF32 product of the same operands, summed the
    same way, is off float64 by more than the 1e-5 bar."""
    X, w = inputs(seed)
    G64 = gram64(X, w)
    assert rel_err(gram_emulated(X, w, single), G64) > 1e-5
