"""Signed feature hashing into a fixed, tile-aligned feature space (a
copy of ``repro.io.hashing``; numpy only).

Feature key ``k`` with value ``v`` adds ``sign(k) * v`` to column
``bucket(k)`` of a fixed ``n_features``-wide space (Weinberger et al.
2009), so an unbounded vocabulary needs no vocabulary pass; collisions are
signed sums and inner products stay unbiased.

  * the hash is splitmix64 / FNV-1a over the key bytes, never Python's
    salted ``hash``: every process and every resumed run maps a token to
    the same column, and the JAX package maps it to the same column and
    sign, bit for bit;
  * ``n_features`` is rounded up to a multiple of ``tile_size * n_shards``,
    so hashed chunks drop into the tile layouts with no remap.

``expand_interactions`` adds hashed crosses of the keys of a row (values
multiplied), in a salt space of their own; no cross is stored on disk.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)
_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer — a full-avalanche 64-bit mix
    (Steele et al.), the integer-key workhorse behind the hasher."""
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK64
        x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
            & _MASK64
        x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
            & _MASK64
        return x ^ (x >> np.uint64(31))


def fnv1a64(data: bytes) -> int:
    """FNV-1a over raw bytes — the stable string-key hash (Python's
    ``hash(str)`` is salted per process and would break cross-process
    column agreement)."""
    h = int(_FNV_OFFSET)
    for b in data:
        h = ((h ^ b) * int(_FNV_PRIME)) & 0xFFFFFFFFFFFFFFFF
    return h


class FeatureHasher:
    """Signed hash of feature keys into ``n_features`` tile-aligned buckets.

    ``n_features`` is rounded up to a multiple of ``tile_size * n_shards``
    (both optional) and exposed as the ``n_features`` attribute — build
    the downstream design from that.  ``seed`` salts the whole map;
    ``field`` salts per key-namespace (e.g. raw features vs interaction
    crosses live in disjoint salt spaces even when their integer keys
    collide).
    """

    def __init__(self, n_features: int, *, tile_size: Optional[int] = None,
                 n_shards: int = 1, seed: int = 0):
        if n_features <= 0:
            raise ValueError("n_features must be positive")
        align = (tile_size or 1) * max(int(n_shards), 1)
        self.n_features = int(n_features) + (-int(n_features)) % align
        self.tile_size = tile_size
        self.seed = int(seed)
        self._salt = splitmix64(
            np.asarray([self.seed], np.uint64))[0]

    # ------------------------------------------------------------- hashing

    def _mix(self, keys: np.ndarray, field: int) -> np.ndarray:
        field_salt = splitmix64(
            np.asarray([field ^ 0x5851F42D], np.uint64))[0]
        with np.errstate(over="ignore"):
            return splitmix64(
                (np.asarray(keys, np.uint64) ^ self._salt) + field_salt)

    def hash_indices(self, keys, field: int = 0):
        """(cols (m,) int64, signs (m,) float32) for integer feature keys.

        The top hash bit gives the ±1 sign; the rest pick the bucket —
        sign and bucket are independent, which the unbiasedness argument
        needs.
        """
        h = self._mix(np.asarray(keys, np.uint64), field)
        cols = (h % np.uint64(self.n_features)).astype(np.int64)
        signs = np.where((h >> np.uint64(63)).astype(bool),
                         np.float32(1.0), np.float32(-1.0))
        return cols, signs

    def hash_tokens(self, tokens: Sequence[str], field: int = 0):
        """(cols, signs) for string tokens — FNV-1a bytes → splitmix mix,
        stable across processes and Python versions."""
        keys = np.asarray(
            [fnv1a64(t.encode("utf-8")) for t in tokens], np.uint64)
        return self.hash_indices(keys, field)

    # -------------------------------------------------------- chunk mapping

    def transform_chunk(self, cols: np.ndarray, vals: np.ndarray,
                        *, field: int = 0,
                        interactions: int = 0) -> np.ndarray:
        """Dense hashed chunk from fixed-shape padded sparse rows.

        ``cols``/``vals`` are ``(rows, width)`` with padding marked by
        ``cols < 0`` (the reader chunk layout).  Returns the dense
        ``(rows, n_features)`` float32 chunk: each valid entry adds
        ``sign * val`` into its bucket; with ``interactions=k > 0`` every
        unordered pair among the first ``k`` valid keys of each row adds
        a hashed cross (value = product) on top.
        """
        cols = np.asarray(cols)
        vals = np.asarray(vals, np.float32)
        rows, width = cols.shape
        out = np.zeros((rows, self.n_features), np.float32)
        valid = cols >= 0
        r_idx, c_idx = np.nonzero(valid)
        if len(r_idx):
            hcols, signs = self.hash_indices(
                cols[r_idx, c_idx].astype(np.uint64), field)
            np.add.at(out, (r_idx, hcols), signs * vals[r_idx, c_idx])
        if interactions > 0:
            ic, iv = expand_interactions(cols, vals, self,
                                         max_keys=interactions)
            ir, ij = np.nonzero(ic >= 0)
            if len(ir):
                np.add.at(out, (ir, ic[ir, ij]), iv[ir, ij])
        return out


def expand_interactions(cols: np.ndarray, vals: np.ndarray,
                        hasher: FeatureHasher, *, max_keys: int = 8,
                        field: int = 1):
    """Hashed unordered feature crosses for every row of a padded sparse
    chunk.

    For each row, the first ``max_keys`` valid raw keys generate all
    ``C(k, 2)`` pairs; pair ``(a, b)`` (order-normalized so ``a ≤ b``)
    hashes — in salt space ``field``, disjoint from the raw features — to
    a signed bucket with value ``v_a · v_b``.  Returns ``(icols, ivals)``
    of shape ``(rows, C(max_keys, 2))`` with ``icols < 0`` marking
    padding, i.e. the same fixed-shape sparse chunk layout as the input.
    """
    cols = np.asarray(cols)
    vals = np.asarray(vals, np.float32)
    rows = cols.shape[0]
    k = min(int(max_keys), cols.shape[1])
    ia, ib = np.triu_indices(k, k=1)
    n_pairs = len(ia)
    icols = np.full((rows, n_pairs), -1, np.int64)
    ivals = np.zeros((rows, n_pairs), np.float32)
    if n_pairs == 0:
        return icols, ivals
    ca, cb = cols[:, :k][:, ia], cols[:, :k][:, ib]
    va, vb = vals[:, :k][:, ia], vals[:, :k][:, ib]
    valid = (ca >= 0) & (cb >= 0)
    lo = np.minimum(ca, cb).astype(np.uint64)
    hi = np.maximum(ca, cb).astype(np.uint64)
    # injective-ish unordered pair key: mix lo before combining with hi so
    # (1, 23) and (12, 3)-style concatenation aliases cannot happen
    with np.errstate(over="ignore"):
        pair_key = splitmix64(lo) ^ (hi + np.uint64(0x9E3779B9))
    hcols, signs = hasher.hash_indices(pair_key.reshape(-1), field)
    hcols = hcols.reshape(rows, n_pairs)
    signs = signs.reshape(rows, n_pairs)
    icols[valid] = hcols[valid]
    ivals[valid] = (signs * va * vb)[valid]
    return icols, ivals
