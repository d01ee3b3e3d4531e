"""Host-side sparse design container (numpy only).

A copy of ``repro.data.sparse`` so the port imports nothing of the JAX
package: ``SparseCOO``, an exact COO matrix with matvec/rmatvec, row
selection, deduplication, column permutation and the feature-frequency
order that the brick packing sorts by (``data/design.py``); and
``to_dense_blocks``, the frequency-sorted dense tiling with its brick
occupancy.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SparseCOO:
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    shape: tuple

    def dedupe(self) -> "SparseCOO":
        """Sum duplicate (row, col) entries."""
        key = self.rows.astype(np.int64) * self.shape[1] + self.cols
        order = np.argsort(key, kind="stable")
        key, rows, cols, vals = key[order], self.rows[order], \
            self.cols[order], self.vals[order]
        _, start = np.unique(key, return_index=True)
        sums = np.add.reduceat(vals, start)
        return SparseCOO(rows[start], cols[start],
                         sums.astype(self.vals.dtype), self.shape)

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    def matvec(self, beta: np.ndarray) -> np.ndarray:
        out = np.zeros(self.shape[0], np.float64)
        np.add.at(out, self.rows, self.vals * beta[self.cols])
        return out.astype(np.float32)

    def rmatvec(self, v: np.ndarray) -> np.ndarray:
        out = np.zeros(self.shape[1], np.float64)
        np.add.at(out, self.cols, self.vals * v[self.rows])
        return out.astype(np.float32)

    def take_rows(self, idx: np.ndarray) -> "SparseCOO":
        remap = -np.ones(self.shape[0], np.int64)
        remap[idx] = np.arange(len(idx))
        keep = remap[self.rows] >= 0
        return SparseCOO(remap[self.rows[keep]], self.cols[keep],
                         self.vals[keep], (len(idx), self.shape[1]))

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, np.float32)
        out[self.rows, self.cols] = self.vals
        return out

    def col_frequency_order(self) -> np.ndarray:
        """Feature permutation, most frequent first: packing hot features
        into the same tiles maximizes brick occupancy."""
        counts = np.bincount(self.cols, minlength=self.shape[1])
        return np.argsort(-counts, kind="stable")

    def permute_cols(self, perm: np.ndarray) -> "SparseCOO":
        """The matrix with column ``perm[k]`` moved to position k."""
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        return SparseCOO(self.rows, inv[self.cols], self.vals, self.shape)


def to_dense_blocks(X: SparseCOO, tile_size: int, *, reorder: bool = True):
    """Densify into the feature-tiled layout of the CD sweep.

    Returns (dense (n, p_pad) float32, perm, occupancy): columns in ``perm``
    order (most frequent first with ``reorder``), padded to a multiple of
    ``tile_size``, and the share of (256-row block x tile) bricks that
    hold at least one nonzero.
    """
    perm = X.col_frequency_order() if reorder else np.arange(X.shape[1])
    Xp = X.permute_cols(perm)
    p_pad = X.shape[1] + ((-X.shape[1]) % tile_size)
    dense = np.zeros((X.shape[0], p_pad), np.float32)
    dense[Xp.rows, Xp.cols] = Xp.vals
    rb = 256
    n_rb = (X.shape[0] + rb - 1) // rb
    n_tb = p_pad // tile_size
    brick = np.zeros((n_rb, n_tb), bool)
    brick[Xp.rows // rb, Xp.cols // tile_size] = True
    occupancy = float(brick.mean())
    return dense, perm, occupancy
