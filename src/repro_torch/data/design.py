"""Design-matrix layouts and the operators the coordinate-descent sweep uses.

Mirrors the single-device part of ``repro.data.design``.  The solver touches
the design matrix only through these operators:

  * ``tile_gram(tid, w, r)``: G = X_t^T diag(w) X_t (T, T) and g = X_t^T r
    for feature tile ``tid``;
  * ``tile_matvec(tid, v_t)``: X_t v_t over all rows;
  * ``matvec(v)`` / ``rmatvec(r)``: X v and X^T r in packed column order.

Two layouts:

  * ``DenseDesign``: an (n, p_pad) tensor with zero padding columns.  Its
    tile Gram is a plain matrix product (``torch.matmul``), as the JAX
    package leaves it to XLA.
  * ``BlockSparseDesign``: CSR-of-bricks.  The matrix is cut into
    (row_block x tile_size) bricks; only non-empty bricks are stored,
    tile-major, with a CSR ``tile_ptr`` over feature tiles.  The tile Gram
    is the ``tile_gram`` kernel reading the tile's bricks in place.  The CSR
    offsets stay on the host, so every slice bound is a host integer and
    the sweep never waits on the card for one.

``build_block_sparse`` packs a ``SparseCOO`` exactly as the JAX builder
does (features sorted by frequency, so hot features share tiles), computing
the layout's index arrays on the host and scattering the values straight
into bricks on the target device; the dense (n, p) matrix is never formed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.data.sparse import SparseCOO
from repro_torch.kernels import ops


class DesignMatrix:
    """Operator interface of the sweeps; ``shape`` is the padded
    ``(n_rows, n_tiles * tile_size)``."""

    tile_size: int

    @property
    def shape(self):
        raise NotImplementedError

    @property
    def n_tiles(self) -> int:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def tile_gram(self, tid: int, w, r):
        raise NotImplementedError

    def tile_matvec(self, tid: int, v_t):
        raise NotImplementedError

    def matvec(self, v):
        raise NotImplementedError

    def rmatvec(self, r):
        raise NotImplementedError

    def to_dense(self):
        raise NotImplementedError


@dataclasses.dataclass
class DenseDesign(DesignMatrix):
    """Feature-padded dense design: ``data`` is (n_rows, n_tiles * T)."""

    data: torch.Tensor
    tile_size: int

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def n_tiles(self) -> int:
        return self.data.shape[1] // self.tile_size

    @property
    def device(self) -> torch.device:
        return self.data.device

    def _tile(self, tid: int):
        c0 = tid * self.tile_size
        return self.data[:, c0:c0 + self.tile_size]

    def tile_gram(self, tid: int, w, r):
        Xt = self._tile(tid)
        return (Xt * w[:, None]).T @ Xt, Xt.T @ r

    def tile_matvec(self, tid: int, v_t):
        return self._tile(tid) @ v_t

    def matvec(self, v):
        return self.data @ v

    def rmatvec(self, r):
        return self.data.T @ r

    def to_dense(self):
        return self.data


@dataclasses.dataclass
class BlockSparseDesign(DesignMatrix):
    """CSR-of-bricks blocked densification of a sparse design matrix.

      bricks     (B, row_block, tile_size) f32: non-empty bricks, tile-major
      brick_row  (B,) int32: row-block index of each brick
      brick_tile (B,) int32: feature-tile index of each brick
      tile_ptr   (n_tiles + 1,) int32 numpy, on the host: bricks of tile t
                 are [tile_ptr[t], tile_ptr[t + 1])

    ``n_rows`` is a multiple of ``row_block``; ``max_bricks_per_tile`` is
    the largest tile population (K).
    """

    bricks: torch.Tensor
    brick_row: torch.Tensor
    brick_tile: torch.Tensor
    tile_ptr: np.ndarray
    tile_size: int
    row_block: int
    n_rows: int
    n_tiles_: int
    max_bricks_per_tile: int

    @property
    def shape(self):
        return (self.n_rows, self.n_tiles_ * self.tile_size)

    @property
    def n_tiles(self) -> int:
        return self.n_tiles_

    @property
    def n_row_blocks(self) -> int:
        return self.n_rows // self.row_block

    @property
    def device(self) -> torch.device:
        return self.bricks.device

    def tile_bricks(self, tid: int):
        """(bricks (K_t, rb, T), rows (K_t,)) of tile ``tid``: views into the
        brick arrays, no copy."""
        start = int(self.tile_ptr[tid])
        stop = int(self.tile_ptr[tid + 1])
        return self.bricks[start:stop], self.brick_row[start:stop]

    def tile_gram(self, tid: int, w, r):
        tb, rows = self.tile_bricks(tid)
        return ops.tile_gram(tb, rows, tb.shape[0], w, r)

    def tile_matvec(self, tid: int, v_t):
        tb, rows = self.tile_bricks(tid)
        out = torch.zeros((self.n_row_blocks, self.row_block),
                          dtype=v_t.dtype, device=v_t.device)
        # a tile holds at most one brick per row block, so the indices are
        # distinct and the add is exact and order-free
        out.index_add_(0, rows.long(), tb @ v_t)
        return out.reshape(-1)

    def matvec(self, v):
        T = self.tile_size
        out = torch.zeros(self.n_rows, dtype=v.dtype, device=v.device)
        for tid in range(self.n_tiles_):
            out += self.tile_matvec(tid, v[tid * T:(tid + 1) * T])
        return out

    def rmatvec(self, r):
        r2 = r.reshape(self.n_row_blocks, self.row_block)
        parts = []
        for tid in range(self.n_tiles_):
            tb, rows = self.tile_bricks(tid)
            parts.append(torch.einsum("kit,ki->t", tb, r2[rows.long()]))
        return torch.cat(parts)

    def to_dense(self):
        rb, T = self.row_block, self.tile_size
        out = torch.zeros((self.n_row_blocks, rb, self.n_tiles_, T),
                          dtype=self.bricks.dtype, device=self.device)
        # (row block, tile) pairs are unique, so assignment places each brick
        out[self.brick_row.long(), :, self.brick_tile.long(), :] = self.bricks
        return out.reshape(self.n_rows, self.n_tiles_ * T)


# ---------------------------------------------------------------------------
# host-side builders
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DesignInfo:
    """What the solver needs to map results back to the caller's features.

    col_of_feature[j] = packed column of original feature j (None when the
    layout is the identity); ``occupancy`` is the non-empty-brick fraction.
    """
    shape: tuple
    col_of_feature: Optional[np.ndarray] = None
    occupancy: float = 1.0
    n_bricks: int = 0

    def unpack_beta(self, beta_packed: np.ndarray) -> np.ndarray:
        p = self.shape[1]
        if self.col_of_feature is None:
            return np.asarray(beta_packed)[:p]
        return np.asarray(beta_packed)[self.col_of_feature]

    def pack_beta(self, beta: np.ndarray, p_padded: int) -> np.ndarray:
        return self.pack_cols(beta, p_padded, fill=0.0)

    def pack_cols(self, values: np.ndarray, p_padded: int,
                  fill: float = 0.0) -> np.ndarray:
        """Scatter a per-feature vector into packed column order; padding
        columns get ``fill`` (0 for beta, 1 for penalty factors)."""
        out = np.full((p_padded,), fill, np.float32)
        if self.col_of_feature is None:
            out[:len(values)] = values
        else:
            out[self.col_of_feature] = values
        return out


def _pack_layout(coo: SparseCOO, M: int, tile_size: int, reorder: bool):
    """Global column layout: frequency-sort features into tiles, then deal
    whole tiles round-robin over M feature shards (M = 1 on one device).

    Returns (col_of_feature (p,), p_loc)."""
    p = coo.shape[1]
    p_pad = p + ((-p) % (M * tile_size))
    p_loc = p_pad // M
    freq = coo.col_frequency_order() if reorder else np.arange(p)
    # freq[c] = original feature at frequency rank c
    rank_of = np.empty(p, np.int64)
    rank_of[freq] = np.arange(p)
    ranks = np.arange(p_pad, dtype=np.int64)
    tile_g = ranks // tile_size
    pos = (tile_g % M) * p_loc + (tile_g // M) * tile_size + ranks % tile_size
    col_of_feature = pos[rank_of]
    return col_of_feature.astype(np.int64), p_loc


def _brick_index(rows, cols, n_loc, p_loc, tile_size, row_block):
    """Index arrays of the brick packing of one shard's COO triplets.

    Returns (order, brick_of_nnz, brick_row, brick_tile, tile_ptr, n_bricks):
    the nonzero ``order[i]`` goes to brick ``brick_of_nnz[i]`` at (row %
    row_block, col % tile_size) of the sorted triplets.
    """
    n_rb = n_loc // row_block
    n_tiles = p_loc // tile_size
    key = (cols // tile_size).astype(np.int64) * n_rb + rows // row_block
    order = np.argsort(key, kind="stable")
    ukeys, inv = np.unique(key[order], return_inverse=True)
    brick_tile = (ukeys // n_rb).astype(np.int32)
    brick_row = (ukeys % n_rb).astype(np.int32)
    if not len(ukeys):
        brick_tile = np.zeros((1,), np.int32)
        brick_row = np.zeros((1,), np.int32)
    tile_ptr = np.searchsorted(brick_tile, np.arange(n_tiles + 1)) \
        .astype(np.int32)
    if not len(ukeys):
        tile_ptr[:] = 0
    return order, inv, brick_row, brick_tile, tile_ptr, len(ukeys)


def build_block_sparse(coo: SparseCOO, tile_size: int, *,
                       row_block: int = 256, reorder: bool = True,
                       device="cpu"):
    """Pack a host SparseCOO into the brick layout on ``device``.

    Returns (BlockSparseDesign, DesignInfo).  The packing (column order,
    brick order, CSR offsets) is the JAX builder's, so beta can be compared
    index by index.
    """
    coo = coo.dedupe()
    n, p = coo.shape
    col_of_feature, p_loc = _pack_layout(coo, 1, tile_size, reorder)
    n_loc = -(-n // row_block) * row_block
    n_tiles = p_loc // tile_size
    rows = np.asarray(coo.rows, np.int64)
    cols = col_of_feature[coo.cols]
    order, inv, brick_row, brick_tile, tile_ptr, n_bricks = _brick_index(
        rows, cols, n_loc, p_loc, tile_size, row_block)
    device = torch.device(device)
    bricks = torch.zeros((max(n_bricks, 1), row_block, tile_size),
                         dtype=torch.float32, device=device)
    if n_bricks:
        rows, cols = rows[order], cols[order]

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        bricks.index_put_(
            (put(inv.astype(np.int64)), put(rows % row_block),
             put(cols % tile_size)),
            put(np.asarray(coo.vals, np.float32)[order]))
    K = max(int(np.diff(tile_ptr).max(initial=0)), 1)
    design = BlockSparseDesign(
        bricks, torch.from_numpy(brick_row).to(device),
        torch.from_numpy(brick_tile).to(device), tile_ptr,
        tile_size, row_block, n_loc, n_tiles, K)
    occ = n_bricks / max((n_loc // row_block) * n_tiles, 1)
    info = DesignInfo(shape=(n, p), col_of_feature=col_of_feature,
                      occupancy=occ, n_bricks=n_bricks)
    return design, info


def dense_design(X, tile_size: int, *, device="cpu"):
    """(DenseDesign, DesignInfo) from an (n, p) array; features are padded
    with zero columns to a tile multiple on the device itself."""
    X = np.asarray(X, np.float32)
    n, p = X.shape
    data = torch.zeros((n, p + (-p) % tile_size), dtype=torch.float32,
                       device=device)
    data[:, :p] = torch.from_numpy(X).to(device)
    return DenseDesign(data, tile_size), DesignInfo(shape=(n, p))


def as_design(X, tile_size: int, *, row_block: int = 256,
              reorder: bool = True, info: Optional[DesignInfo] = None,
              device="cpu"):
    """Coerce a dense array, a SparseCOO or a pre-built design into
    (DesignMatrix, DesignInfo).  A pre-built design must come with the
    DesignInfo of its builder, which maps beta back to feature order."""
    if isinstance(X, DesignMatrix):
        if info is None:
            raise ValueError(
                "pre-built designs require the DesignInfo returned by their "
                "builder (pass design_info=...) so beta can be mapped back "
                "to the original feature order")
        if X.tile_size != tile_size:
            raise ValueError(f"design tile_size {X.tile_size} != {tile_size}")
        if X.device.type != torch.device(device).type:
            raise ValueError(f"design lives on {X.device}, not {device}")
        return X, info
    if isinstance(X, SparseCOO):
        return build_block_sparse(X, tile_size, row_block=row_block,
                                  reorder=reorder, device=device)
    return dense_design(X, tile_size, device=device)
