"""Carry packed designs and fit states across from numpy arrays.

The JAX package's designs and fit states are pytrees of arrays; their numpy
leaves rebuild the same objects here, so both packages can be fed the very
same packed data and the very same iterate (the parity tests do so).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dglmnet import FitState
from repro_torch.data.design import BlockSparseDesign, DenseDesign


def _t(a, dtype, device):
    return torch.from_numpy(np.array(a, dtype)).to(device)


def design_from_numpy(*, tile_size: int, data=None, bricks=None,
                      brick_row=None, brick_tile=None, tile_ptr=None,
                      row_block=None, n_rows=None, device="cpu"):
    """A ``DenseDesign`` from ``data`` (n, p_pad), or a ``BlockSparseDesign``
    from the brick leaves (``bricks``, ``brick_row``, ``brick_tile``,
    ``tile_ptr``) and the static geometry (``row_block``, ``n_rows``)."""
    if data is not None:
        data = np.asarray(data, np.float32)
        if data.shape[1] % tile_size:
            raise ValueError("dense data must be padded to a tile multiple")
        return DenseDesign(_t(data, np.float32, device), tile_size)
    tile_ptr = np.asarray(tile_ptr, np.int32)
    bricks = np.asarray(bricks, np.float32)
    if bricks.shape[1:] != (row_block, tile_size) or n_rows % row_block:
        raise ValueError(
            f"bricks {bricks.shape} do not match row_block={row_block}, "
            f"tile_size={tile_size}, n_rows={n_rows}")
    K = max(int(np.diff(tile_ptr).max(initial=0)), 1)
    return BlockSparseDesign(
        _t(bricks, np.float32, device), _t(brick_row, np.int32, device),
        _t(brick_tile, np.int32, device), tile_ptr, tile_size, row_block,
        int(n_rows), len(tile_ptr) - 1, K)


def state_from_numpy(beta, xb, mu, cursor=0, step=0, *, device="cpu"):
    """A ``FitState`` from (beta, X beta, mu, cursor, step) host values;
    ``cursor`` may be the JAX state's (1,) per-shard array."""
    return FitState(
        beta=_t(beta, np.float32, device), xb=_t(xb, np.float32, device),
        mu=_t(np.asarray(mu, np.float32).reshape(()), np.float32, device),
        cursor=int(np.asarray(cursor).reshape(-1)[0]), step=int(step))
