"""Host side of the weighted-Gram core ``csrc/gram_tc.cuh``, shared by K3
(``tile_gram``) and K5 (``stats_gram_solve``): the block edge for a tile
width, and how many ranges the rows are cut into.
"""
from __future__ import annotations

import torch

SLAB = 32               # rows a slab (kSlab in gram_tc.cuh)
# rows of one range: the core drains its accumulators every 128 rows into a
# register sum, which then takes at most 32 terms
MAX_RANGE_ROWS = 4096


def band(T: int) -> int:
    """Edge of the blocks of G one CUDA block owns: 128 where it divides
    T, else 64."""
    return 128 if T % 128 == 0 else 64


def n_pairs(T: int) -> int:
    """Upper-triangle blocks (bi <= bj) of a T x T Gram block."""
    nb = T // band(T)
    return nb * (nb + 1) // 2


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ranges(units: int, blocks_per_range: int, max_units: int,
           sms: int) -> int:
    """How many ranges to cut ``units`` (slabs or rows) into: enough that no
    range holds more than ``max_units``, and enough that every SM gets a
    block (one block fills an SM), never more than ``units``."""
    need = -(-units // max(max_units, 1))
    fill = -(-sms // max(blocks_per_range, 1))
    return max(1, min(units, max(need, fill)))
