"""K3 tile_gram: Gram block and gradient of one brick-layout feature tile.

The CUDA kernel is ``csrc/tile_gram.cu``; it replaces
``repro/kernels/tile_gram.py::tile_gram_pallas``; its products run on the
tensor cores with the 3xTF32 split of ``csrc/gram_tc.cuh``, or, in the bf16
mode (``precision="bf16"`` of the fused Jacobi superstep on bricks, which
the reference forms in ``ref.gram_brick_tiles``), as one bf16 product.
``plain`` is its plain PyTorch version (``kernels/ref.py``).  The two modes
count their launches apart (``KERNEL``, ``KERNEL_BF16``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, gram_tc, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
         _P]
KERNEL = build.CudaKernel("tile_gram", "repro_tile_gram", _ARGS)
KERNEL_BF16 = build.CudaKernel("tile_gram_bf16", "repro_tile_gram", _ARGS)

SUB = 64              # T must be a multiple of it (the least block edge)

plain = ref.tile_gram


def launch(bricks, rows, n_valid: int, w, r, *, precision: str = "fp32"):
    """(G (T, T), g (T,)) from the CUDA kernel.

    bricks (K, rb, T): the tile's bricks, usually a view into the design's
    brick array (no copy); rows (K,) int32 row-block ids; n_valid <= K live
    slots (a host int); w, r (n_rows,) with n_rows a multiple of rb.
    ``precision`` "bf16" runs the bf16 mode (G is then not symmetric).
    """
    bf16 = ref.is_bf16(precision)
    build.check_cuda("tile_gram", torch.float32, bricks, w, r)
    build.check_cuda("tile_gram", torch.int32, rows)
    K, rb, T = bricks.shape
    n_valid = int(n_valid)
    if T % SUB or rows.shape != (K,) or not 0 <= n_valid <= K \
            or w.shape != r.shape or w.dim() != 1 or w.shape[0] % rb:
        raise ValueError(
            f"tile_gram: bad shapes bricks {tuple(bricks.shape)}, rows "
            f"{tuple(rows.shape)}, n_valid {n_valid}, w {tuple(w.shape)} "
            f"(T must be a multiple of {SUB})")
    if bricks.data_ptr() % 16:
        raise ValueError("tile_gram: bricks must be 16-byte aligned")
    # the live bricks' rows as one stream of slabs, cut into ranges
    bn, npairs = gram_tc.band(T), gram_tc.n_pairs(T, bf16)
    slabs = n_valid * -(-rb // gram_tc.SLAB)
    splits = gram_tc.ranges(slabs, npairs,
                            gram_tc.MAX_RANGE_ROWS // gram_tc.SLAB,
                            gram_tc.sm_count(bricks.device))
    per = -(-slabs // splits)
    splits = max(1, -(-slabs // max(per, 1)))
    dev = bricks.device
    Gp = torch.empty(splits * npairs * bn * bn, dtype=torch.float32,
                     device=dev)
    gp = torch.empty(splits * T, dtype=torch.float32, device=dev)
    G = torch.empty((T, T), dtype=torch.float32, device=dev)
    g = torch.empty(T, dtype=torch.float32, device=dev)
    (KERNEL_BF16 if bf16 else KERNEL)(
        build.ptr(bricks), K, build.ptr(rows), n_valid, splits, per,
        build.ptr(w), build.ptr(r), rb, T, bn, int(bf16), build.ptr(Gp),
        build.ptr(gp), build.ptr(G), build.ptr(g), build.stream_of(bricks))
    return G, g
