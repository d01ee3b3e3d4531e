"""K7 predict_tile: fused sparse scoring (gather + dot + link) for serving.

The CUDA kernel is ``csrc/predict_tile.cu``; it replaces
``repro/kernels/predict_tile.py::predict_tile_pallas``.  ``plain`` is its
plain PyTorch version (``kernels/ref.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# the inverse link of each family in the kernel; a family missing here has
# no link body and raises (the JAX package falls back to its oracle)
LINK_CODES = {"logistic": 0, "squared": 1, "probit": 2, "poisson": 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.CudaKernel(
    "predict_tile", "repro_predict_tile",
    [_P, _P, _I, _I, _P, _I, _I, _P, _P, _I, _P])

THREADS = 128            # kThreads in the source
SMALL_BATCH = 256        # kSmallBatch

plain = ref.predict_tile


def lanes_per_row(B: int, J: int) -> int:
    """The lanes of a row's group as the source picks them: one 4-pair
    vector a lane up to ``SMALL_BATCH`` rows, two above, in groups of 8, 16
    or 32."""
    vectors = -(-J // 4)
    per_lane = 1 if B <= SMALL_BATCH else 2
    return 8 if vectors <= 8 * per_lane else \
        16 if vectors <= 16 * per_lane else 32


def grid(B: int, J: int) -> tuple[int, int]:
    """(blocks, threads) of the kernel's launch for B rows of J pairs."""
    return -(-B * lanes_per_row(B, J) // THREADS), THREADS


def launch(slots, vals, table, b0, family: str, kind: str = "link"):
    """(B, L) margins (``kind="link"``) or responses from the CUDA kernel.

    slots (B, J) int32, vals (B, J) f32, table (A+1, L) f32 with an all-zero
    last row, b0 (L,) f32.
    """
    if family not in LINK_CODES:
        raise ValueError(
            f"predict_tile has no link body for family {family!r}")
    if kind not in ("link", "response"):
        raise ValueError(f"unknown kind {kind!r}; use 'link' or 'response'")
    build.check_cuda("predict_tile", torch.float32, vals, table, b0)
    build.check_cuda("predict_tile", torch.int32, slots)
    B, J = slots.shape
    A1, L = table.shape
    if vals.shape != (B, J) or b0.shape != (L,) or min(J, A1, L) == 0:
        raise ValueError(
            f"predict_tile: bad shapes slots {tuple(slots.shape)}, vals "
            f"{tuple(vals.shape)}, table {tuple(table.shape)}, b0 "
            f"{tuple(b0.shape)}")
    out = torch.empty((B, L), dtype=torch.float32, device=vals.device)
    if B == 0:
        return out
    link = LINK_CODES[family] if kind == "response" else -1
    KERNEL(build.ptr(slots), build.ptr(vals), B, J, build.ptr(table), A1, L,
           build.ptr(b0), build.ptr(out), link, build.stream_of(vals))
    return out
