"""Compressed cross-node reductions (mirrors ``repro.sharding.compress``).

The dominant collective of d-GLMNET is the sum of the margin delta
``X dbeta`` over the feature shards (paper Algorithm 4, step 6): O(n)
floats a superstep.  It feeds a line search whose Armijo test rejects bad
steps, so the merge tolerates lossy compression.

Modes (the reference's semantics):
  * ``None``  — a float32 ``all_reduce``;
  * ``"bf16"`` — cast to bfloat16, sum, cast back (half the bytes);
  * ``"int8"`` — one shared scale: every shard's |x|-max is reduced with
    ``ReduceOp.MAX``, each shard quantizes with ``amax / 127`` (round half
    to even, as ``jnp.round``), the int32 sum dequantizes once.  The error
    is at most M amax / 254 per element over M shards; all-zero input
    comes back exactly 0 (the scale floors at 1e-30).

The reference has no Pallas body here, so the plain torch form is the
port; the collectives run on ``torch.distributed`` (``sharding.collectives``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding import collectives


def psum_compressed(x, group, mode: Optional[str] = None):
    """Sum of ``x`` over the ranks of ``group`` with optional lossy wire
    compression; ``group`` None is no reduction (one device).  A group of
    one still applies the cast or the quantization, as a psum over a mesh
    axis of size 1 does."""
    if group is None:
        return x
    if mode is None or mode == "none":
        return collectives.all_reduce(x.clone(), group)
    if mode == "bf16":
        return collectives.all_reduce(x.to(torch.bfloat16), group) \
            .to(x.dtype)
    if mode == "int8":
        amax = collectives.all_reduce(torch.max(torch.abs(x)).reshape(1),
                                      group, op="max")[0]
        # amax / 127 as XLA computes it: the division by a constant is
        # folded into a product with float32(1 / 127), so both packages
        # quantize with the same scale
        scale = torch.clamp(amax, min=1e-30) * (1.0 / 127.0)
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        acc = collectives.all_reduce(q.to(torch.int32), group)
        return acc.to(x.dtype) * scale
    raise ValueError(f"unknown compression mode {mode!r}")
