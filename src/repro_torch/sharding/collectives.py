"""The reductions of the sharded superstep on ``torch.distributed``: a
``psum`` over a mesh axis of the reference becomes ``all_reduce`` over the
mesh dim's process group.

``all_reduce(x, group)`` reduces in place and returns ``x``; ``group``
None, or a group of one, is no reduction and no call.  Every call that
reaches the process group runs in a ``dist/all_reduce`` span
(``repro_torch.obs``; a cached no-op when tracing is off) and adds its
host seconds and bytes to ``stats()``: with gloo the call returns when the
sum is done, so those seconds are the time inside collectives; with NCCL
the call only enqueues, and they are the host's share.
"""
from __future__ import annotations

import time

import torch

from repro_torch.obs import trace as obs_trace

_STATS = {"calls": 0, "seconds": 0.0, "bytes": 0}
_SIZE = {}


def group_size(group) -> int:
    """Ranks in ``group`` (1 for None), cached per group object."""
    if group is None:
        return 1
    n = _SIZE.get(id(group))
    if n is None:
        import torch.distributed as dist
        n = _SIZE[id(group)] = dist.get_world_size(group)
    return n


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place sum (or ``op="max"``) of ``x`` over ``group``; returns x."""
    if group_size(group) == 1:
        return x
    import torch.distributed as dist
    rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    t0 = time.perf_counter()
    with obs_trace.span("dist/all_reduce"):
        dist.all_reduce(x, op=rop, group=group)
    _STATS["seconds"] += time.perf_counter() - t0
    _STATS["calls"] += 1
    _STATS["bytes"] += x.numel() * x.element_size()
    return x


def all_reduce_many(tensors, group):
    """Sum several float32 tensors over ``group`` in one call (one flat
    buffer); each element's sum is the one a call of its own would give.
    Returns the summed tensors in their shapes."""
    if group_size(group) == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce(flat, group)
    out, k = [], 0
    for t in tensors:
        out.append(flat[k:k + t.numel()].reshape(t.shape))
        k += t.numel()
    return out


def stats() -> dict:
    """Calls, host seconds and bytes of the reductions since the last
    ``reset_stats``."""
    return dict(_STATS)


def reset_stats() -> None:
    _STATS.update(calls=0, seconds=0.0, bytes=0)
