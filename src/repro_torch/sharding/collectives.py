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

``collective_trace()`` is the counterpart of ``ops.launch_trace`` for
collectives: it collects each logical collective in call order as (op,
the group's mesh dim or "world", the group's size, numel, dtype), taken
before the group-of-one shortcut, so a (1, 1) mesh shows the same sequence
as a larger one.  ``all_reduce``, ``all_reduce_many`` and
``dist.bootstrap``'s ``gather_to_host``, ``broadcast_host`` and
``barrier`` record; outside a trace the cost is one ``is None`` test a
call.  A group is named by wrapping it in a ``MeshGroup`` (the solver
wraps its mesh's groups): a torch ``DeviceMesh`` may hand out one process
group for two dims.

A ``DryGroup`` is a group that does not communicate: the dry-run's world
(``tensor_parallel.Layout.dry``), rank 0 of a mesh traced alone with no
process group.  Every collective over it is recorded as over a live group
of its size, runs the allocations and copies of the live path, and skips
the exchange itself: an all-reduce returns its input, an all-gather the
right shape (its blocks never filled), a reduce-scatter this rank's block
of its input.  Only shapes and counts mean anything there.  No live path
builds one.
"""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

from repro_torch.obs import trace as obs_trace

_STATS = {"calls": 0, "seconds": 0.0, "bytes": 0}
_SIZE = {}
_EVENTS = None


class MeshGroup(NamedTuple):
    """A process group with the name of the mesh dim it spans."""
    group: object
    dim: str


class DryGroup:
    """``size`` ranks that never exchange a byte; this process is rank 0
    of them (module docstring)."""

    def __init__(self, size: int):
        self.size = int(size)

    def __repr__(self) -> str:
        return f"DryGroup(size={self.size})"


def raw_group(group):
    """The torch.distributed process group of ``group`` (a MeshGroup or a
    group; None stays None)."""
    return group.group if isinstance(group, MeshGroup) else group


def group_rank(group) -> int:
    """This process's rank in ``group`` (a group, a MeshGroup, a
    DryGroup)."""
    group = raw_group(group)
    if isinstance(group, DryGroup):
        return 0
    import torch.distributed as dist
    return dist.get_rank(group)


def group_size(group) -> int:
    """Ranks in ``group`` (1 for None), cached per group object."""
    group = raw_group(group)
    if group is None:
        return 1
    if isinstance(group, DryGroup):
        return group.size
    n = _SIZE.get(id(group))
    if n is None:
        import torch.distributed as dist
        n = _SIZE[id(group)] = dist.get_world_size(group)
    return n


@contextlib.contextmanager
def collective_trace():
    """Collect the logical collectives called inside; yields the live list
    of (op, dim, size, numel, dtype) records."""
    global _EVENTS
    prev = _EVENTS
    _EVENTS = events = []
    try:
        yield events
    finally:
        _EVENTS = prev


def record_collective(op: str, group, numel: int, dtype) -> None:
    """Record one logical collective over ``group`` (a MeshGroup, a
    process group, or None for the world) inside a
    ``collective_trace()``; a no-op outside one."""
    if _EVENTS is None:
        return
    if isinstance(group, MeshGroup):
        dim, size = group.dim, group_size(group)
    else:
        import torch.distributed as dist
        world = dist.is_initialized() and (
            group is None or group is dist.group.WORLD)
        dim = "world" if group is None or world else \
            getattr(group, "group_desc", "group")
        size = group_size(group) if group is not None else \
            dist.get_world_size() if dist.is_initialized() else 1
    _EVENTS.append((op, dim, int(size), int(numel),
                    str(dtype).removeprefix("torch.")))


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place sum (or ``op="max"``) of ``x`` over ``group``; returns x."""
    if group is not None:
        record_collective("all_reduce" if op == "sum" else
                          f"all_reduce_{op}", group, x.numel(), x.dtype)
    return _all_reduce(x, group, op)


def _all_reduce(x, group, op="sum"):
    if group_size(group) == 1 or isinstance(raw_group(group), DryGroup):
        return x
    import torch.distributed as dist
    rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    t0 = time.perf_counter()
    with obs_trace.span("dist/all_reduce"):
        dist.all_reduce(x, op=rop, group=raw_group(group))
    _STATS["seconds"] += time.perf_counter() - t0
    _STATS["calls"] += 1
    _STATS["bytes"] += x.numel() * x.element_size()
    return x


def all_reduce_many(tensors, group):
    """Sum several float32 tensors over ``group`` in one call (one flat
    buffer); each element's sum is the one a call of its own would give.
    Returns the summed tensors in their shapes."""
    if group is not None:
        record_collective("all_reduce_many", group,
                          sum(t.numel() for t in tensors), tensors[0].dtype)
    if group_size(group) == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce(flat, group)
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
