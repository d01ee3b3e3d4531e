"""Megatron's tensor parallelism over the port's (data, model) mesh: what
GSPMD inserts for the reference's sharded LM step, written out.

``Layout(mesh)`` is where this rank sits on a ``DeviceMesh`` with dims
``("data", "model")`` (``dist.bootstrap.make_dist_mesh``): the sizes D and
M, its coordinates (d, m), and the two process groups as
``collectives.MeshGroup``.  It places a full tensor (``block``: this
rank's block of it under a ``ParamDef`` spec) and says where the
residual stream is sequence-parallel (``seq_parallel``, the reference's
``transformer._shard_h``).

The four paired ``torch.autograd.Function``s over the ``model`` group
(Megatron's names in brackets):

  * ``copy``    identity forward, all-reduce backward (enter a column-
    parallel region from a replicated stream);
  * ``reduce``  all-reduce forward, identity backward (leave a row-
    parallel region into a replicated stream);
  * ``gather``  all-gather along the sequence forward, reduce-scatter
    backward (enter from a sequence-parallel stream);
  * ``scatter`` reduce-scatter along the sequence forward, all-gather
    backward (leave into a sequence-parallel stream);

and ``gather_whole`` (all-gather forward, this rank's slice backward), a
sharded weight made whole where every rank computes the same loss from
it (the reference's gathered unembed).  A bare differentiable all-reduce
would all-reduce again in its backward: every gradient would come back M
times too large.

The conventions are ``collectives.py``'s: a group of one is no call, and
every call, forward or backward, is recorded in ``collective_trace()``
(taken before the group-of-one shortcut, so a (1, 1) mesh records the
sequence of a larger one).  The reduce-scatter is carried by an
all-reduce and a slice, and the all-gather by ``all_gather`` into a
list: gloo, which carries two ranks sharing one card, has both on card
tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import spec_axes
from repro_torch.sharding import collectives
from repro_torch.sharding.collectives import MeshGroup


class Layout:
    """This rank's place on a (data, model) ``DeviceMesh``."""

    def __init__(self, mesh):
        names = list(mesh.mesh_dim_names)
        if names != ["data", "model"]:
            raise ValueError(f"a (data, model) mesh, not {names}")
        self.mesh = mesh
        self.D, self.M = mesh.size(0), mesh.size(1)
        self.d = mesh.get_local_rank("data")
        self.m = mesh.get_local_rank("model")
        self.data = MeshGroup(mesh.get_group("data"), "data")
        self.model = MeshGroup(mesh.get_group("model"), "model")

    axis_names = ("data", "model")

    @classmethod
    def dry(cls, sizes) -> "Layout":
        """Rank 0 of a (data, model) mesh of ``sizes`` with no process
        group: its groups are ``collectives.DryGroup``s, which record every
        collective and exchange nothing (the dry-run's world)."""
        lay = cls.__new__(cls)
        lay.mesh = None
        (lay.D, lay.M), lay.d, lay.m = sizes, 0, 0
        lay.data = MeshGroup(collectives.DryGroup(lay.D), "data")
        lay.model = MeshGroup(collectives.DryGroup(lay.M), "model")
        return lay

    @property
    def shape(self) -> dict:
        return {"data": self.D, "model": self.M}

    def axis_index(self, axis: str) -> tuple:
        """(rank along ``axis``, its size)."""
        return (self.d, self.D) if axis == "data" else (self.m, self.M)

    def block_index(self, spec, shape) -> tuple:
        """The slices of this rank's block of a ``shape`` tensor laid out
        by ``spec`` (an axis name, a tuple of them, or None a dim)."""
        idx = []
        for i, n in enumerate(shape):
            k, ext = 0, 1
            for a in spec_axes(spec, i):
                r, size = self.axis_index(a)
                k, ext = k * size + r, ext * size
            if n % ext:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"over {spec_axes(spec, i)} ({ext} ranks)")
            w = n // ext
            idx.append(slice(k * w, (k + 1) * w))
        return tuple(idx)

    def block(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of the full tensor ``t`` (a copy)."""
        return t[self.block_index(spec, t.shape)].clone()

    def seq_parallel(self, cfg, seq_len: int) -> bool:
        """Whether the residual stream is split over ``model`` along the
        sequence: where the reference's ``_shard_h`` shards it
        (``seq_shard``, not fsdp, S > 1 and S % M == 0), with M past 1."""
        return (self.M > 1 and getattr(cfg, "seq_shard", True)
                and getattr(cfg, "parallelism", "tp") != "fsdp"
                and seq_len > 1 and seq_len % self.M == 0)


# ---------------------------------------------------------------------------
# the collectives (no autograd)
# ---------------------------------------------------------------------------

def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim``, in group
    rank order."""
    collectives.record_collective("all_gather", group, x.numel(), x.dtype)
    n = collectives.group_size(group)
    if n == 1:
        return x.view_as(x)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    raw = collectives.raw_group(group)
    if not isinstance(raw, collectives.DryGroup):
        import torch.distributed as dist
        dist.all_gather(parts, x, group=raw)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the group's sum of ``x``."""
    collectives.record_collective("reduce_scatter", group, x.numel(),
                                  x.dtype)
    n = collectives.group_size(group)
    if n == 1:
        return x.view_as(x)
    s = x.contiguous().clone()
    collectives._all_reduce(s, group)
    r = collectives.group_rank(group)
    return s.chunk(n, dim=dim)[r].contiguous()


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = collectives.group_size(group)
    if n == 1:
        return x.view_as(x)
    r = collectives.group_rank(group)
    return x.chunk(n, dim=dim)[r].contiguous()


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``collectives.all_reduce`` of a copy of ``x`` (no autograd)."""
    return collectives.all_reduce(x.detach().clone(), group, op)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` along ``dim`` (no autograd)."""
    return _all_gather(x.detach(), group, dim)


# ---------------------------------------------------------------------------
# the paired autograd Functions
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


def copy(x, group):
    """Identity forward, all-reduce of the gradient backward."""
    return _Copy.apply(x, group)


def reduce(x, group):
    """All-reduce forward, identity backward."""
    return _Reduce.apply(x, group)


def gather(x, group, dim: int = 1):
    """All-gather along ``dim`` forward, reduce-scatter backward."""
    return _Gather.apply(x, group, dim)


def scatter(x, group, dim: int = 1):
    """Reduce-scatter along ``dim`` forward, all-gather backward."""
    return _Scatter.apply(x, group, dim)


def gather_whole(x, group, dim: int):
    """All-gather along ``dim`` forward, this rank's slice of the gradient
    backward: for a weight every rank then uses whole and alike."""
    return _GatherWhole.apply(x, group, dim)


# ---------------------------------------------------------------------------
# a parallel region and the vocab-split embedding
# ---------------------------------------------------------------------------

def enter(x, layout: Optional[Layout], sp: bool):
    """The input of a column-parallel region: the stream made whole over
    the sequence (``sp``) or marked for the all-reduce of its gradient."""
    if layout is None:
        return x
    return gather(x, layout.model) if sp else copy(x, layout.model)


def leave(y, layout: Optional[Layout], sp: bool):
    """The partial sums of a row-parallel region summed over ``model``:
    this rank's block of the sequence (``sp``) or the whole stream."""
    if layout is None:
        return y
    return scatter(y, layout.model) if sp else reduce(y, layout.model)


def embed_lookup(tokens, w_local, layout: Layout, sp: bool):
    """Rows of a vocab-split embedding: each rank looks up the tokens its
    rows own (zeros elsewhere), summed over ``model`` (exactly: one term is
    not zero), as ``leave`` lays the stream out."""
    v_loc = w_local.shape[0]
    v0 = layout.m * v_loc
    owned = (tokens >= v0) & (tokens < v0 + v_loc)
    idx = torch.where(owned, tokens - v0, torch.zeros_like(tokens))
    e = torch.nn.functional.embedding(idx, w_local)
    e = e * owned[..., None].to(e.dtype)
    return leave(e, layout, sp)

