"""Multi-process bring-up on ``torch.distributed`` (mirrors
``repro.dist.bootstrap``, which brings up ``jax.distributed``).

One process per rank, each owning one (data, model) block of a
``DeviceMesh`` with dims ``("data", "model")``:

    ctx  = bootstrap.initialize()              # env-var driven
    mesh = bootstrap.make_dist_mesh(D, M)      # rank = d * M + m
    solver = GLMSolver(X, y, mesh=mesh, ...)

Contracts:

  * **env-var driven** — ``initialize()`` reads ``REPRO_DIST_COORD``
    (``host:port`` of the store), ``REPRO_DIST_NPROCS`` and
    ``REPRO_DIST_PROCID`` (set by ``repro_torch.dist.launcher`` and
    ``launch/dist_run.py``), or takes the same values as arguments.  With
    no coordinator it returns a single-process context and starts no
    process group.  A coordinator with one process starts a world of one,
    so a (1, 1) mesh runs the collectives' code path too.
  * **one kept store** — the ``TCPStore`` the process group is built on
    stays open: ``kv_set``/``kv_get``/``barrier`` (telemetry exchange,
    coordinator-only checkpoints, the fault guard) run on it, every wait
    under a timeout.
  * **backends** — ``backend=None`` means ``"cpu:gloo,cuda:nccl"``: NCCL
    carries the collectives on the card's tensors and gloo the host
    gathers.  ``backend="gloo"`` (the caller's explicit choice) carries
    both, staging card tensors through the host, which is what several
    ranks sharing one card need: NCCL gives each rank a card of its own,
    and ``initialize`` raises (naming ``backend="gloo"``) when a world
    would put two NCCL ranks on one card.  Nothing here swaps one backend
    for another.
  * **the card** — ``device=None`` selects the card ``process_id %
    device_count`` with ``torch.cuda.set_device`` before anything resolves
    ``device=None`` (``resolve_device`` takes the current card, and turns
    TF32 off in this process); ``device="cpu"`` keeps the rank on the CPU.
  * **host gathers** — ``gather_to_host`` concatenates every member's
    block on the host, in group rank order (card tensors are copied to the
    host first, so gloo gathers them whatever the backend of the card's
    collectives).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch

ENV_COORD = "REPRO_DIST_COORD"
ENV_NPROCS = "REPRO_DIST_NPROCS"
ENV_PROCID = "REPRO_DIST_PROCID"
DEFAULT_BACKEND = "cpu:gloo,cuda:nccl"

_CONTEXT: Optional["DistContext"] = None
_STORE = None


@dataclasses.dataclass(frozen=True)
class DistContext:
    """What one process knows about the job it is part of."""
    process_id: int
    num_processes: int
    coordinator: Optional[str]          # None without a process group
    backend: Optional[str] = None
    device: Optional[str] = None        # "cuda" or "cpu" (None: not chosen)

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @property
    def multiprocess(self) -> bool:
        return self.num_processes > 1


def context() -> DistContext:
    """The active context (single-process default until ``initialize``)."""
    global _CONTEXT
    if _CONTEXT is None:
        _CONTEXT = DistContext(0, 1, None)
    return _CONTEXT


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _select_device(device, process_id: int) -> torch.device:
    """The rank's device; ``None`` is card ``process_id % device_count``,
    made current before anything resolves ``device=None``."""
    from repro_torch.device import resolve_device
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "ranks on the CPU")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    return resolve_device(device)


def initialize(*, coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, timeout_s: float = 60.0,
               backend: Optional[str] = None, device=None) -> DistContext:
    """Start this process's rank from env vars or arguments; idempotent.

    Without a coordinator this is the single-process context (no process
    group).  ``backend`` None is ``"cpu:gloo,cuda:nccl"``; ``device`` None
    the card ``process_id % device_count``, ``"cpu"`` the CPU.
    """
    global _CONTEXT, _STORE
    import torch.distributed as dist
    if _CONTEXT is not None and _CONTEXT.coordinator is not None:
        return _CONTEXT
    coordinator = coordinator or os.environ.get(ENV_COORD)
    if num_processes is None:
        num_processes = int(os.environ.get(ENV_NPROCS, "1"))
    if process_id is None:
        process_id = int(os.environ.get(ENV_PROCID, "0"))
    if coordinator is None:
        # no process group; a later make_dist_mesh starts a world of one
        # with these choices
        _CONTEXT = DistContext(0, 1, None, backend,
                               None if device is None
                               else torch.device(device).type)
        return _CONTEXT
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} out of range for "
                         f"{num_processes} processes")
    backend = DEFAULT_BACKEND if backend is None else backend
    dev = _select_device(device, process_id)
    if "nccl" in backend:
        if not dist.is_nccl_available():
            raise RuntimeError(
                f"backend={backend!r} needs NCCL, which this torch lacks; "
                "pass backend='gloo'")
        local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        if dev.type != "cuda" or torch.cuda.device_count() < local:
            raise ValueError(
                f"backend={backend!r} puts {local} NCCL ranks on "
                f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} "
                "card(s): NCCL needs a card per rank; pass backend='gloo' "
                "to share a card (or to run the ranks on the CPU)")
    host, _, port = coordinator.rpartition(":")
    timeout = datetime.timedelta(seconds=timeout_s)
    _STORE = dist.TCPStore(host or "127.0.0.1", int(port), num_processes,
                           process_id == 0, timeout=timeout)
    dist.init_process_group(backend, store=_STORE, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _CONTEXT = DistContext(process_id, num_processes, coordinator, backend,
                           dev.type)
    return _CONTEXT


def shutdown():
    """Destroy the process group and drop the store (the end of a run)."""
    global _CONTEXT, _STORE
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _STORE = None
    _CONTEXT = None


def _reset_context():
    global _CONTEXT
    _CONTEXT = None


def _reset_for_tests():
    shutdown()


# ---------------------------------------------------------------------------
# process-spanning meshes
# ---------------------------------------------------------------------------

def _ensure_world():
    """A single-process caller of ``make_dist_mesh`` gets a world of one
    (gloo on a free local port, on the CPU unless a card is current)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    ctx = context()
    if ctx.coordinator is None:
        dev = ctx.device or ("cuda" if torch.cuda.is_available() else "cpu")
        backend = ctx.backend or "gloo"
        _reset_context()
        initialize(coordinator=f"127.0.0.1:{_free_port()}", num_processes=1,
                   process_id=0, backend=backend,
                   device=None if dev == "cuda" else dev)


def make_dist_mesh(n_data: int = 1, n_model: Optional[int] = None):
    """(data x model) ``DeviceMesh`` over every rank of the job, rank =
    d * n_model + m (the reference's device order).  ``n_model`` None is
    the paper's layout, one feature shard per process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    _ensure_world()
    world = dist.get_world_size()
    if n_model is None:
        if world % n_data:
            raise ValueError(f"{world} processes do not split into "
                             f"n_data={n_data} rows")
        n_model = world // n_data
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{n_data * n_model} processes; the job has {world}")
    ranks = torch.arange(world).reshape(n_data, n_model)
    return DeviceMesh(context().device or "cpu", ranks,
                      mesh_dim_names=("data", "model"))


def _rank_grid(mesh, axis_model: str) -> np.ndarray:
    """(rows, M) ranks of ``mesh`` with the model dim last."""
    names = list(mesh.mesh_dim_names)
    grid = np.moveaxis(mesh.mesh.cpu().numpy(), names.index(axis_model), -1)
    return grid.reshape(-1, grid.shape[-1])


def column_process_map(mesh, axis_model: str = "model") -> np.ndarray:
    """(M,) process owning each model column of ``mesh`` (its first rank;
    one process per rank, so a rank is its process id).  Node speeds are
    measured per process and budgets spent per column; a column's budget
    is the same on every rank of it."""
    return np.asarray(_rank_grid(mesh, axis_model)[0], np.int64)


def local_columns(mesh, axis_model: str = "model") -> list:
    """Model columns with a rank in this process."""
    grid = _rank_grid(mesh, axis_model)
    me = context().process_id
    return [m for m in range(grid.shape[1]) if (grid[:, m] == me).any()]


def is_multiprocess_mesh(mesh) -> bool:
    return len(set(mesh.mesh.flatten().tolist())) > 1


def mesh_coords(mesh, axis_data: Optional[str] = "data",
                axis_model: str = "model"):
    """(D, M, d, m): the mesh's shape and this rank's block (D = 1, d = 0
    when ``axis_data`` is None)."""
    M = mesh.size(list(mesh.mesh_dim_names).index(axis_model))
    m = mesh.get_local_rank(axis_model)
    if axis_data is None:
        return 1, M, 0, m
    D = mesh.size(list(mesh.mesh_dim_names).index(axis_data))
    return D, M, mesh.get_local_rank(axis_data), m


# ---------------------------------------------------------------------------
# placement and host gathers
# ---------------------------------------------------------------------------

def put_global(arr, mesh, spec: Sequence[Optional[str]], device=None):
    """This rank's block of a full host array, on ``device``.

    Every process passes the same full array (the replicated-host data
    model) and keeps its own block: ``spec[i]`` names the mesh dim that
    splits array axis i (None: not split), as a ``PartitionSpec`` does."""
    from repro_torch.device import resolve_device
    a = np.asarray(arr)
    idx = []
    for i, axis in enumerate(spec):
        if axis is None:
            idx.append(slice(None))
            continue
        n = mesh.size(list(mesh.mesh_dim_names).index(axis))
        if a.shape[i] % n:
            raise ValueError(f"axis {i} of length {a.shape[i]} does not "
                             f"split over {n} ranks of {axis!r}")
        size = a.shape[i] // n
        k = mesh.get_local_rank(axis)
        idx.append(slice(k * size, (k + 1) * size))
    block = np.ascontiguousarray(a[tuple(idx)])
    return torch.from_numpy(block).to(resolve_device(device))


def gather_to_host(x, group=None) -> np.ndarray:
    """Host numpy concatenation (along axis 0) of every member's ``x`` in
    ``group`` (None: the world), in group rank order.  Collective: every
    member calls it.  Without a process group, or in a group of one, it is
    the host copy of ``x``."""
    import torch.distributed as dist
    t = x.detach().cpu() if torch.is_tensor(x) else torch.as_tensor(
        np.asarray(x))
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return t.numpy().copy()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts).numpy()


def broadcast_host(arr, src: int = 0) -> np.ndarray:
    """Process ``src``'s copy of a host array, on every process (a gloo
    broadcast on the host); the host copy itself without a world.  Host
    decisions that must agree bit for bit across ranks (the stop test,
    screening masks) are taken from it."""
    import torch.distributed as dist
    a = np.ascontiguousarray(arr)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return a
    t = torch.from_numpy(a.copy())
    dist.broadcast(t, src=src)
    return t.numpy()


# ---------------------------------------------------------------------------
# the store: KV exchange and barriers
# ---------------------------------------------------------------------------

def _store():
    if _STORE is None:
        raise RuntimeError(
            "torch.distributed is not initialized; call "
            "repro_torch.dist.bootstrap.initialize() (or run under "
            "repro_torch.dist.launcher) first")
    return _STORE


def kv_set(key: str, value: str):
    _store().set(key, value)


def kv_get(key: str, timeout_s: float = 30.0) -> str:
    store = _store()
    store.wait([key], datetime.timedelta(seconds=timeout_s))
    out = store.get(key)
    return out.decode() if isinstance(out, bytes) else out


_BARRIER_SEQ: int = 0


class BarrierTagMismatch(RuntimeError):
    """Processes reached the same barrier slot with different tags: their
    control flow diverged (one took an early return, skipped a checkpoint
    or ran an extra round).  Raised at once, naming both tags, where a
    plain barrier would hang to its timeout."""


def barrier(tag: str = "repro", timeout_s: float = 60.0):
    """Process barrier on the kept store; a no-op in single-process runs.

    Slots are numbered by a global sequence, so processes whose control
    flow diverged meet at the same slot with different tags and
    ``BarrierTagMismatch`` names both; a peer that never arrives raises
    the store's timeout (``faults.guarded_barrier`` reports it as a dead
    process)."""
    global _BARRIER_SEQ
    ctx = context()
    if not ctx.multiprocess:
        return
    seq = _BARRIER_SEQ
    _BARRIER_SEQ += 1
    pid = ctx.process_id
    kv_set(f"repro/barrier_tag/{seq}/{pid}", tag)
    ref = tag if pid == 0 else kv_get(f"repro/barrier_tag/{seq}/0",
                                      timeout_s=timeout_s)
    if ref != tag:
        raise BarrierTagMismatch(
            f"barrier slot {seq}: process {pid} arrived with tag {tag!r} "
            f"but process 0 arrived with {ref!r}; SPMD control flow has "
            "diverged (every process must run the same barrier sequence)")
    store = _store()
    key = f"repro/barrier/{tag}/{seq}"
    if store.add(key, 1) == ctx.num_processes:
        store.set(key + "/go", "1")
    store.wait([key + "/go"], datetime.timedelta(seconds=timeout_s))
