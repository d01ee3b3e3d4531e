"""Crash-atomic checkpoints of a tree of tensors (mirrors
``repro.checkpoint.manager``; the same files, so each package reads the
other's checkpoints).

  * every checkpoint is a directory ``ckpt_<step>`` holding ``shard_0.npz``
    (one array per leaf) and ``manifest.json`` (``step``, ``time``, the
    sorted leaf ``keys`` and the user ``metadata``);
  * writes are crash-atomic: a ``ckpt_<step>.tmp`` directory is filled,
    fsynced and ``os.replace``d into place, so a crash mid-write never
    corrupts the latest complete checkpoint (an incomplete one is
    ignored);
  * ``keep_last`` old checkpoints are removed after a commit, never before;
  * ``async_save=True`` writes on a daemon thread, so the fit overlaps
    serialization with its next superstep; ``wait()`` joins before the
    next save, and an ``atexit`` hook (and ``__del__``) joins a writer in
    flight, so the last checkpoint of a run is durable without a
    ``wait()`` after it.

In a multi-process job (``repro_torch.dist``) every process calls
``save`` with the same full host tree (the solver gathers its shards
first), only the coordinator writes, synchronously, and a barrier
(``ckpt-save``) orders the commit before any peer goes on to restore or
exit; ``restore`` reads the full arrays in every process, which keeps its
own block.

Leaves are copied to host numpy before the writer starts, so the caller
may overwrite its tensors at once; ``restore`` puts each array on the
device of its template tensor.  Keys
are the JAX package's: a leaf's path of dict keys, list indices and
named-tuple fields joined by ``/`` (``"_root"`` for a bare leaf).

Traced (``repro_torch.obs``), the copy to the host runs in a ``ckpt/save``
span, the write and commit in ``ckpt/commit`` on the thread that writes,
and the read of ``restore`` in ``ckpt/restore``.
"""
from __future__ import annotations

import atexit
import json
import os
import pathlib
import shutil
import threading
import time
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch.dist import bootstrap as dist_boot
from repro_torch.obs import trace as obs_trace

# managers that may have a writer in flight; the writer threads are daemonic
# (a hung filesystem must not wedge interpreter exit), so without this join
# an exit right after the last save() would drop that checkpoint
_LIVE_MANAGERS: "weakref.WeakSet[CheckpointManager]" = weakref.WeakSet()


@atexit.register
def _join_pending_saves():
    for mgr in list(_LIVE_MANAGERS):
        mgr.wait()


def _list_steps(directory: pathlib.Path):
    out = []
    for p in directory.glob("ckpt_*"):
        if p.suffix == ".tmp" or not (p / "manifest.json").exists():
            continue  # an incomplete write, ignored by design
        try:
            out.append(int(p.name.split("_")[1]))
        except ValueError:
            pass
    return sorted(out)


def _leaves(tree, path=()):
    """(path, leaf) pairs in the order ``jax.tree_util`` flattens: dict
    keys sorted, sequences and named tuples in order; None is no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for k in tree._fields
                for kv in _leaves(getattr(tree, k), path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves(v, path + (i,))]
    return [(path, tree)]


def _flatten(tree) -> dict:
    return {"/".join(map(str, path)) or "_root": leaf
            for path, leaf in _leaves(tree)}


def _unflatten(tree, values, path=()):
    """``tree``'s structure with each leaf replaced by ``values[key]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, k), values, path + (k,))
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, values, path + (i,))
                          for i, v in enumerate(tree))
    return values["/".join(map(str, path)) or "_root"]


def _to_host(leaf) -> np.ndarray:
    """A host copy of a leaf that the caller may overwrite at once (a CPU
    tensor's ``.cpu()`` would share its memory)."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory, *, keep_last: int = 3,
                 async_save: bool = False):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        _LIVE_MANAGERS.add(self)

    def __del__(self):
        # a manager dropped mid-save still commits its last checkpoint
        try:
            self.wait()
        except Exception:
            pass

    # ------------------------------------------------------------- save

    def save(self, step: int, tree, *, metadata: Optional[dict] = None):
        """Write ``tree`` (tensors, arrays and scalars in dicts, lists and
        named tuples) as checkpoint ``step``."""
        self.wait()
        with obs_trace.span("ckpt/save", args={"step": int(step)}):
            flat = {k: _to_host(v) for k, v in _flatten(tree).items()}
        meta = {"step": int(step), "time": time.time(), "keys": sorted(flat),
                "metadata": metadata or {}}
        ctx = dist_boot.context()
        if ctx.multiprocess:
            # the coordinator writes, synchronously: an async write would
            # move the commit past the barrier that orders it
            if ctx.is_coordinator:
                self._write(self.dir, self.keep_last, step, flat, meta)
            dist_boot.barrier("ckpt-save")
            return
        if self.async_save:
            # the writer is a static function over plain values: it holds no
            # reference to the manager, so a manager dropped mid-save can be
            # collected and its __del__ joins the write
            self._thread = threading.Thread(
                target=CheckpointManager._write,
                args=(self.dir, self.keep_last, step, flat, meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(self.dir, self.keep_last, step, flat, meta)

    @staticmethod
    def _write(directory: pathlib.Path, keep_last: int, step: int,
               flat: dict, meta: dict):
        # on the writer's thread when async: its own lane in a trace
        with obs_trace.span("ckpt/commit", args={"step": int(step)}):
            tmp = directory / f"ckpt_{step}.tmp"
            final = directory / f"ckpt_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
            np.savez(tmp / "shard_0.npz", **flat)
            (tmp / "manifest.json").write_text(json.dumps(meta))
            # fsync the directory entry, then commit atomically
            fd = os.open(tmp, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            CheckpointManager._gc(directory, keep_last)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @staticmethod
    def _gc(directory: pathlib.Path, keep_last: int):
        steps = _list_steps(directory)
        for s in steps[:-keep_last] if keep_last else []:
            shutil.rmtree(directory / f"ckpt_{s}", ignore_errors=True)

    # ---------------------------------------------------------- restore

    def all_steps(self):
        return _list_steps(self.dir)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: Optional[int]) -> pathlib.Path:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return self.dir / f"ckpt_{step}"

    def read_metadata(self, *, step: Optional[int] = None) -> dict:
        """The user metadata of a checkpoint (the latest by default),
        without loading its arrays."""
        d = self._step_dir(step)
        return json.loads((d / "manifest.json").read_text())["metadata"]

    def restore(self, like, *, step: Optional[int] = None):
        """(tree, metadata): checkpoint ``step`` (the latest by default) in
        the structure of ``like``.  A tensor leaf of ``like`` gets a tensor
        on its device; a numpy leaf a numpy array; any other leaf the
        stored array."""
        d = self._step_dir(step)
        with obs_trace.span("ckpt/restore",
                            args={"step": int(d.name.split("_")[1])}):
            meta = json.loads((d / "manifest.json").read_text())
            with np.load(d / "shard_0.npz") as z:
                flat = {k: z[k] for k in z.files}
        flat_like = _flatten(like)
        if sorted(flat_like) != meta["keys"]:
            differ = set(meta["keys"]) ^ set(flat_like)
            raise ValueError(f"checkpoint tree mismatch; differing keys: "
                             f"{sorted(differ)[:8]}")
        out = {}
        for k, ref in flat_like.items():
            arr = flat[k]
            if torch.is_tensor(ref):
                out[k] = torch.from_numpy(np.array(arr)).to(ref.device)
            elif isinstance(ref, np.ndarray):
                out[k] = np.array(arr)
            else:
                out[k] = arr
        return _unflatten(like, out), meta["metadata"]
