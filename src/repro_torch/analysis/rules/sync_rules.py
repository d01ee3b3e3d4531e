"""SYNC001 — hidden host synchronization in hot paths.

A CUDA call returns as soon as its kernels are queued, and the card works
while Python goes on.  Two ways code silently throws that overlap away:

* ``time.time()`` spans around dispatch measure *enqueue* latency, not
  compute — repro_torch.timing (``timed``) synchronizes on the result and
  uses ``perf_counter``.  A bare ``time.time()`` is only legitimate as a
  wall-clock *timestamp* (checkpoint metadata), never as a duration.
* per-iteration readbacks of device values inside a dispatch loop —
  ``float(x)``, ``int(x)``, ``bool(x)``, ``np.asarray(x)``, ``x.item()``,
  ``x.tolist()``, ``x.cpu()``, ``x.numpy()`` — each force a blocking
  device-to-host copy.  One batched read a superstep,
  ``torch.stack([...]).tolist()`` as ``device.read_f_nnz`` does, brings
  every scalar over in one transfer (and values read from that host copy
  are free).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.astutil import (FileContext, assigned_names,
                                          base_name, dotted_name)

SYNC_READERS = {"float", "int", "bool"}
SYNC_READER_DOTTED = {"np.asarray", "np.array", "numpy.asarray",
                      "numpy.array", "onp.asarray"}
# methods of a tensor that copy it to the host and wait for the card
SYNC_READER_METHODS = {"item", "tolist", "cpu", "numpy"}

# Callees whose results live on the host — assignments from these never
# taint their targets as device values.
HOST_PRODUCERS = {
    "float", "int", "bool", "str", "len",
    "range", "enumerate", "zip", "list", "dict", "tuple", "set", "sorted",
    "min", "max", "sum", "abs", "round", "repr", "format", "open",
    "time.time", "time.perf_counter", "time.monotonic",
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "json.dumps", "json.loads", "copy.deepcopy",
    "re.match", "re.search", "re.fullmatch", "re.findall",
}

# Method names whose call results are host values regardless of receiver
# (string/dict/file plumbing, and the readbacks themselves) — assignments
# from these don't taint.
HOST_METHOD_TAILS = {
    "partition", "rpartition", "split", "rsplit", "strip", "lstrip",
    "rstrip", "splitlines", "join", "format", "decode", "encode", "lower",
    "upper", "replace", "read", "readline", "readlines", "group", "groups",
    "items", "keys", "values", "copy",
} | SYNC_READER_METHODS


def _reader(node: ast.AST):
    """(the value read back, the reader's name) when ``node`` is a
    readback call, else None."""
    if not isinstance(node, ast.Call):
        return None
    callee = dotted_name(node.func)
    if callee in SYNC_READERS or callee in SYNC_READER_DOTTED:
        return (node.args[0], callee) if node.args else None
    if isinstance(node.func, ast.Attribute) and not node.args \
            and node.func.attr in SYNC_READER_METHODS:
        return node.func.value, f".{node.func.attr}()"
    return None


class Sync001:
    CODE = "SYNC001"
    TITLE = "hidden host sync (time.time span or per-iteration readback)"
    DOC = (
        "Durations must come from repro_torch.timing (synchronize + "
        "perf_counter); time.time() around queued card work measures "
        "enqueue latency.  Inside a loop that dispatches device work, "
        "multiple float()/int()/np.asarray()/.item()/.tolist()/.cpu()/"
        ".numpy() reads of the dispatched result each block the pipe — "
        "batch them into one read a iteration, "
        "torch.stack([...]).tolist() (device.read_f_nnz).  Waive true "
        "wall-clock timestamps with `# lint: allow SYNC001 — timestamp`."
    )

    def check(self, ctx: FileContext):
        yield from self._check_time_time(ctx)
        yield from self._check_loop_readbacks(ctx)

    def _check_time_time(self, ctx: FileContext):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) \
                    and dotted_name(node.func) == "time.time":
                yield ctx.violation(
                    self.CODE, node,
                    "time.time() span — use time.perf_counter() or "
                    "repro_torch.timing.timed (queued card work makes "
                    "time.time() spans measure enqueue, not compute); "
                    "wall-clock timestamps get an inline waiver")

    def _check_loop_readbacks(self, ctx: FileContext):
        seen = set()   # loops nest; report each site cluster once
        for loop in ast.walk(ctx.tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            # names assigned inside the loop from non-host calls: these are
            # (potentially) device values whose readback blocks
            device_names: set = set()
            for stmt in ast.walk(loop):
                if isinstance(stmt, ast.Assign) \
                        and isinstance(stmt.value, ast.Call):
                    callee = dotted_name(stmt.value.func)
                    tail = callee.rsplit(".", 1)[-1]
                    if callee in HOST_PRODUCERS or tail in HOST_PRODUCERS \
                            or (isinstance(stmt.value.func, ast.Attribute)
                                and tail in HOST_METHOD_TAILS):
                        continue
                    for tgt in stmt.targets:
                        device_names.update(assigned_names(tgt))
            if not device_names:
                continue
            sites = []
            for node in ast.walk(loop):
                read = _reader(node)
                # a reader of a reader (x.cpu().numpy(), float(x.item()))
                # is one readback: the inner call is the site
                if read is None or _reader(read[0]) is not None:
                    continue
                if base_name(read[0]) in device_names:
                    sites.append((node, read[0]))
            # One sync per iteration (a convergence check) is the sanctioned
            # pattern; two or more means scalars should batch through a
            # single read.
            if len(sites) >= 2 and id(sites[0][0]) not in seen:
                seen.add(id(sites[0][0]))
                names = sorted({base_name(v) for _, v in sites})
                yield ctx.violation(
                    self.CODE, sites[0][0],
                    f"{len(sites)} blocking host readbacks of dispatched "
                    f"values ({', '.join(n for n in names if n)}) per loop "
                    "iteration — fetch them in one batched read, "
                    "torch.stack([...]).tolist(), and read the host copy")
