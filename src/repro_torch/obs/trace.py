"""Span tracing with Chrome trace-event (Perfetto) export.

The API and the files of ``repro.obs.trace``, for the port.  The tracer is
always importable and almost always disabled.  Every instrumented site
(the solver's superstep dispatch, the io chunk pipeline, the serve
flusher, checkpoint commits) calls ``span(...)`` unconditionally; when
tracing is off the call returns one cached no-op context manager: no
dict, no object, no clock read, no profiler or NVTX call
(``tests/test_torch_obs.py`` pins the disabled cost under 5 µs a span).

Enabled (``enable(dir)`` or the ``REPRO_TRACE=dir`` environment
variable), spans record begin/end events on a bounded in-memory ring
buffer with monotonic ``perf_counter_ns`` timestamps and export the
Chrome trace-event JSON that Perfetto (https://ui.perfetto.dev) loads:

  * one **pid lane per process**: the pid defaults to the distributed
    runtime's ``REPRO_DIST_PROCID``, with metadata events naming the
    lanes;
  * one **tid track per thread**: the io prefetch worker, the serve
    flusher and the main thread interleave visibly;
  * balanced ``B``/``E`` duration events (the export re-balances pairs
    the ring buffer's eviction may have split);
  * with ``profiler_annotations`` (the default) every span is also a
    ``torch.profiler.record_function`` range, so host spans stand beside
    the kernel records of a ``torch.profiler`` trace, and, when a CUDA
    device is available, an NVTX range (``torch.cuda.nvtx``) for an
    Nsight Systems timeline.  Each range is pushed and popped on the
    thread that opens the span.

A span times host work.  On the card a kernel launch returns before the
kernel runs, so a span around a dispatch measures the dispatch, not the
device time; no span synchronizes the card.

Multi-process protocol: each process writes its own shard
(``trace_<pid>.json``; the atexit hook covers workers that never call
``save``); the coordinator merges shards into one Perfetto file with
``merge_dir(dir)``.  The shard, metrics and convergence files are those of
the JAX package, so either package's ``trace_report`` reads the other's.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import pathlib
import threading
import time
from typing import Optional

import torch

TRACE_ENV = "REPRO_TRACE"
DEFAULT_CAPACITY = 262_144          # events; B+E pairs -> 128k spans


# ---------------------------------------------------------------------------
# disabled mode: one shared no-op span, allocated once at import
# ---------------------------------------------------------------------------


class _NullSpan:
    """The do-nothing span.  A single module-level instance is returned
    for every disabled ``span()`` call; entering and exiting it touches no
    locks, clocks, allocations, profiler or NVTX."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    elapsed_us = 0.0


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every operation is a near-free no-op."""

    enabled = False
    dir: Optional[pathlib.Path] = None
    pid = 0

    def span(self, name, args=None):
        return _NULL_SPAN

    def instant(self, name, args=None):
        pass

    def export(self):
        return {"traceEvents": []}

    def save(self, path=None):
        return None


_NULL_TRACER = NullTracer()


# ---------------------------------------------------------------------------
# enabled mode
# ---------------------------------------------------------------------------


class _Span:
    """One live span: a B event on enter and the matching E event on exit,
    mirrored into a ``record_function`` range and an NVTX range when the
    tracer has them."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_rf", "elapsed_us")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._rf = None
        self.elapsed_us = 0.0

    def __enter__(self):
        tr = self._tracer
        if tr._record_function is not None:
            self._rf = tr._record_function(self.name)
            self._rf.__enter__()
        if tr._nvtx is not None:
            tr._nvtx.range_push(self.name)
        self._t0 = time.perf_counter_ns()
        tr._emit("B", self._t0, self.name, self.args)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self._tracer
        if tr._nvtx is not None:
            tr._nvtx.range_pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.elapsed_us = (t1 - self._t0) / 1e3
        tr._emit("E", t1, self.name, None)
        return False


def _default_pid() -> int:
    procid = os.environ.get("REPRO_DIST_PROCID")
    return int(procid) if procid is not None else os.getpid()


class Tracer:
    """Recording tracer: thread-safe bounded ring buffer of trace events.

    Args:
      dir: where ``save()`` (and the atexit hook) writes the shard; None
        keeps the trace purely in memory (tests, ad-hoc ``export()``).
      pid: Perfetto process lane; defaults to the dist runtime's process id
        (``REPRO_DIST_PROCID``), else the OS pid.
      capacity: ring-buffer bound (events); the oldest events fall off,
        and ``export`` drops any pair the eviction split.
      profiler_annotations: mirror each span into
        ``torch.profiler.record_function`` and, when
        ``torch.cuda.is_available()``, into an NVTX range.
    """

    enabled = True

    def __init__(self, dir=None, *, pid: Optional[int] = None,
                 capacity: int = DEFAULT_CAPACITY,
                 profiler_annotations: bool = True):
        self.dir = pathlib.Path(dir) if dir is not None else None
        self.pid = _default_pid() if pid is None else int(pid)
        self._events = collections.deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._thread_names: dict = {}
        self._record_function = None
        self._nvtx = None
        if profiler_annotations:
            self._record_function = torch.profiler.record_function
            # CPU-only builds raise from torch.cuda.nvtx: decide by the
            # explicit check
            if torch.cuda.is_available():
                self._nvtx = torch.cuda.nvtx

    # -------------------------------------------------------------- record

    def _emit(self, ph: str, ts_ns: int, name: str, args):
        tid = threading.get_ident()
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            self._events.append((ph, ts_ns, tid, name, args))

    def span(self, name: str, args: Optional[dict] = None) -> _Span:
        return _Span(self, name, args)

    def instant(self, name: str, args: Optional[dict] = None):
        self._emit("i", time.perf_counter_ns(), name, args)

    # -------------------------------------------------------------- export

    def export(self) -> dict:
        """Chrome trace-event JSON: metadata naming the pid/tid lanes plus
        the BALANCED B/E stream (ring-buffer eviction can orphan an E
        whose B fell off the front; those are dropped here so the file
        always loads)."""
        with self._lock:
            events = list(self._events)
            tnames = dict(self._thread_names)
        out = [{"ph": "M", "name": "process_name", "pid": self.pid, "tid": 0,
                "args": {"name": f"process {self.pid}"}}]
        for tid, tname in sorted(tnames.items()):
            out.append({"ph": "M", "name": "thread_name", "pid": self.pid,
                        "tid": tid, "args": {"name": tname}})
        stacks: dict = {}
        for ph, ts_ns, tid, name, args in events:
            ev = {"ph": ph, "ts": ts_ns / 1e3, "pid": self.pid, "tid": tid,
                  "name": name}
            if args:
                ev["args"] = dict(args)
            if ph == "B":
                stacks.setdefault(tid, []).append(ev)
                out.append(ev)
            elif ph == "E":
                if stacks.get(tid):          # orphan E: its B was evicted
                    stacks[tid].pop()
                    out.append(ev)
            else:
                out.append(ev)
        # close spans still open at export time (or whose E was evicted):
        # synthetic E events keep every B balanced
        tail_ts = max((e["ts"] for e in out if e["ph"] != "M"), default=0.0)
        for tid, open_bs in stacks.items():
            for ev in reversed(open_bs):
                out.append({"ph": "E", "ts": tail_ts, "pid": self.pid,
                            "tid": tid, "name": ev["name"]})
        return {"traceEvents": out}

    def save(self, path=None) -> Optional[pathlib.Path]:
        """Write this process's shard (``trace_<pid>.json``)."""
        if path is None:
            if self.dir is None:
                return None
            path = self.dir / f"trace_{self.pid}.json"
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.export()))
        return path


# ---------------------------------------------------------------------------
# module-level tracer (the API every instrumented site uses)
# ---------------------------------------------------------------------------

_tracer = _NULL_TRACER
_atexit_registered = False


def get_tracer():
    return _tracer


def trace_dir() -> Optional[pathlib.Path]:
    """The enabled tracer's output directory (None when disabled or
    memory-only); ``GLMSolver`` opens its convergence stream there."""
    return _tracer.dir


def span(name: str, args: Optional[dict] = None):
    """``with obs.trace.span("solver/superstep"): ...``, the one call
    sites make; free when tracing is disabled."""
    return _tracer.span(name, args)


def instant(name: str, args: Optional[dict] = None):
    _tracer.instant(name, args)


def traced(name: Optional[str] = None):
    """Decorator form: ``@traced("ckpt/save")``.  Resolves the tracer at
    CALL time, so decorating is safe before ``enable()``."""
    def deco(fn):
        span_name = name or fn.__qualname__

        def wrapper(*args, **kwargs):
            with _tracer.span(span_name):
                return fn(*args, **kwargs)
        wrapper.__name__ = fn.__name__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__doc__ = fn.__doc__
        wrapper.__wrapped__ = fn
        return wrapper
    return deco


def _save_at_exit():
    if _tracer.enabled and _tracer.dir is not None:
        _tracer.save()
        from repro_torch.obs import metrics as _metrics
        _metrics.save_default(_tracer.dir)


def enable(dir=None, **kwargs) -> Tracer:
    """Switch the module tracer on (a second call replaces the tracer).
    With ``dir`` the shard (and the default metrics registry) is saved
    there at interpreter exit, if the tracer is still enabled then."""
    global _tracer, _atexit_registered
    _tracer = Tracer(dir, **kwargs)
    if dir is not None and not _atexit_registered:
        atexit.register(_save_at_exit)
        _atexit_registered = True
    return _tracer


def disable():
    global _tracer
    _tracer = _NULL_TRACER


# ---------------------------------------------------------------------------
# multi-process merge (coordinator side)
# ---------------------------------------------------------------------------


def merge_traces(paths, out=None) -> dict:
    """Combine per-process shards into ONE Perfetto-loadable trace.

    Shards are keyed by their pid lanes already; the merge concatenates
    event streams and keeps every metadata record, so the merged file
    shows one named lane per process.  ``out`` (optional) writes the
    merged JSON there."""
    events = []
    for p in paths:
        data = json.loads(pathlib.Path(p).read_text())
        events.extend(data.get("traceEvents", []))
    # metadata first, then by timestamp: a sorted file is diffable
    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
    merged = {"traceEvents": events}
    if out is not None:
        out = pathlib.Path(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(merged))
    return merged


def merge_dir(dir, out=None) -> Optional[pathlib.Path]:
    """Merge every ``trace_*.json`` shard under ``dir`` into
    ``trace_merged.json`` (or ``out``); returns the merged path, or None
    when the directory holds no shards."""
    dir = pathlib.Path(dir)
    shards = sorted(p for p in dir.glob("trace_*.json")
                    if p.name != "trace_merged.json")
    if not shards:
        return None
    out = pathlib.Path(out) if out is not None else dir / "trace_merged.json"
    merge_traces(shards, out)
    return out


# REPRO_TRACE=dir in the environment enables tracing at import: worker
# processes inherit it, so every process of a job traces into the same
# directory with no wiring per call
if os.environ.get(TRACE_ENV):
    enable(os.environ[TRACE_ENV])
