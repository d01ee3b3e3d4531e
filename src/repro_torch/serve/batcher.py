"""Micro-batching request frontend (mirrors ``repro.serve.batcher``).

Scoring one row on its own launch costs a fixed dispatch and launch
overhead that dwarfs the per-row work of a compacted GLM dot, so serving
each request alone caps throughput near 1 / overhead.  The micro-batcher
amortizes it: requests queue; a flusher coalesces the queue into ONE padded
batch per engine launch, flushing when the batch bucket fills or the oldest
request's deadline expires.

**Shape buckets.**  A flushed batch is padded up to the smallest (batch
bucket, nnz bucket) that fits, from the grids given at construction, so
the engine sees at most ``len(batch_buckets) x len(nnz_buckets)`` shapes
per kind (``warmup()`` visits all of them; ``engine.compile_count`` counts
them).  A request whose nnz exceeds the largest bucket is padded to its own
nnz (a rare outsized launch, never an error).

**Instrumentation.**  Per-request latency is measured submit -> result (the
engine call goes through ``repro_torch.timing.timed``, which waits for the
card); ``stats()`` reports p50/p99 latency, rows/s, batch occupancy and the
shape count.  ``score_one`` is the batch-1 baseline: one real engine call
per request through the same padding.  The process metrics registry
(``repro_torch.obs.metrics``) gets the ``serve.queue_depth`` gauge, the
``serve.latency_ms`` histogram and the ``serve.flush.{full,deadline,close}``
counters, and a trace the ``serve/flush`` span around each engine call.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.timing import percentiles, timed

DEFAULT_BATCH_BUCKETS = (1, 4, 16, 64)
DEFAULT_NNZ_BUCKETS = (8, 32, 128)


def _bucket_up(x: int, buckets) -> int:
    """Smallest bucket ≥ x; the largest bucket caps the batch dimension,
    while an outsized nnz falls through to its own size."""
    for b in buckets:
        if x <= b:
            return b
    return x


class _Pending:
    """One queued request and its completion event."""

    __slots__ = ("idx", "val", "offset", "t_submit", "event", "result",
                 "error", "t_done")

    def __init__(self, idx, val, offset):
        self.idx = idx
        self.val = val
        self.offset = offset
        self.t_submit = time.perf_counter()
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t_done = None

    def get(self, timeout: Optional[float] = None):
        if not self.event.wait(timeout):
            raise TimeoutError("request was not served before the timeout")
        if self.error is not None:
            raise self.error
        return self.result


class MicroBatcher:
    """Coalesces single-row sparse requests into bucketed engine launches.

    Args:
      engine: a ``ScoringEngine``.
      max_delay_ms: deadline — a queued request waits at most this long
        before a (possibly underfull) flush.
      batch_buckets / nnz_buckets: increasing padded-shape grids; their
        product bounds the compiled-program set (see module docstring).
      kind: "response" (inverse link, default) or "link" (raw margins).

    Use as a context manager (or call ``close()``): a background flusher
    thread drives the queue.  ``submit`` returns a handle whose ``get()``
    blocks for the (K,) output row.
    """

    def __init__(self, engine, *, max_delay_ms: float = 2.0,
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
                 nnz_buckets: Sequence[int] = DEFAULT_NNZ_BUCKETS,
                 kind: str = "response"):
        if list(batch_buckets) != sorted(set(batch_buckets)) or \
                list(nnz_buckets) != sorted(set(nnz_buckets)):
            raise ValueError("buckets must be strictly increasing")
        self.engine = engine
        self.max_delay = max_delay_ms / 1e3
        self.batch_buckets = tuple(int(b) for b in batch_buckets)
        self.nnz_buckets = tuple(int(b) for b in nnz_buckets)
        self.kind = kind
        self.max_batch = self.batch_buckets[-1]

        self._lock = threading.Condition()
        self._queue: list = []
        self._closed = False
        self._latencies: list = []
        self._batch_sizes: list = []
        self._n_failed = 0
        self._engine_s = 0.0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        # the same figures in the process metrics registry, so that
        # several batchers (and processes) aggregate
        self._m_depth = obs_metrics.gauge("serve.queue_depth")
        self._m_lat = obs_metrics.histogram("serve.latency_ms")
        self._m_flush = {r: obs_metrics.counter(f"serve.flush.{r}")
                         for r in ("full", "deadline", "close")}

        self._thread = threading.Thread(target=self._flusher, daemon=True,
                                        name="repro-serve-flusher")
        self._thread.start()

    # ------------------------------------------------------------ lifecycle

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        """Flush everything still queued, then stop the flusher."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._thread.join()

    # -------------------------------------------------------------- submit

    def submit(self, idx, val, *, offset: Optional[float] = None) -> _Pending:
        """Enqueue one sparse request (feature ids, values); returns a
        handle — ``handle.get()`` blocks until its flush completes.
        Malformed requests are rejected HERE, synchronously — a bad
        request must never reach (and kill) a coalesced flush that other
        callers' requests share."""
        idx = np.asarray(idx, np.int64).ravel()
        val = np.asarray(val, np.float32).ravel()
        if idx.shape != val.shape:
            raise ValueError(
                f"request feature ids and values disagree: {idx.shape} "
                f"vs {val.shape}")
        p = _Pending(idx, val, offset)
        with self._lock:
            # closed-check under the lock: a submit racing close() must
            # fail loudly, not enqueue after the final drain and hang
            if self._closed:
                raise RuntimeError("batcher is closed")
            was_empty = not self._queue
            self._queue.append(p)
            # wake the flusher on empty→non-empty (it sleeps untimed while
            # idle) and when a full batch is ready
            if was_empty or len(self._queue) >= self.max_batch:
                self._lock.notify_all()
        return p

    def score_one(self, idx, val, *, offset: Optional[float] = None):
        """The batch-1 baseline: one real engine call for this one request,
        through the same nnz bucketing, no coalescing."""
        nnz = _bucket_up(max(len(idx), 1), self.nnz_buckets)
        off = None if offset is None else np.asarray([offset], np.float32)
        out = self.engine.score_sparse([(idx, val)], kind=self.kind,
                                       nnz_pad=nnz, offset=off)
        return out[0]

    def warmup(self):
        """Score one empty batch of every (batch bucket, nnz bucket) shape,
        so the kernels are built and every shape has been seen before
        traffic arrives.  A ``kind="response"`` batcher also warms the
        "link" shapes: offset-bearing requests are scored as margins first
        (the offset applies before the inverse link)."""
        kinds = ("link", self.kind) if self.kind != "link" else ("link",)
        for kind in kinds:
            for nb in self.nnz_buckets:
                for bb in self.batch_buckets:
                    slots = np.full((bb, nb), self.engine.n_active, np.int32)
                    vals = np.zeros((bb, nb), np.float32)
                    self.engine.score_packed(slots, vals, kind=kind)

    # ------------------------------------------------------------- flushing

    def _flusher(self):
        while True:
            with self._lock:
                # idle: sleep UNTIMED — submit()/close() wake us, so an
                # idle server burns zero CPU (no 1/max_delay polling)
                while not self._queue and not self._closed:
                    self._lock.wait()
                if not self._queue:
                    if self._closed:
                        return
                    continue
                oldest = self._queue[0].t_submit
                now = time.perf_counter()
                deadline = oldest + self.max_delay
                # wait for a full batch or the oldest request's deadline
                while (len(self._queue) < self.max_batch
                       and not self._closed and now < deadline):
                    self._lock.wait(timeout=deadline - now)
                    now = time.perf_counter()
                # why this flush fired: the loop's exit conditions in order
                reason = "full" if len(self._queue) >= self.max_batch \
                    else ("close" if self._closed else "deadline")
                batch = self._queue[:self.max_batch]
                del self._queue[:len(batch)]
                self._m_depth.set(len(self._queue))
            self._m_flush[reason].inc()
            try:
                self._flush(batch)
            except Exception as e:          # noqa: BLE001 — must not die
                # a failed flush errors ITS handles and the server lives:
                # the error surfaces on each waiter's get(), never as a
                # dead flusher thread silently stranding future traffic
                with self._lock:
                    self._n_failed += len(batch)
                for p in batch:
                    p.error = e
                    p.event.set()

    def _flush(self, batch):
        B = _bucket_up(len(batch), self.batch_buckets)
        nnz = max((len(p.idx) for p in batch), default=1)
        J = _bucket_up(max(nnz, 1), self.nnz_buckets)
        reqs = [(p.idx, p.val) for p in batch]
        # pad the BATCH dimension with empty requests up to the bucket
        reqs += [(np.zeros((0,), np.int64), np.zeros((0,), np.float32))] \
            * (B - len(batch))
        offs = None
        if any(p.offset is not None for p in batch):
            offs = np.zeros((B,), np.float32)
            for i, p in enumerate(batch):
                offs[i] = 0.0 if p.offset is None else float(p.offset)
        with obs_trace.span("serve/flush", args={"batch": len(batch),
                                                 "B": B, "nnz": J}):
            out, dt = timed(self.engine.score_sparse, reqs, kind=self.kind,
                            nnz_pad=J, offset=offs)
        t_done = time.perf_counter()
        with self._lock:
            self._engine_s += dt
            self._batch_sizes.append(len(batch))
            if self._t_first is None:
                self._t_first = t_done - dt
            self._t_last = t_done
            for i, p in enumerate(batch):
                p.result = out[i]
                p.t_done = t_done
                lat = t_done - p.t_submit
                self._latencies.append(lat)
                self._m_lat.observe(lat * 1e3)
                p.event.set()

    # ---------------------------------------------------------------- stats

    def stats(self) -> dict:
        """p50/p99 request latency (ms), throughput and batching telemetry
        over everything served so far."""
        with self._lock:
            lat_ms = [latency * 1e3 for latency in self._latencies]
            sizes = self._batch_sizes[:]
            wall = (self._t_last - self._t_first) \
                if self._t_last is not None else 0.0
            engine_s = self._engine_s
        n = len(lat_ms)
        pct = percentiles(lat_ms)
        return {
            "n_requests": n,
            "n_failed": self._n_failed,
            "n_batches": len(sizes),
            "mean_batch": float(np.mean(sizes)) if sizes else 0.0,
            "p50_ms": pct["p50"],
            "p99_ms": pct["p99"],
            "rows_per_s": float(n / wall) if wall > 0 else None,
            "engine_s": engine_s,
            "compiled_shapes": self.engine.compile_count,
        }
