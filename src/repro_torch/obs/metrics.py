"""Process-local metrics registry: counters, gauges, histograms.

A copy of ``repro.obs.metrics`` (the port imports nothing of the JAX
package); its snapshots are the same JSON, so either package's
``trace_report`` merges the other's.  Spans answer "where did the time
go"; metrics answer "how often / how much": chunk-cache hit rates, serve
flush reasons, queue depths, latency distributions.  Pure stdlib.

Semantics:

  * **Counter** — monotone sum (``inc``); merge = add.
  * **Gauge** — last-writer-wins value.  Every ``set`` stamps a
    process-local monotone sequence number; merge keeps the sample with
    the lexicographically larger ``(seq, value)``, which is associative
    and deterministic (the ordering across processes is arbitrary but
    stable — gauges are point-in-time readings, not aggregates).
  * **Histogram** — fixed upper-bound buckets chosen at registration
    (+inf overflow bucket), counts + sum + n; merge = elementwise add,
    defined only for identical bucket grids.  ``quantile(q)`` linearly
    interpolates within the winning bucket — an estimate, bounded by the
    bucket width (exact percentile math lives in
    ``repro_torch.timing``).

``snapshot()`` is plain JSON; ``merge`` folds any number of snapshots
from different processes into one (associative + commutative, so the
coordinator can fold shards in any order — ``tests/test_torch_obs.py``
pins associativity).
"""
from __future__ import annotations

import json
import pathlib
import threading
from typing import Optional, Sequence

# log-ish spaced milliseconds: micro-batching latencies to slow fits
DEFAULT_MS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 1000.0, 10_000.0)


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0):
        self.value += n


class Gauge:
    __slots__ = ("value", "seq")

    def __init__(self):
        self.value = None
        self.seq = 0

    def set(self, v: float, _seq_counter=[0]):
        _seq_counter[0] += 1
        self.seq = _seq_counter[0]
        self.value = float(v)


class Histogram:
    __slots__ = ("buckets", "counts", "sum", "n")

    def __init__(self, buckets: Sequence[float] = DEFAULT_MS_BUCKETS):
        bs = tuple(float(b) for b in buckets)
        if list(bs) != sorted(set(bs)):
            raise ValueError("histogram buckets must be strictly increasing")
        self.buckets = bs
        self.counts = [0] * (len(bs) + 1)   # +1: overflow (+inf)
        self.sum = 0.0
        self.n = 0

    def observe(self, v: float):
        v = float(v)
        lo, hi = 0, len(self.buckets)
        while lo < hi:                      # first bucket with upper >= v
            mid = (lo + hi) // 2
            if v <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.sum += v
        self.n += 1

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated q-quantile estimate (q in [0, 100])."""
        if self.n == 0:
            return None
        rank = q / 100.0 * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= rank and c > 0:
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                hi = self.buckets[i] if i < len(self.buckets) \
                    else self.buckets[-1]
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.buckets[-1]


class MetricsRegistry:
    """Named metrics, created on first use, snapshot-able as JSON."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_MS_BUCKETS) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(buckets)
            elif tuple(float(b) for b in buckets) != h.buckets:
                raise ValueError(
                    f"histogram {name!r} already registered with buckets "
                    f"{h.buckets}")
            return h

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    # ------------------------------------------------------------ snapshot

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {k: c.value
                             for k, c in sorted(self._counters.items())},
                "gauges": {k: {"value": g.value, "seq": g.seq}
                           for k, g in sorted(self._gauges.items())},
                "histograms": {
                    k: {"buckets": list(h.buckets),
                        "counts": list(h.counts),
                        "sum": h.sum, "n": h.n}
                    for k, h in sorted(self._histograms.items())},
            }

    def save(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.snapshot(), indent=2))
        return path


# ---------------------------------------------------------------------------
# snapshot merge (coordinator side)
# ---------------------------------------------------------------------------


def merge(a: dict, b: dict) -> dict:
    """Fold two snapshots; associative and commutative (see module doc)."""
    out = {"counters": dict(a.get("counters", {})),
           "gauges": {k: dict(v) for k, v in a.get("gauges", {}).items()},
           "histograms": {k: dict(v)
                          for k, v in a.get("histograms", {}).items()}}
    for k, v in b.get("counters", {}).items():
        out["counters"][k] = out["counters"].get(k, 0.0) + v
    for k, g in b.get("gauges", {}).items():
        cur = out["gauges"].get(k)
        if cur is None or (g["seq"], _ord(g["value"])) > \
                (cur["seq"], _ord(cur["value"])):
            out["gauges"][k] = dict(g)
    for k, h in b.get("histograms", {}).items():
        cur = out["histograms"].get(k)
        if cur is None:
            out["histograms"][k] = dict(h)
            continue
        if list(cur["buckets"]) != list(h["buckets"]):
            raise ValueError(f"histogram {k!r} bucket grids differ; "
                             "cannot merge")
        out["histograms"][k] = {
            "buckets": list(cur["buckets"]),
            "counts": [x + y for x, y in zip(cur["counts"], h["counts"])],
            "sum": cur["sum"] + h["sum"], "n": cur["n"] + h["n"]}
    return out


def _ord(v):
    return -float("inf") if v is None else v


def snapshot_quantile(h: dict, q: float) -> Optional[float]:
    """``Histogram.quantile`` applied to a snapshot dict (coordinator side
    works on JSON shards, not live registries)."""
    hist = Histogram(h["buckets"])
    hist.counts = list(h["counts"])
    hist.sum = float(h["sum"])
    hist.n = int(h["n"])
    return hist.quantile(q)


def merge_all(snapshots) -> dict:
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for s in snapshots:
        out = merge(out, s)
    return out


# ---------------------------------------------------------------------------
# default process-local registry
# ---------------------------------------------------------------------------

_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str,
              buckets: Sequence[float] = DEFAULT_MS_BUCKETS) -> Histogram:
    return _REGISTRY.histogram(name, buckets)


def save_default(dir) -> pathlib.Path:
    """Write the default registry's snapshot as ``metrics_<pid>.json``
    under ``dir`` (the per-process shard ``obs.trace``'s atexit hook and
    the dist workers emit)."""
    from repro_torch.obs import trace as _trace
    pid = _trace.get_tracer().pid if _trace.get_tracer().enabled \
        else _trace._default_pid()
    return _REGISTRY.save(pathlib.Path(dir) / f"metrics_{pid}.json")
