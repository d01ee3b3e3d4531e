"""Trace/metrics/convergence summarizer: ``python -m
repro_torch.launch.trace_report DIR``.

The port's copy of ``repro.launch.trace_report``.  A traced run
(``REPRO_TRACE=dir`` or ``repro_torch.obs.trace.enable(dir)``) leaves three
artifact families in one directory:

  * ``trace_<pid>.json`` shards (+ ``trace_merged.json``) — Chrome
    trace-event spans, one pid lane per process;
  * ``metrics_<pid>.json`` — counter/gauge/histogram snapshots;
  * ``convergence_<pid>.jsonl`` — the solver's per-superstep event
    stream.

This CLI digests them into the terminal summary an operator wants BEFORE
opening Perfetto: top spans by total time, per-process phase attribution
(which node is slow, and in WHICH phase), merged metrics, and the
convergence tail.  The files are the JAX package's, so a directory that
either package wrote reads here.  ``--bench PATH`` also writes a
one-row summary there (nowhere unless asked).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

from repro_torch.obs import convergence as conv_lib
from repro_torch.obs import metrics as metrics_lib
from repro_torch.timing import percentiles

# span-name prefix -> diagnosis phase bucket (everything else: "other")
_PHASE_OF_SPAN = {
    "solver/superstep": "compute",
    "solver/stream_stats": "compute",
    "solver/stream_sweep": "compute",
    "solver/stream_line_search": "compute",
    "solver/fault_sleep": "injected_wait",
    "io/parse_chunk": "io",
    "io/prefetch_produce": "io",
    "ckpt/save": "checkpoint",
    "ckpt/commit": "checkpoint",
    "ckpt/restore": "checkpoint",
    "serve/flush": "serve",
}


def _iter_spans(trace: dict):
    """Yield (pid, tid, name, dur_us) for every balanced B/E pair."""
    stacks: dict = {}
    for ev in trace.get("traceEvents", []):
        ph = ev.get("ph")
        if ph == "B":
            stacks.setdefault((ev["pid"], ev["tid"]), []).append(ev)
        elif ph == "E":
            st = stacks.get((ev["pid"], ev["tid"]))
            if st:
                b = st.pop()
                yield (ev["pid"], ev["tid"], b["name"],
                       max(ev["ts"] - b["ts"], 0.0))


def load_spans(dir: pathlib.Path):
    """All spans across every shard (prefers the per-pid shards; falls
    back to ``trace_merged.json`` when only the merge exists)."""
    shards = sorted(p for p in dir.glob("trace_*.json")
                    if p.name != "trace_merged.json")
    if not shards:
        merged = dir / "trace_merged.json"
        shards = [merged] if merged.exists() else []
    spans = []
    for p in shards:
        spans.extend(_iter_spans(json.loads(p.read_text())))
    return spans


def span_table(spans) -> list:
    """Per-name totals sorted by total time: the 'where did the wall go'
    table."""
    by_name: dict = {}
    for _, _, name, dur in spans:
        by_name.setdefault(name, []).append(dur)
    rows = []
    for name, durs in by_name.items():
        pct = percentiles(durs)
        rows.append({"span": name, "count": len(durs),
                     "total_ms": round(sum(durs) / 1e3, 3),
                     "p50_us": round(pct["p50"], 1),
                     "p99_us": round(pct["p99"], 1)})
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def phase_attribution(dir: pathlib.Path, spans) -> dict:
    """Per-process µs by diagnosis phase.

    The convergence streams carry the solver's own per-phase attribution
    (``phase_us``: a streaming superstep's pass spans in the port; the
    reference's probe and fault-plan phases too); span buckets fill in the
    io/checkpoint/serve side.  A node whose excess shows up under compute
    is an ALB problem; under network/io it is not."""
    per_pid: dict = {}
    for pid, _, name, dur in spans:
        bucket = _PHASE_OF_SPAN.get(name, "other")
        per_pid.setdefault(pid, {})[bucket] = \
            per_pid.setdefault(pid, {}).get(bucket, 0.0) + dur
    for conv in sorted(dir.glob("convergence_*.jsonl")):
        pid = conv.stem.split("_", 1)[1]
        pid = int(pid) if pid.isdigit() else pid
        slot = per_pid.setdefault(pid, {})
        for ev in conv_lib.read_events(conv):
            for phase, us in (ev.get("phase_us") or {}).items():
                key = f"solver.{phase}"
                slot[key] = slot.get(key, 0.0) + float(us)
    return {str(pid): {k: round(v, 1) for k, v in sorted(d.items())}
            for pid, d in sorted(per_pid.items())}


def merged_metrics(dir: pathlib.Path):
    snaps = [json.loads(p.read_text())
             for p in sorted(dir.glob("metrics_*.json"))]
    return metrics_lib.merge_all(snaps) if snaps else None


def convergence_summary(dir: pathlib.Path):
    streams = sorted(dir.glob("convergence_*.jsonl"))
    if not streams:
        return None
    events = []
    for p in streams:
        events.extend(conv_lib.read_events(p))
    if not events:
        return None
    events.sort(key=lambda e: (e.get("step") or 0))
    last = events[-1]
    return {
        "n_events": len(events),
        "n_streams": len(streams),
        "final_f": last.get("f"),
        "final_nnz": last.get("nnz"),
        "lam_points": len({e.get("lam_index") for e in events}),
        "supersteps": last.get("supersteps"),
        "sweep_tile_launches": last.get("sweep_tile_launches"),
        "sweep_tiles_skipped": last.get("sweep_tiles_skipped"),
        "mean_step_us": round(
            sum(e["step_us"] for e in events
                if e.get("step_us")) / max(
                sum(1 for e in events if e.get("step_us")), 1), 1),
    }


def summarize(dir) -> dict:
    dir = pathlib.Path(dir)
    spans = load_spans(dir)
    return {
        "dir": str(dir),
        "n_spans": len(spans),
        "spans": span_table(spans),
        "phase_attribution": phase_attribution(dir, spans),
        "metrics": merged_metrics(dir),
        "convergence": convergence_summary(dir),
    }


def _print_summary(s: dict):
    print(f"== trace report: {s['dir']} ({s['n_spans']} spans) ==")
    if s["spans"]:
        print("\n-- top spans (by total time) --")
        print(f"{'span':32} {'count':>7} {'total_ms':>10} "
              f"{'p50_us':>9} {'p99_us':>9}")
        for r in s["spans"][:12]:
            print(f"{r['span']:32} {r['count']:>7} {r['total_ms']:>10} "
                  f"{r['p50_us']:>9} {r['p99_us']:>9}")
    if s["phase_attribution"]:
        print("\n-- per-process phase attribution (µs) --")
        for pid, phases in s["phase_attribution"].items():
            parts = ", ".join(f"{k}={v:.0f}" for k, v in phases.items())
            print(f"  pid {pid}: {parts}")
    m = s["metrics"]
    if m:
        print("\n-- merged metrics --")
        for name, v in sorted(m.get("counters", {}).items()):
            print(f"  counter {name} = {v}")
        for name, g in sorted(m.get("gauges", {}).items()):
            print(f"  gauge   {name} = {g['value']}")
        for name, h in sorted(m.get("histograms", {}).items()):
            p50 = metrics_lib.snapshot_quantile(h, 50)
            p99 = metrics_lib.snapshot_quantile(h, 99)
            fmt = lambda v: "-" if v is None else f"{v:.3g}"
            print(f"  hist    {name}: n={h['n']} "
                  f"p50~{fmt(p50)} p99~{fmt(p99)}")
    c = s["convergence"]
    if c:
        print("\n-- convergence --")
        print(f"  {c['n_events']} events / {c['n_streams']} stream(s); "
              f"final f={c['final_f']} nnz={c['final_nnz']} "
              f"supersteps={c['supersteps']} "
              f"mean_step_us={c['mean_step_us']}")


def _disabled_overhead_us(n: int = 1000) -> float:
    """Median cost of one DISABLED span (the null tracer is disabled mode
    whatever the module tracer's state), the 5 µs contract, measured on
    the machine that writes the row."""
    from repro_torch.obs import trace as trace_lib
    null = trace_lib._NULL_TRACER
    samples = []
    for _ in range(n):
        t0 = time.perf_counter_ns()
        with null.span("bench/noop"):
            pass
        samples.append((time.perf_counter_ns() - t0) / 1e3)
    return round(percentiles(samples)["p50"], 3)


def bench_row(s: dict) -> dict:
    """The one-row summary that ``--bench`` writes (the reference's
    ``results/benchmarks/obs.json`` layout)."""
    c = s.get("convergence") or {}
    top = s["spans"][0] if s["spans"] else {}
    return {
        "figure": "obs",
        "rows": [{
            "case": "traced_fit",
            "n_spans": s["n_spans"],
            "span_names": len(s["spans"]),
            "top_span": top.get("span"),
            "top_span_total_ms": top.get("total_ms"),
            "conv_events": c.get("n_events"),
            "supersteps": c.get("supersteps"),
            "mean_step_us": c.get("mean_step_us"),
            "final_f": c.get("final_f"),
            "disabled_span_overhead_us": _disabled_overhead_us(),
        }],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir", help="trace/metrics/convergence directory")
    ap.add_argument("--json", default="",
                    help="also write the full summary as JSON here")
    ap.add_argument("--bench", default="",
                    help="also write a one-row summary (the reference's "
                    "obs.json layout) here")
    args = ap.parse_args(argv)
    d = pathlib.Path(args.dir)
    if not d.is_dir():
        print(f"trace_report: {d} is not a directory", file=sys.stderr)
        return 2
    s = summarize(d)
    _print_summary(s)
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(s, indent=2))
    if args.bench:
        out = pathlib.Path(args.bench)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(bench_row(s), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
