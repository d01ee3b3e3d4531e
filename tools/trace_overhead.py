#!/usr/bin/env python3
"""Split the cost of tracing a sparse superstep into its parts.

    python3 tools/trace_overhead.py [--turns 3] [--steps 5] [--out FILE]

Needs a CUDA card and nvcc.  On the sparse fit of ``chip_smoke.py``
(``full_size_data("sparse")``, 65 tiles of 256) it runs fits of
``--steps`` supersteps at the smoke's lam1 under each of these setups, in
turns (the list rotated each turn, ``--turns`` times):

  off          no tracer, no convergence stream
  spans        ``Tracer(profiler_annotations=False)``: ring-buffer events
  spans_rf     spans and ``record_function`` ranges, no NVTX
  spans_nvtx   spans, ``record_function`` and NVTX ranges (the default)
  stream       a convergence stream in $TMPDIR, no tracer
  stream_shm   the same stream in /dev/shm (memory), no tracer
  all          the default tracer and the $TMPDIR stream

and records each superstep's ``step_s``, the host us of its
``solver/superstep`` span where there is one, and the garbage
collector's pauses during the fit.  Then it times each part alone, 2,000
times: a span of each tracer kind, one ``record_function`` range, one
NVTX push and pop, one stream event in $TMPDIR and in /dev/shm.  Prints
one JSON object (and appends it to FILE).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import pathlib
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))
import chip_smoke  # noqa: E402  (the fit's data and solver)

SETUPS = ("off", "spans", "spans_rf", "spans_nvtx", "stream", "stream_shm",
          "all")
PART_REPS = 2000


def stats(xs) -> dict:
    xs = sorted(xs)
    if not xs:
        return {}
    return {"n": len(xs), "p50": xs[len(xs) // 2],
            "p99": xs[min(len(xs) - 1, int(0.99 * len(xs)))],
            "max": xs[-1], "mean": sum(xs) / len(xs)}


class GCPauses:
    """Seconds of each garbage-collector pass while installed."""

    def __init__(self):
        self.pauses, self._t0 = [], None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t0))
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def run_setup(torch, solver, lam1, steps, setup, tmp, shm):
    from repro_torch.obs import convergence, trace

    stream = None
    if setup in ("spans", "spans_rf", "spans_nvtx", "all"):
        tr = trace.enable(profiler_annotations=setup != "spans")
        if setup == "spans_rf":
            tr._nvtx = None
    if setup in ("stream", "stream_shm", "all"):
        where = shm if setup == "stream_shm" else tmp
        stream = convergence.ConvergenceStream(
            pathlib.Path(where) / f"{setup}.jsonl")
        solver.set_convergence_stream(stream)
    try:
        with GCPauses() as gcp:
            res = solver.fit(lam1=lam1, max_outer=steps, tol=0.0)
            torch.cuda.synchronize()
        spans = [e for e in trace.get_tracer().export()["traceEvents"]
                 if e["name"] == "solver/superstep" and e["ph"] in "BE"]
    finally:
        trace.disable()
        solver.set_convergence_stream(None)
        if stream is not None:
            stream.close()
    span_us = [e["ts"] - b["ts"] for b, e in zip(spans[::2], spans[1::2])]
    return {"setup": setup, "step_ms": [s * 1e3 for s in
                                        res.history["step_s"]],
            "span_us": span_us,
            "gc_ms": [(g, p * 1e3) for g, p in gcp.pauses]}


def time_parts(torch, tmp, shm) -> dict:
    from repro_torch.obs import convergence, trace

    def each(fn):
        out = []
        for _ in range(PART_REPS):
            t0 = time.perf_counter_ns()
            fn()
            out.append((time.perf_counter_ns() - t0) / 1e3)
        return stats(out)

    def span_of(tr):
        def fn():
            with tr.span("part/span"):
                pass
        return fn

    def rf():
        with torch.profiler.record_function("part/rf"):
            pass

    def nvtx():
        torch.cuda.nvtx.range_push("part/nvtx")
        torch.cuda.nvtx.range_pop()

    out = {"span_disabled_us": each(span_of(trace.NullTracer())),
           "span_plain_us": each(span_of(trace.Tracer(
               profiler_annotations=False))),
           "span_default_us": each(span_of(trace.Tracer())),
           "record_function_us": each(rf), "nvtx_push_pop_us": each(nvtx)}
    event = dict(step=1, outer_it=1, lam1=1.0, lam2=0.0, f=1.0, loss=1.0,
                 deviance=1.0, alpha=1.0, mu=1.0, nnz=1, accepted_unit=1.0,
                 active_size=1, supersteps=1, sweep_tile_launches=65,
                 sweep_tiles_skipped=0, step_us=20000.0)
    for tag, where in (("tmp", tmp), ("shm", shm)):
        with convergence.ConvergenceStream(
                pathlib.Path(where) / f"parts_{tag}.jsonl") as s:
            out[f"stream_emit_{tag}_us"] = each(lambda: s.emit(**event))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("trace_overhead: needs a CUDA device", file=sys.stderr)
        return 3
    from repro_torch.core.solver import GLMSolver
    from repro_torch.data import synthetic
    from repro_torch.kernels import build

    build.build()
    dev = torch.device("cuda", 0)
    ds = chip_smoke.full_size_data(synthetic, "sparse")
    solver = chip_smoke.full_size_solver(GLMSolver, ds, dev)
    lam1 = chip_smoke.LAM1_FRACTION * solver.lambda_max()
    solver.fit(lam1=lam1, max_outer=2)          # warm-up
    shm_root = "/dev/shm" if os.path.isdir("/dev/shm") else None
    runs = []
    with tempfile.TemporaryDirectory() as tmp, \
            tempfile.TemporaryDirectory(dir=shm_root) as shm:
        for turn in range(args.turns):
            order = SETUPS[turn % len(SETUPS):] + SETUPS[:turn % len(SETUPS)]
            for setup in order:
                runs.append(dict(turn=turn, **run_setup(
                    torch, solver, lam1, args.steps, setup, tmp, shm)))
        parts = time_parts(torch, tmp, shm)
    summary = {}
    for setup in SETUPS:
        steps = [x for r in runs if r["setup"] == setup
                 for x in r["step_ms"][1:]]
        summary[setup] = {"step_ms": stats(steps),
                          "gc_passes": sum(len(r["gc_ms"]) for r in runs
                                           if r["setup"] == setup),
                          "gc_ms_total": sum(p for r in runs
                                             if r["setup"] == setup
                                             for _, p in r["gc_ms"])}
    smi = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rec = {"card": smi, "tmpdir": tempfile.gettempdir(),
           "shm": shm_root, "steps": args.steps, "turns": args.turns,
           "summary": summary, "parts": parts, "runs": runs,
           "n_gc_objects": len(gc.get_objects())}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
