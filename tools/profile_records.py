#!/usr/bin/env python3
"""Does torch.profiler lose device records of the port's kernels, and in
which form of profiled fit?

    python3 tools/profile_records.py [--cell dense] [--records 16]
                                     [--steps 3] [--out FILE]

Needs a CUDA card and nvcc.  Builds one of ``profile_superstep.py``'s
cells at full size (``dense``: Gauss-Seidel on 400,000 x 2,048, where a
record once came up two K2 launches short; ``sparse``; ``dense_jacobi``)
and profiles the same fit ``--records`` times in each of three forms, in
turns (the order of the forms alternates from round to round):

  one_cycle     the fit once unprofiled, then a single profiler cycle over
                the measured fit;
  warmup_cycle  a traced one-superstep fit thrown away, then the measured
                fit at once, at the start of the recording window;
  profiled_fit  ``chip_smoke.profiled_fit``, the form kept: the warm-up,
                and the host idle for a while at both edges of the window.

Each record is held against the kernels' own launch counts over the same
fit (``profile_superstep.launch_check``: each CUDA function of K1-K6 needs
one device record a logical launch), with the host's launch calls and the
device kernels counted and the first and last of each placed in time (us
from the first launch call: a device kernel placed before its launch
shows the device's times running early).  Prints one JSON line a record
and a summary line (records short, records over, per form), and writes
them to FILE when given.  Exits 0 whatever the counts: it measures, it
does not gate.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))
import chip_smoke  # noqa: E402  (the cells' data, solver and lam1)
import profile_superstep  # noqa: E402  (launch_check)
from repro_torch.analysis import audit  # noqa: E402  (launch_records)


def one_cycle(torch, solver, lam1, steps):
    """The measured fit under a single profiler cycle, after an unprofiled
    warm fit: (the profiler, the logical launch counts of the fit)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    solver.fit(lam1=lam1, max_outer=1)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver.fit(lam1=lam1, max_outer=steps, tol=0.0)
        torch.cuda.synchronize()
    return prof, ops.launch_counts()


def warmup_cycle(torch, solver, lam1, steps):
    """A traced one-superstep fit thrown away, then the measured fit at
    once: ``chip_smoke.profiled_fit`` without its idle edges."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import ops

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        solver.fit(lam1=lam1, max_outer=1)
        torch.cuda.synchronize()
        prof.step()
        ops.reset_launch_counts()
        solver.fit(lam1=lam1, max_outer=steps, tol=0.0)
        torch.cuda.synchronize()
        logical = ops.launch_counts()
    return prof, logical


def profiled_fit(torch, solver, lam1, steps):
    prof, _, _, logical = chip_smoke.profiled_fit(torch, solver, lam1, steps)
    return prof, logical


FORMS = {"one_cycle": one_cycle, "warmup_cycle": warmup_cycle,
         "profiled_fit": profiled_fit}


def timeline(prof, k: int = 4) -> dict:
    """Where a record's device kernels lie against the host's launch
    calls: both counts, and the first and last ``k`` of each as (name, us
    from the first launch call)."""
    host, dev = audit.launch_records(prof)
    t0 = host[0][0] if host else 0.0
    ends = lambda xs: [[n, round(t - t0, 1)] for t, n in xs[:k] + xs[-k:]]
    return {"host_launch_calls": len(host), "device_kernels": len(dev),
            "host_ends": ends(host), "device_ends": ends(dev)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", default="dense",
                    choices=("dense", "sparse", "dense_jacobi"))
    ap.add_argument("--records", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_records: no CUDA device is available")
    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.core.solver import GLMSolver
    from repro_torch.data import synthetic

    dev = torch.device("cuda", 0)
    kind = "sparse" if args.cell == "sparse" else "dense"
    config = DGLMNETConfig(coupling="jacobi") \
        if args.cell == "dense_jacobi" else None
    ds = chip_smoke.full_size_data(synthetic, kind)
    solver = chip_smoke.full_size_solver(GLMSolver, ds, dev, config)
    lam1 = chip_smoke.LAM1_FRACTION * solver.lambda_max()
    lines = []
    tally = {f: {"records": 0, "short": 0, "over": 0} for f in FORMS}
    for rnd in range(args.records):
        order = list(FORMS) if rnd % 2 == 0 else list(FORMS)[::-1]
        for form in order:
            t0 = time.perf_counter()
            prof, logical = FORMS[form](torch, solver, lam1, args.steps)
            bad = profile_superstep.launch_check(torch, prof, logical)
            short = any(got < want for got, want in bad.values())
            over = any(got > want for got, want in bad.values())
            t = tally[form]
            t["records"] += 1
            t["short"] += short
            t["over"] += over
            rec = {"cell": args.cell, "round": rnd, "form": form,
                   "launch_check": bad, **timeline(prof),
                   "logical_launches": {k: v for k, v in logical.items()
                                        if v},
                   "seconds": time.perf_counter() - t0}
            lines.append(rec)
            print(json.dumps(rec), flush=True)
            del prof
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    summary = {"cell": args.cell, "steps": args.steps, "tally": tally,
               "card": card}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
