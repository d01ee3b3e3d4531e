#!/usr/bin/env python3
"""Where a superstep's time goes on the card: torch.profiler over a few
supersteps of the fits that ``chip_smoke.py`` runs, built by its
``full_size_data`` and ``full_size_solver``.

    python3 profile_superstep.py [--out DIR] [--steps N] [--cells A,B]
    python3 profile_superstep.py --unprofiled R [--checkout DIR] [--cells A,B]

Needs a CUDA card and ``nvcc`` (the kernels build at first use).  For each
fit (sparse: the 131072 x 16384 brick layout; dense: 400000 x 2000; dense
Jacobi: the same data through the fused superstep, in fp32 and with
precision="bf16", and through the unfused Jacobi one) it profiles a
one-superstep warm-up fit and throws it away, then N supersteps
(``chip_smoke.profiled_fit``), and prints one JSON line with the host
seconds per superstep, the device time per superstep summed over kernels
and copies, the device's idle share (1 - device time / host time; one
stream, so kernels do not overlap), the CUDA kernel launches and the
copies and fills per superstep, and the kernels by device time.
The Chrome traces go to DIR when given.

The device records are held against the kernels' own launch counts
(``ops.launch_counts``) over the same supersteps: each CUDA function of
``ops.CUDA_FUNCTIONS`` must have one record for every logical launch of
its kernel (either mode), and the device must have one kernel record for
every launch call the host made (``repro_torch.analysis.audit``'s
``record_check``).  A cell whose records fall short or run over is reported
(``launch_check``) and the script exits non-zero after the last cell: a
profile that lost device records would understate the device time.
(``tools/profile_records.py`` showed where records went: see
``chip_smoke.profiled_fit``.)

With ``--unprofiled R`` nothing is traced: each cell runs a
one-superstep warm-up fit, then R fits of N supersteps, and its line
gives each fit's host seconds a superstep (``history["step_s"]``), as
``chip_smoke.py`` reports them.  ``--checkout DIR`` then imports
``repro_torch`` from DIR/src, so that two checkouts are compared by
running the script for each in turns (a, b, b, a) in one call.
``--cells`` picks cells by name (sparse, dense, dense_jacobi,
dense_jacobi_bf16, dense_jacobi_unfused).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the fits' data, solver, lam1 and names)


def device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def launch_check(torch, prof, logical) -> dict:
    """{CUDA function: [device records, logical launches]} for the
    functions of ``ops.CUDA_FUNCTIONS`` whose two counts differ, and under
    "all kernels" [device kernel records, host launch calls] if those
    differ (empty: all agree); ``repro_torch.analysis.audit.record_check``,
    the rule the audit holds the card to."""
    from repro_torch.analysis import audit
    return audit.record_check(prof, logical)


def profile_fit(torch, solver, steps, out, tag):
    from torch.autograd import DeviceType

    from repro_torch.analysis import audit

    lam1 = chip_smoke.LAM1_FRACTION * solver.lambda_max()
    prof, res, wall, logical = chip_smoke.profiled_fit(torch, solver, lam1,
                                                       steps)
    n = res.n_iter
    rows = []
    launches = copies = 0
    for evt in prof.key_averages():
        # device-side events only (kernels, copies, fills): the host ops
        # that launched them carry the same time again
        if evt.device_type != DeviceType.CUDA:
            continue
        name = audit.short_name(evt.key)
        if name.startswith("ProfilerStep"):
            continue      # the schedule's step ranges, not device work
        if name.startswith(("Memcpy", "Memset")):
            copies += evt.count
        else:
            launches += evt.count
        us = device_us(evt)
        if us > 0:
            rows.append((name, us, evt.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"trace_{tag}.json"))
    wall_ms = wall * 1e3
    return {
        "cell": tag, "supersteps": n,
        "launch_check": launch_check(torch, prof, logical),
        "logical_launches": {k: v for k, v in logical.items() if v},
        "host_ms_per_superstep": wall_ms / n,
        "device_ms_per_superstep": busy_ms / n if rows else None,
        "device_idle_share": 1.0 - busy_ms / wall_ms if rows else None,
        "cuda_launches_per_superstep": launches / n,
        "copies_per_superstep": copies / n,
        "kernels": [{"name": name, "ms_per_superstep": us / 1e3 / n,
                     "launches_per_superstep": cnt / n,
                     "share_of_device": us / 1e3 / busy_ms}
                    for name, us, cnt in rows[:10]],
    }


def unprofiled_fits(solver, steps, repeats, tag, checkout) -> dict:
    """Host seconds a superstep of ``repeats`` fits, after a warm-up."""
    lam1 = chip_smoke.LAM1_FRACTION * solver.lambda_max()
    solver.fit(lam1=lam1, max_outer=1)
    runs = [solver.fit(lam1=lam1, max_outer=steps, tol=0.0).history["step_s"]
            for _ in range(repeats)]
    flat = [t for r in runs for t in r]
    return {"cell": tag, "checkout": checkout, "supersteps": steps,
            "superstep_s": runs, "min_s": min(flat), "max_s": max(flat),
            "median_s": sorted(flat)[len(flat) // 2]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--cells", default=None)
    ap.add_argument("--unprofiled", type=int, default=0)
    ap.add_argument("--checkout", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if args.checkout is not None and not args.unprofiled:
        sys.exit("profile_superstep: --checkout needs --unprofiled (the "
                 "record check knows this checkout's CUDA functions only)")
    sys.path.insert(0, str((args.checkout or REPO).resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_superstep: no CUDA device is available")
    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.core.solver import GLMSolver
    from repro_torch.data import synthetic

    # the solver turns TF32 off itself
    dev = torch.device("cuda", 0)
    cells = (("sparse", "sparse", None), ("dense", "dense", None),
             ("dense_jacobi", "dense", DGLMNETConfig(coupling="jacobi")),
             ("dense_jacobi_bf16", "dense",
              DGLMNETConfig(coupling="jacobi", precision="bf16")),
             ("dense_jacobi_unfused", "dense",
              DGLMNETConfig(coupling="jacobi", fuse_superstep=False)))
    if args.cells is not None:
        want = args.cells.split(",")
        unknown = set(want) - {c[0] for c in cells}
        if unknown:
            sys.exit(f"profile_superstep: unknown cells {sorted(unknown)}")
        cells = tuple(c for c in cells if c[0] in want)
    ds, ds_kind = None, None
    failed = []
    for tag, kind, config in cells:
        if kind != ds_kind:        # the dense data serves four cells
            ds = None              # free the old data before making the new
            ds, ds_kind = chip_smoke.full_size_data(synthetic, kind), kind
        solver = chip_smoke.full_size_solver(GLMSolver, ds, dev, config)
        if args.unprofiled:
            rec = unprofiled_fits(solver, args.steps, args.unprofiled, tag,
                                  str(args.checkout or REPO))
        else:
            rec = profile_fit(torch, solver, args.steps, args.out, tag)
        print(json.dumps(rec), flush=True)
        if rec.get("launch_check"):
            failed.append(tag)
        del solver
        torch.cuda.empty_cache()
    if failed:
        sys.exit(f"profile_superstep: device records differ from the "
                 f"launch counts in {failed}")


if __name__ == "__main__":
    main()
