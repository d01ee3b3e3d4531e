#!/usr/bin/env python3
"""Where a superstep's time goes on the card: torch.profiler over a few
supersteps of the four fits that ``chip_smoke.py`` runs, built by its
``full_size_data`` and ``full_size_solver``.

    python3 profile_superstep.py [--out DIR] [--steps N]

Needs a CUDA card and ``nvcc`` (the kernels build at first use).  For each
fit (sparse: the 131072 x 16384 brick layout; dense: 400000 x 2000; dense
Jacobi: the same data through the fused superstep, and through the unfused
Jacobi one) it runs one untimed superstep, then N profiled ones, and
prints one JSON line with the host seconds per superstep, the device time
per superstep summed over kernels and copies, the device's idle share
(1 - device time / host time; one stream, so kernels do not overlap), the
CUDA kernel launches and the copies and fills per superstep, and the
kernels by device time.
The Chrome traces go to DIR when given.
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


def profile_fit(torch, solver, steps, out, tag):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lam1 = chip_smoke.LAM1_FRACTION * solver.lambda_max()
    solver.fit(lam1=lam1, max_outer=1)          # warm: allocator, library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = solver.fit(lam1=lam1, max_outer=steps, tol=0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = res.n_iter
    rows = []
    launches = copies = 0
    for evt in prof.key_averages():
        # device-side events only (kernels, copies, fills): the host ops
        # that launched them carry the same time again
        if evt.device_type != DeviceType.CUDA:
            continue
        name = chip_smoke.short_name(evt.key)
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO / "src"))
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
             ("dense_jacobi_unfused", "dense",
              DGLMNETConfig(coupling="jacobi", fuse_superstep=False)))
    ds, ds_kind = None, None
    for tag, kind, config in cells:
        if kind != ds_kind:        # the dense data serves two cells
            ds = None              # free the old data before making the new
            ds, ds_kind = chip_smoke.full_size_data(synthetic, kind), kind
        solver = chip_smoke.full_size_solver(GLMSolver, ds, dev, config)
        print(json.dumps(profile_fit(torch, solver, args.steps, args.out,
                                     tag)), flush=True)
        del solver
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
