#!/usr/bin/env python3
"""Trace the null-model fit of ``GLMSolver.lambda_max`` superstep by
superstep on the sparse Jacobi fits of ``chip_smoke.py``.

    python3 tools/null_fit_trace.py [--checkout DIR] [--tag NAME] [--plain]
                                    [--out FILE]

Needs a CUDA card and nvcc.  Imports ``repro_torch`` from DIR/src
(default: this checkout), so two checkouts are compared by running the
script once for each, in one call on one card.  For the sparse data of
``chip_smoke.full_size_data`` it builds the fused Jacobi solver in fp32
and with ``precision="bf16"`` (``chip_smoke.full_size_solver``) and calls
``lambda_max()``, recording after every superstep of its null-model fit
(the intercept alone, lam1 = lam2 = 0, up to 50 supersteps) the objective
f, the chosen alpha and the intercept, the two sides of the line search's
test of the unit step (Armijo: f at alpha = 1 against f_before + sigma D,
and whether it passed), and the stop test the solver makes there:
|f_prev - f| against tol max(1, |f|).  With ``--plain`` the fits
run a second time with K4 (``alpha_search``) replaced by its plain
version (``kernels/ref.py``) on the same card tensors, every other
kernel as it is: a line search in another order of sums.  Prints one JSON
line a fit (its ``lambda_max`` and its steps) and appends them to FILE.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the fits' data and solver)


def trace(torch, np, solver) -> dict:
    """lambda_max of a fresh solver, with its null-model fit's steps."""
    from repro_torch.core.solver import _PF_EPS

    pen = solver._penf_host > _PF_EPS
    b0_idx = torch.from_numpy(np.flatnonzero(~pen)).to(solver.device)
    tol, sigma = solver.config.tol, solver.config.sigma
    inner = solver._superstep
    steps = []

    def superstep(*args, **kwargs):
        state, m = inner(*args, **kwargs)
        f = float(m["f"].to(torch.float64))
        f_prev = steps[-1]["f"] if steps else None
        f_before, D = (float(m[k].to(torch.float64)) for k in ("f_before",
                                                                "D"))
        steps.append({
            "f": f, "alpha": float(m["alpha"]),
            "b0": state.beta[b0_idx].tolist(),
            "df": None if f_prev is None else abs(f_prev - f),
            "stop_bar": tol * max(1.0, abs(f)),
            # Armijo's test of the unit step: f(alpha = 1) against
            # f_before + sigma D (f is that loss when the step is taken)
            "f_before": f_before, "D": D,
            "armijo_bar": f_before + sigma * D,
            "accepted_unit": bool(m["accepted_unit"])})
        return state, m

    solver._superstep = superstep
    lmax = solver.lambda_max()
    solver._superstep = inner
    return {"lambda_max": lmax, "n_steps": len(steps), "tol": tol,
            "steps": steps}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkout", type=pathlib.Path, default=REPO)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(args.checkout.resolve() / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("null_fit_trace: no CUDA device is available")
    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.core.solver import GLMSolver
    from repro_torch.data import synthetic
    from repro_torch.kernels import alpha_search, ref

    def plain_k4(y, xb, xdb, weights, alphas, family, offset=None):
        return ref.alpha_search(y, xb, xdb, weights, alphas, family,
                                offset=offset)

    dev = torch.device("cuda", 0)
    ds = chip_smoke.full_size_data(synthetic, "sparse")
    lines = []
    kernel_launch = alpha_search.launch
    for k4 in ("kernel", "plain") if args.plain else ("kernel",):
        alpha_search.launch = kernel_launch if k4 == "kernel" else plain_k4
        for prec in ("fp32", "bf16"):
            solver = chip_smoke.full_size_solver(GLMSolver, ds, dev,
                                                 DGLMNETConfig(
                                                     coupling="jacobi",
                                                     precision=prec))
            rec = {"checkout": args.tag or str(args.checkout),
                   "fit": f"sparse_jacobi_{prec}", "k4": k4,
                   **trace(torch, np, solver)}
            lines.append(rec)
            print(json.dumps(rec), flush=True)
            del solver
            torch.cuda.empty_cache()
    alpha_search.launch = kernel_launch
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("a") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
