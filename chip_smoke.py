#!/usr/bin/env python3
"""Drive repro_torch's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from a checkout (it imports ``src/repro_torch`` beside it) on a machine
with a CUDA card and ``nvcc``.  It builds the four hand-written CUDA kernels
of the default single-device fit from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card at the main
path's shapes and times both, then runs two full-size fits through
``GLMSolver.fit`` and checks them:

  * sparse: make_sparse(n=163840, p=16384, avg_nnz=50) -> a 131072 x 16384
    train split packed into 256 x 256 bricks (glm_stats, tile_gram,
    cd_tile_solve, alpha_search);
  * dense: make_dense(n=500000, p=2000) -> a 400000 x 2000 train split
    (glm_stats, cd_tile_solve, alpha_search; the dense tile Gram is a
    plain matrix product).

Each fit runs with every kernel's launch count set to 0 just before it and
read just after; the counts must equal the supersteps' exact needs.  A small
fit on the card is also held against the same fit on the CPU.  It prints
one JSON object per phase, the card's name and power limit, the kernel
report and, last, ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero without that line; so does a machine without a CUDA device, or a
directory without the package.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

SEED = 0
REPO = pathlib.Path(__file__).resolve().parent
H100_FP32_FLOPS = 67e12     # dense fp32 outside the tensor cores (SXM, 700 W)
H100_BYTES_PER_S = 3.35e12  # HBM3


LAM1_FRACTION = 0.05        # lam1 of the full-size fits, over lambda_max


def full_size_data(synthetic, kind: str):
    """The data set of one of the two full-size fits (``profile_superstep.py``
    profiles the same two)."""
    if kind == "sparse":
        return synthetic.make_sparse(n=163_840, p=16_384, avg_nnz=50,
                                     k_true=200, seed=SEED)
    return synthetic.make_dense(n=500_000, p=2_000, k_true=200, seed=SEED)


def full_size_solver(GLMSolver, ds, dev):
    """The solver of a full-size fit: logistic with an intercept."""
    return GLMSolver(ds.train.X, ds.train.y, family="logistic",
                     fit_intercept=True, device=dev)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call, from CUDA events around ``reps``
    calls.  A sleep kernel is queued first, so the host has queued every
    call before the card reaches the first one: a kernel shorter than its
    host-side launch is timed on the card, not at the host's launch rate
    (where ``torch.cuda._sleep`` is missing, the host rate bounds it)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    sleep = getattr(torch.cuda, "_sleep", None)
    if sleep is not None:
        sleep(100_000_000)          # ~50 ms at the H100's clock
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def errs(got, want):
    """(max |got - want|, that over max(max |want|, 1))."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1.0)


def main() -> None:
    if not (REPO / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("src/repro_torch not found beside chip_smoke.py; run it from "
             "a checkout of the repository", code=2)
    sys.path.insert(0, str(REPO / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available", code=3)
    if torch.cuda.device_count() < 1:
        fail("no CUDA device is visible", code=3)

    from repro_torch.core import linesearch
    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.core.solver import GLMSolver
    from repro_torch.data import synthetic
    from repro_torch.kernels import alpha_search as alpha_search_k
    from repro_torch.kernels import build
    from repro_torch.kernels import cd_tile_solve as cd_tile_solve_k
    from repro_torch.kernels import glm_stats as glm_stats_k
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tile_gram as tile_gram_k

    torch.manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else f"{kind}, power limit not read"

    # ---------------------------------------------------------------- setup
    t0 = time.perf_counter()
    lib = build.build()
    build_s = time.perf_counter() - t0
    build.library()
    ptxas = [ln.strip() for ln in (lib.parent / "build.log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "setup", "kernels_built": sorted(ops.KERNELS),
          "build_s": build_s, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": kind, "ptxas": ptxas})

    # --------------------------------------------- sparse problem (packing)
    t0 = time.perf_counter()
    ds = full_size_data(synthetic, "sparse")
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = full_size_solver(GLMSolver, ds, dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    design = solver.design
    n_rows, p_pad = design.shape
    nt, T, rb = design.n_tiles, design.tile_size, design.row_block
    emit({"phase": "sparse_setup", "train_shape": list(ds.train.X.shape),
          "nnz": ds.train.X.nnz, "n_rows": n_rows, "p_pad": p_pad,
          "n_tiles": nt, "row_block": rb, "n_bricks": solver.info.n_bricks,
          "occupancy": solver.info.occupancy,
          "max_bricks_per_tile": design.max_bricks_per_tile,
          "bricks_gb": design.bricks.numel() * 4 / 1e9,
          "generate_s": gen_s, "pack_and_place_s": pack_s})

    # ------------------------------------- kernels against their plain twins
    report = {}
    rng = np.random.default_rng(SEED)
    y, wobs, off = solver._ys, solver._wobs, solver._offsets
    n = n_rows
    fams = ["logistic", "squared", "probit", "poisson"]
    # tolerances on max |kernel - plain| / max(max |plain|, 1): float32
    # with the same formulas (1e-5; probit 3e-4, erfc against log_ndtr);
    # K3 and K4 are the same float32 sums in another order (1e-5); K2 is
    # rounded step by step like its plain version and must match exactly
    tol = {"glm_stats": 1e-5, "glm_stats_probit": 3e-4,
           "alpha_search": 1e-5, "cd_tile_solve": 0.0, "tile_gram": 1e-5}
    parity = {}

    def labels(fam):
        if fam == "poisson":
            return torch.from_numpy(rng.poisson(2.0, n).astype(np.float32)) \
                .to(dev)
        return y

    xb = torch.from_numpy((rng.normal(size=n) * 1.5).astype(np.float32)) \
        .to(dev)
    xdb = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    err_k1 = 0.0
    for fam in fams:
        yy = labels(fam)
        got = ops.glm_stats(yy, xb, fam, weights=wobs, offset=off)
        want = ref.glm_stats(yy, xb, wobs, fam, offset=off)
        ea = max(errs(a, b)[0] for a, b in zip(got, want))
        e = max(errs(a, b)[1] for a, b in zip(got, want))
        parity[f"glm_stats/{fam}"] = e
        check(e <= tol["glm_stats_probit" if fam == "probit"
                       else "glm_stats"], f"glm_stats {fam}: error {e}")
        err_k1 = max(err_k1, ea)
    fam = "logistic"
    k1_ms = time_ms(torch, lambda: glm_stats_k.launch(y, xb, wobs, fam,
                                                      offset=off), 200)
    k1_plain = time_ms(torch, lambda: ref.glm_stats(y, xb, wobs, fam,
                                                    offset=off), 50)
    k1_bytes = n * 4 * (4 + 3)          # y, xb, weights, offset in; 3 out
    b_ms, b_by = bound_ms(k1_bytes, n * 20)
    report["glm_stats"] = dict(ms=k1_ms, plain_ms=k1_plain, bound_ms=b_ms,
                               bound_by=b_by, library_ms=None,
                               max_abs_err=err_k1)

    alphas0 = linesearch.candidate_alphas(1e-3, 13, dev)
    bt = linesearch.backtrack_chains(alphas0[5:6], 0.5, 20)[0]
    err_k4 = 0.0
    for fam in fams:
        yy = labels(fam)
        for al in (alphas0, bt):
            got = ops.alpha_search(yy, xb, xdb, al, fam, weights=wobs,
                                   offset=off)
            want = ref.alpha_search(yy, xb, xdb, wobs, al, fam, offset=off)
            ea, e = errs(got, want)
            parity[f"alpha_search/{fam}/K={al.shape[0]}"] = e
            check(e <= tol["alpha_search"], f"alpha_search {fam}: {e}")
            err_k4 = max(err_k4, ea)
    k4_ms = time_ms(torch, lambda: alpha_search_k.launch(
        y, xb, xdb, wobs, bt, "logistic", offset=off), 200)
    k4_plain = time_ms(torch, lambda: ref.alpha_search(
        y, xb, xdb, wobs, bt, "logistic", offset=off), 50)
    K4 = bt.shape[0]
    b_ms, b_by = bound_ms(n * 4 * 5 + K4 * 8, n * K4 * 12)
    report["alpha_search"] = dict(ms=k4_ms, plain_ms=k4_plain,
                                  bound_ms=b_ms, bound_by=b_by,
                                  library_ms=None, max_abs_err=err_k4)

    # K3 on the real bricks of the fullest tile, at the first superstep's w, r
    _, s0, w0 = ops.glm_stats(y, torch.zeros_like(y), "logistic",
                              weights=wobs, offset=off)
    pops = np.diff(design.tile_ptr)
    tid = int(np.argmax(pops))
    tb, rows = design.tile_bricks(tid)
    K = tb.shape[0]
    G, g = ops.tile_gram(tb, rows, K, w0, s0)
    G2, g2 = ref.tile_gram(tb, rows, K, w0.reshape(-1, rb),
                           s0.reshape(-1, rb))
    e3 = max(errs(G, G2)[1], errs(g, g2)[1])
    parity["tile_gram"] = e3
    check(e3 <= tol["tile_gram"], f"tile_gram: error {e3}")
    e3 = max(errs(G, G2)[0], errs(g, g2)[0])
    k3_ms = time_ms(torch, lambda: tile_gram_k.launch(tb, rows, K, w0, s0),
                    20)
    k3_plain = time_ms(torch, lambda: ref.tile_gram(
        tb, rows, K, w0.reshape(-1, rb), s0.reshape(-1, rb)), 5)
    wk = w0.reshape(-1, rb)[rows.long()]
    k3_lib = time_ms(torch, lambda: torch.einsum("kit,ki,kiu->tu", tb, wk,
                                                 tb), 5)
    # G is symmetric, so the least work is its T (T + 1) / 2 unique
    # entries (one FMA a row each), the w scaling and g's FMAs
    k3_flops = 1.0 * K * rb * T * (T + 1) + 3.0 * K * rb * T
    k3_bytes = K * rb * T * 4 + K * 4 + 2 * K * rb * 4 + (T * T + T) * 4
    b_ms, b_by = bound_ms(k3_bytes, k3_flops)
    report["tile_gram"] = dict(ms=k3_ms, plain_ms=k3_plain, bound_ms=b_ms,
                               bound_by=b_by, library_ms=k3_lib,
                               max_abs_err=e3, K=K)

    # K2 on that tile's Gram block
    h = torch.diagonal(G).contiguous()
    beta_t = torch.from_numpy((rng.normal(size=T) * 0.1).astype(np.float32)) \
        .to(dev)
    zeros = torch.zeros_like(beta_t)
    penf = solver._penf[tid * T:(tid + 1) * T].contiguous()
    mu = torch.full((), 1.0, device=dev)
    lam1 = 0.05 * float(g.abs().max())
    got = ops.cd_tile_solve(G, g, h, beta_t, zeros, mu, 1e-6, lam1, 0.0,
                            penf=penf)
    want = ref.cd_tile_solve(G, g, h, beta_t, zeros, mu, 1e-6, lam1, 0.0,
                             penf=penf)
    e2 = float((got - want).abs().max())
    parity["cd_tile_solve"] = e2
    check(e2 <= tol["cd_tile_solve"], f"cd_tile_solve: error {e2}")
    params = torch.stack([mu, mu.new_full((), 1e-6), mu.new_full((), lam1),
                          mu.new_full((), 0.0)])
    k2_ms = time_ms(torch, lambda: cd_tile_solve_k.launch(
        G, g, h, beta_t, zeros, params, penf), 200)
    k2_plain = time_ms(torch, lambda: ref.cd_tile_solve(
        G, g, h, beta_t, zeros, mu, 1e-6, lam1, 0.0, penf=penf), 3, 1)
    b_ms, b_by = bound_ms((T * T + 7 * T + 4) * 4, 3.0 * T * T + 12 * T)
    report["cd_tile_solve"] = dict(ms=k2_ms, plain_ms=k2_plain,
                                   bound_ms=b_ms, bound_by=b_by,
                                   library_ms=None, max_abs_err=e2)
    emit({"phase": "kernel_parity", "max_rel_err": parity,
          "tolerance": tol, "n": n, "T": T, "row_block": rb, "K": K,
          "alpha_counts": [int(alphas0.shape[0]), int(bt.shape[0])]})
    del G, g, G2, g2, xb, xdb, wk

    # ------------------------------- small fits: the card against the CPU
    ref_fit = {}
    for kind_small in ("sparse", "dense"):
        small = (synthetic.make_sparse(n=3000, p=700, avg_nnz=20,
                                       k_true=30, seed=SEED + 1)
                 if kind_small == "sparse" else
                 synthetic.make_dense(n=3000, p=300, k_true=20,
                                      seed=SEED + 1))
        res = []
        for d in ("cpu", dev):
            s = GLMSolver(small.train.X, small.train.y, family="logistic",
                          config=DGLMNETConfig(tile_size=256),
                          fit_intercept=True, device=d)
            r = s.fit(lam1=0.05 * s.lambda_max(), max_outer=8, tol=0.0)
            res.append(r)
        f_err = float(np.max(np.abs(np.array(res[1].history["f"])
                                    / np.array(res[0].history["f"]) - 1)))
        b_err = float(np.max(np.abs(res[1].beta - res[0].beta)))
        ref_fit[kind_small] = {"f_rel_err": f_err, "beta_abs_err": b_err,
                               "alpha_cpu": res[0].history["alpha"],
                               "alpha_gpu": res[1].history["alpha"]}
        check(f_err <= 1e-4 and b_err <= 1e-3,
              f"{kind_small} small fit: card vs CPU f {f_err} beta {b_err}")
    emit({"phase": "reference_fit", "tolerance": {"f_rel": 1e-4,
                                                  "beta_abs": 1e-3},
          **ref_fit})

    # --------------------------------------------------------- the fits
    def run_fit(tag, solver, X_test, y_test):
        t0 = time.perf_counter()
        lmax = solver.lambda_max()
        torch.cuda.synchronize()
        lmax_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = solver.fit(lam1=LAM1_FRACTION * lmax, max_outer=5)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        f = np.array(res.history["f"])
        it = res.n_iter
        ntl = solver.design.n_tiles
        want = {"glm_stats": it, "cd_tile_solve": it * ntl,
                "tile_gram": it * ntl if tag == "sparse" else 0,
                "alpha_search": 2 * it}
        check(np.isfinite(f).all(), f"{tag}: non-finite objective {f}")
        # f never rises: each f is one candidate-loss sum and the next f
        # before the step another sum of the same losses, so 1e-6 relative
        check(bool(np.all(np.diff(f) <= 1e-6 * np.abs(f[:-1]))),
              f"{tag}: objective rose {f.tolist()}")
        check(counts == want, f"{tag}: launches {counts} != {want}")
        nnz = int(res.history["nnz"][-1])
        check(0 < nnz <= solver.design.shape[1], f"{tag}: nnz {nnz}")
        beta = res.beta
        check(bool(np.isfinite(beta).all()), f"{tag}: non-finite beta")
        m = (X_test.matvec(beta) if hasattr(X_test, "matvec")
             else np.asarray(X_test, np.float32) @ beta) + solver.intercept_
        acc = float(((m > 0) == (y_test > 0)).mean())
        emit({"phase": f"{tag}_fit", "lambda_max": lmax,
              "lambda_max_s": lmax_s, "lam1": LAM1_FRACTION * lmax,
              "n_iter": it,
              "f": f.tolist(), "alpha": res.history["alpha"],
              "nnz": res.history["nnz"], "superstep_s": res.history["step_s"],
              "fit_s": fit_s, "launches": counts,
              "launches_per_superstep": {k: v / it for k, v in
                                         counts.items()},
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "test_accuracy": acc})
        return counts

    sparse_counts = run_fit("sparse", solver, ds.test.X, ds.test.y)
    del solver, design, tb, rows, h, y, wobs, off, s0, w0, penf, ds
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dd = full_size_data(synthetic, "dense")
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dsolver = full_size_solver(GLMSolver, dd, dev)
    torch.cuda.synchronize()
    emit({"phase": "dense_setup", "train_shape": list(dd.train.X.shape),
          "padded_shape": list(dsolver.design.shape),
          "n_tiles": dsolver.design.n_tiles,
          "design_gb": dsolver.design.data.numel() * 4 / 1e9,
          "generate_s": gen_s, "place_s": time.perf_counter() - t0})
    dense_counts = run_fit("dense", dsolver, dd.test.X, dd.test.y)

    # ------------------------------------------------------------- report
    src = {"glm_stats": "src/repro/kernels/glm_stats.py:72",
           "cd_tile_solve": "src/repro/kernels/cd_tile_solve.py:74",
           "tile_gram": "src/repro/kernels/tile_gram.py:59",
           "alpha_search": "src/repro/kernels/alpha_search.py:48"}
    kernels = []
    for name in ("glm_stats", "cd_tile_solve", "tile_gram", "alpha_search"):
        rep = report[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": src[name], "launches": sparse_counts[name],
            "launches_dense": dense_counts[name],
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"]})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
