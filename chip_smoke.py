#!/usr/bin/env python3
"""Drive repro_torch's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Run from a checkout (it imports ``src/repro_torch`` beside it) on a machine
with a CUDA card and ``nvcc``.  It builds the seven hand-written CUDA
kernels from ``src/repro_torch/kernels/csrc``, holds each against its plain
PyTorch version on the card at its path's shapes and times both, then
drives each path through the entry points a user calls and checks it:

  * sparse fit: make_sparse(n=163840, p=16384, avg_nnz=50) -> a 131072 x
    16384 train split packed into 256 x 256 bricks, ``GLMSolver.fit`` with
    the default Gauss-Seidel superstep (glm_stats, tile_gram, cd_tile_solve,
    alpha_search);
  * serve: a 4-column artifact from warm-started fits of that data, saved
    and loaded, scored by ``ScoringEngine.score_coo`` and
    ``GLMSolver.predict`` over the 16384-row sparse test split and driven by
    ``MicroBatcher`` traffic (predict_tile);
  * dense fit: make_dense(n=500000, p=2000) -> a 400000 x 2000 train split
    (glm_stats, cd_tile_solve, alpha_search; the dense tile Gram is a plain
    matrix product);
  * dense Jacobi fit: the same data with ``coupling="jacobi"``, the fused
    superstep (stats_gram_solve, margin_ls), then a short profiled fit that
    counts the CUDA launches behind each of its logical launches; the
    unfused Jacobi superstep on the same data follows for comparison.

K3 and K5 run on the tensor cores (3xTF32): their report gives both bounds,
the fp32 FMA one and the tensor-core one, with the share of each and the
TF32 TFLOP/s executed, and checks that G is exactly symmetric.

Each path runs with every kernel's launch count set to 0 just before it and
read just after; the counts must equal the path's exact needs.  Small fits
on the card (Gauss-Seidel and both Jacobi forms) are also held against the
same fits on the CPU.  It prints one JSON object per phase, the card's name
and power limit, the kernel report and, last, ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero without that line; so does a machine
without a CUDA device, or a directory without the package.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

SEED = 0
REPO = pathlib.Path(__file__).resolve().parent
H100_FP32_FLOPS = 67e12     # dense fp32 outside the tensor cores (SXM, 700 W)
H100_TF32_FLOPS = 495e12    # dense TF32 on the tensor cores (SXM, 700 W)
H100_BYTES_PER_S = 3.35e12  # HBM3


LAM1_FRACTION = 0.05        # lam1 of the full-size fits, over lambda_max
SERVE_FRACTIONS = (0.2, 0.1, 0.05, 0.02)   # the served model's columns


def full_size_data(synthetic, kind: str):
    """The data set of one of the two full-size fits (``profile_superstep.py``
    profiles the same two)."""
    if kind == "sparse":
        return synthetic.make_sparse(n=163_840, p=16_384, avg_nnz=50,
                                     k_true=200, seed=SEED)
    return synthetic.make_dense(n=500_000, p=2_000, k_true=200, seed=SEED)


def full_size_solver(GLMSolver, ds, dev, config=None):
    """The solver of a full-size fit: logistic with an intercept."""
    return GLMSolver(ds.train.X, ds.train.y, family="logistic",
                     fit_intercept=True, device=dev, config=config)


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


def gram_bounds(bytes_moved: float, gram_flops: float, other_flops: float,
                executed_flops: float, ms: float) -> dict:
    """K3's and K5's two bounds.  gram_flops: one FMA a row for each of G's
    T (T + 1) / 2 unique entries; other_flops: the rest (w scaling, g,
    stats); executed_flops: the TF32 products the kernel issues (three a
    product, over the whole upper blocks and rows it streams).  The FMA
    bound puts all the work on the fp32 pipes; the tensor-core bound, the
    least time on the pipe the kernel uses, three TF32 products of G's
    unique entries.  Each share is that bound over ``ms``."""
    fma, fma_by = bound_ms(bytes_moved, gram_flops + other_flops)
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_tc = 3.0 * gram_flops / H100_TF32_FLOPS * 1e3
    tc, tc_by = (t_bytes, "bytes") if t_bytes >= t_tc else (t_tc,
                                                            "operations")
    return dict(bound_ms=tc, bound_by=tc_by, bound_fma_ms=fma,
                bound_fma_by=fma_by, share_of_tensor_core_bound=tc / ms,
                share_of_fma_bound=fma / ms,
                tflops_needed=gram_flops / ms / 1e9,
                tf32_tflops_executed=executed_flops / ms / 1e9)


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


def labels_for(np, torch, rng, fam, y):
    """The fit's labels, or Poisson counts for the poisson family."""
    if fam == "poisson":
        return torch.from_numpy(rng.poisson(2.0, y.shape[0])
                                .astype(np.float32)).to(y.device)
    return y


def short_name(key: str) -> str:
    """A kernel's name without its template and argument lists."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    for cut in ("(", "<"):
        key = key.split(cut)[0]
    return key[:60]


def cuda_launches(torch, solver, lam1, prefixes, steps: int = 2):
    """The CUDA launches behind each logical launch, counted by
    torch.profiler over a ``steps``-superstep fit.  ``prefixes`` maps a
    kernel to the name prefix of its CUDA functions; returns ({kernel:
    {CUDA function: launches}}, the logical launch counts, supersteps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = solver.fit(lam1=lam1, max_outer=steps, tol=0.0)
        torch.cuda.synchronize()
    logical = ops.launch_counts()
    found = {k: {} for k in prefixes}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        name = short_name(evt.key)
        for k, pre in prefixes.items():
            if name.startswith(pre):
                found[k][name] = found[k].get(name, 0) + evt.count
    return found, logical, res.n_iter


def fused_parity(np, torch, solver, dev, report, parity):
    """K5 and K6 against their plain versions on the full-size dense
    design (one tile marked dead), timed beside a library yardstick."""
    from repro_torch.core import linesearch
    from repro_torch.kernels import margin_ls as margin_ls_k
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import gram_tc
    from repro_torch.kernels import stats_gram_solve as sgs_k

    design = solver.design
    X = design.data
    n, p = X.shape
    T, nt = design.tile_size, design.n_tiles
    y, wobs, off, penf = solver._ys, solver._wobs, solver._offsets, \
        solver._penf
    rng = np.random.default_rng(SEED + 2)
    beta = torch.from_numpy((0.01 * rng.normal(size=p)
                             * (rng.random(p) < 0.2)).astype(np.float32)) \
        .to(dev)
    xb = design.matvec(beta)
    live = np.ones(nt, bool)
    live[3] = False
    n_live = int(live.sum())
    mu = torch.full((), 1.0, device=dev)
    g0 = ops.fused_stats_sweep(design, y, xb, beta, "logistic", mu=mu,
                               nu=1e-6, lam1=0.0, lam2=0.0, weights=wobs,
                               offset=off, penf=penf, tile_live=live)[5]
    kw = dict(mu=mu, nu=1e-6, lam1=0.05 * float(g0.abs().max()), lam2=0.0)
    # tolerances on max |kernel - plain| / max(max |plain|, 1): the stats,
    # G and g as K1 and K3 (probit 3e-4: its w comes from erfc, the plain
    # version's from log_ndtr); the step is the K2 chain, exact in itself,
    # run on a G summed in another order: 1e-4 of the largest step
    tol = {"stats_gram_solve": 1e-5, "stats_gram_solve_probit": 3e-4,
           "stats_gram_solve_dbeta": 1e-4, "margin_ls": 1e-5}
    err5 = 0.0
    for fam in ("logistic", "squared", "probit", "poisson"):
        yy = labels_for(np, torch, rng, fam, y)
        got = ops.fused_stats_sweep(design, yy, xb, beta, fam, weights=wobs,
                                    offset=off, penf=penf, tile_live=live,
                                    **kw)
        want = ref.stats_gram_solve(design.tiles3(), yy, xb, wobs, beta, fam,
                                    offset=off, penf=penf, tile_live=live,
                                    **kw)
        pairs = [(got[0], want[0]), (got[1], want[1]), (got[2], want[2]),
                 (got[4], want[3]), (got[5], want[4])]
        e = max(errs(a, b)[1] for a, b in pairs)
        parity[f"stats_gram_solve/{fam}"] = e
        check(e <= tol["stats_gram_solve_probit" if fam == "probit"
                       else "stats_gram_solve"],
              f"stats_gram_solve {fam}: error {e}")
        check(not bool(got[4][3].any()) and not bool(got[3][3 * T:4 * T]
                                                     .any()),
              f"stats_gram_solve {fam}: the dead tile was touched")
        check(torch.equal(got[4], got[4].transpose(1, 2)),
              f"stats_gram_solve {fam}: G is not symmetric")
        ed = float((got[3] - want[5]).abs().max()) / max(
            float(want[5].abs().max()), 1e-3)
        parity[f"stats_gram_solve/{fam}/dbeta"] = ed
        check(ed <= tol["stats_gram_solve_dbeta"],
              f"stats_gram_solve {fam}: step error {ed}")
        err5 = max(err5, max(errs(a, b)[0] for a, b in pairs))
        if fam == "logistic":
            dbeta = got[3]
            check(bool(dbeta.abs().max() > 0), "stats_gram_solve: no step")
            # both against float64 sums of the live tiles' G
            f64 = {"kernel": 0.0, "plain": 0.0}
            for t in np.flatnonzero(live):
                Xt = X[:, t * T:(t + 1) * T].double()
                G64 = (Xt * want[2].double()[:, None]).T @ Xt
                scale = float(G64.abs().max())
                for who, G in (("kernel", got[4]), ("plain", want[3])):
                    f64[who] = max(f64[who], float(
                        (G[t].double() - G64).abs().max()) / scale)
                del Xt, G64
            parity["stats_gram_solve/G_vs_float64"] = f64
            check(f64["kernel"] <= 1e-5,
                  f"stats_gram_solve: G {f64['kernel']} off float64 sums")
    # timed at the path's shape: the dense Jacobi fit has every tile live
    params = torch.stack([mu, mu.new_full((), kw["nu"]),
                          mu.new_full((), kw["lam1"]), mu.new_full((), 0.0)])
    order, n_all = ops.tile_order(None, nt, dev)
    k5_ms = time_ms(torch, lambda: sgs_k.launch(
        X, y, xb, wobs, off, beta, penf, params, order, n_all, T,
        "logistic"), 10)
    k5_plain = time_ms(torch, lambda: ref.stats_gram_solve(
        design.tiles3(), y, xb, wobs, beta, "logistic", offset=off,
        penf=penf, **kw), 2, 1)
    _, s_, w_ = ops.glm_stats(y, xb, "logistic", weights=wobs, offset=off)
    X3 = X.view(n, nt, T)
    k5_lib = time_ms(torch, lambda: (
        torch.einsum("nti,ntj->tij", X3 * w_[:, None, None], X3),
        torch.einsum("nti,n->ti", X3, s_)), 3, 1)
    # G is symmetric: the least work is its T (T + 1) / 2 unique entries
    # (one FMA a row each), beside the w scaling and g's FMAs, per tile
    bn = gram_tc.band(T)
    k5_bytes = (n * n_all * T + 7 * n + nt * (T * T + T) + 3 * p) * 4.0
    bounds = gram_bounds(
        k5_bytes, n_all * n * T * (T + 1.0), n_all * n * 3.0 * T + 20.0 * n,
        6.0 * n_all * gram_tc.n_pairs(T) * bn * bn * n, k5_ms)
    report["stats_gram_solve"] = dict(
        ms=k5_ms, plain_ms=k5_plain, **bounds,
        library_ms=k5_lib, library_covers="G and g only (torch.einsum)",
        plain_note="the plain version sums G and g in float64; the float32 "
                   "product is library_ms",
        max_abs_err=err5, n_live=n_all,
        G_vs_float64=parity["stats_gram_solve/G_vs_float64"])

    cand = linesearch.full_candidates(1e-3, 13, 0.5, 20, device=dev)
    K = cand.shape[0]
    err6 = 0.0
    for fam in ("logistic", "squared", "probit", "poisson"):
        yy = labels_for(np, torch, rng, fam, y)
        got = ops.fused_ls(design, yy, xb, dbeta, cand, fam, weights=wobs,
                           offset=off)
        want = ref.fused_ls_dense(design.tiles3(), yy, xb, dbeta, wobs, cand,
                                  fam, offset=off)
        e = max(errs(a, b)[1] for a, b in zip(got, want))
        parity[f"margin_ls/{fam}"] = e
        check(e <= tol["margin_ls"], f"margin_ls {fam}: error {e}")
        err6 = max(err6, max(errs(a, b)[0] for a, b in zip(got, want)))
    k6_ms = time_ms(torch, lambda: margin_ls_k.launch(
        X, dbeta, y, xb, wobs, cand, "logistic", offset=off), 10)
    k6_plain = time_ms(torch, lambda: ref.fused_ls_dense(
        design.tiles3(), y, xb, dbeta, wobs, cand, "logistic", offset=off),
        3, 1)
    k6_lib = time_ms(torch, lambda: torch.mv(X, dbeta), 10)
    k6_bytes = (n * p + 5 * n + p + 2 * K) * 4.0
    b_ms, b_by = bound_ms(k6_bytes, 2.0 * n * p + 12.0 * n * K)
    report["margin_ls"] = dict(
        ms=k6_ms, plain_ms=k6_plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=k6_lib, library_covers="xdb only (torch.mv)",
        max_abs_err=err6, K=K)
    emit({"phase": "fused_kernel_parity", "n": n, "p_pad": p, "T": T,
          "n_tiles": nt, "n_live_parity": n_live, "K": K, "tolerance": tol,
          "max_rel_err": {k: v for k, v in parity.items()
                          if k.split("/")[0] in ("stats_gram_solve",
                                                 "margin_ls")},
          "stats_gram_solve": report["stats_gram_solve"],
          "margin_ls": report["margin_ls"]})


def serve_phase(np, torch, solver, ds, dev, report, parity):
    """Serving on the sparse model: a 4-column artifact from warm-started
    fits, saved and loaded; K7 against its plain version; the test split
    through ``score_coo`` and ``GLMSolver.predict``; closed-loop traffic
    through ``MicroBatcher``.  Returns the launch counts of that run."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import predict_tile as predict_tile_k
    from repro_torch.serve import (MicroBatcher, ScoringEngine,
                                   artifact_bytes, coo_to_requests,
                                   load_artifact, save_artifact)

    lmax = solver.lambda_max()
    betas, b0s, lams = [], [], []
    beta0, icpt = None, 0.0
    t0 = time.perf_counter()
    for frac in SERVE_FRACTIONS:
        res = solver.fit(lam1=frac * lmax, beta0=beta0, intercept0=icpt,
                         max_outer=5)
        beta0, icpt = res.beta, solver.intercept_
        betas.append(beta0)
        b0s.append(icpt)
        lams.append(frac * lmax)
    path_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        art = save_artifact(pathlib.Path(tmp) / "model",
                            betas=np.stack(betas), intercepts=b0s,
                            family="logistic", lambdas=lams)
        model = load_artifact(art)
        art_bytes = artifact_bytes(art)
    check(np.array_equal(model.betas, np.stack(betas)),
          "serve: the artifact does not read back")
    eng = ScoringEngine(model, device=dev)
    Xte, yte = ds.test.X, ds.test.y
    reqs = coo_to_requests(Xte)

    # K7 at the serving shapes: 4096 test rows in the J = 64 bucket, L = 4
    B, J = 4096, 64
    fit_rows = [r for r in reqs if len(r[0]) <= J][:B]
    check(len(fit_rows) == B, "serve: too few test rows for the J bucket")
    slots_h, vals_h = eng.pack_requests(fit_rows, nnz_pad=J)
    slots = torch.from_numpy(slots_h).to(dev)
    vals = torch.from_numpy(vals_h).to(dev)
    table, b0 = eng._table, eng._b0
    err7 = 0.0
    for fam in ("logistic", "squared", "probit", "poisson"):
        for kind_ in ("link", "response"):
            got = ops.predict_tile(slots, vals, table, b0, fam, kind=kind_)
            want = ref.predict_tile(slots, vals, table, b0, fam, kind=kind_)
            ea, e = errs(got, want)
            parity[f"predict_tile/{fam}/{kind_}"] = e
            check(e <= 1e-5, f"predict_tile {fam} {kind_}: error {e}")
            err7 = max(err7, ea)
    k7_ms = time_ms(torch, lambda: predict_tile_k.launch(
        slots, vals, table, b0, "logistic", "response"), 200)
    k7_plain = time_ms(torch, lambda: ref.predict_tile(
        slots, vals, table, b0, "logistic", kind="response"), 50)
    k7_lib = time_ms(torch, lambda: F.embedding_bag(
        slots, table, per_sample_weights=vals, mode="sum"), 200)
    A1, L = table.shape
    b_ms, b_by = bound_ms((B * J * 2 + A1 * L + L + B * L) * 4.0,
                          2.0 * B * J * L + 4.0 * B * L)
    report["predict_tile"] = dict(
        ms=k7_ms, plain_ms=k7_plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=k7_lib,
        library_covers="margins only (F.embedding_bag, mode sum)",
        max_abs_err=err7, B=B, J=J, L=L, A1=A1)

    # the path: the counts at 0, then score_coo, predict and traffic
    calls = [0]
    score_packed = ScoringEngine.score_packed

    def counted(self, *a, **k):
        calls[0] += 1
        return score_packed(self, *a, **k)

    ScoringEngine.score_packed = counted
    try:
        batcher = MicroBatcher(eng, max_delay_ms=2.0,
                               batch_buckets=(1, 4, 16, 64),
                               nnz_buckets=(32, 64, 128))
        batcher.warmup()
        n_warm = eng.compile_count
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        calls[0] = 0

        n_req, n_clients = 4096, 32
        outs = [None] * n_req
        failed = []

        def client(c):
            try:
                for i in range(c, n_req, n_clients):
                    idx, val = reqs[i]
                    outs[i] = batcher.submit(idx, val).get(timeout=60.0)
            except Exception as exc:          # reported below
                failed.append(repr(exc))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300.0)
        traffic_s = time.perf_counter() - t0
        batcher.close()
        n_traffic = eng.compile_count
        t0 = time.perf_counter()
        scores = eng.score_coo(Xte, kind="response")
        coo_s = time.perf_counter() - t0
        pred = solver.predict(Xte, kind="response")
        counts = ops.launch_counts()
    finally:
        ScoringEngine.score_packed = score_packed
    check(not failed and not any(th.is_alive() for th in threads),
          f"serve: traffic failed {failed[:3]}")
    st = batcher.stats()

    # held against a host product of the same rows (float64 sums)
    want = np.stack([Xte.matvec(bk) for bk in np.stack(betas)], axis=1) \
        + np.asarray(b0s, np.float32)
    want = 1.0 / (1.0 + np.exp(-want.astype(np.float64)))
    e_coo = float(np.abs(scores - want).max())
    e_pred = float(np.abs(pred - scores[:, -1]).max())
    e_traffic = float(np.abs(np.stack(outs) - scores[:n_req]).max())
    check(e_coo <= 1e-5, f"serve: score_coo error {e_coo}")
    check(e_pred <= 1e-6, f"serve: predict differs from the engine {e_pred}")
    check(e_traffic <= 1e-5, f"serve: batcher results differ {e_traffic}")
    # warmup visits every (batch, nnz) bucket of both kinds; the traffic
    # must add no shape of its own
    n_shapes = len(batcher.batch_buckets) * len(batcher.nnz_buckets) * 2
    check(n_warm <= n_shapes and n_traffic == n_warm,
          f"serve: {n_warm} shapes after warmup, {n_traffic} after the "
          f"traffic, {n_shapes} buckets")
    check(counts["predict_tile"] == calls[0] > 0,
          f"serve: {counts['predict_tile']} predict_tile launches for "
          f"{calls[0]} engine calls")
    check(sum(v for k, v in counts.items() if k != "predict_tile") == 0,
          f"serve: other kernels launched {counts}")
    acc = [float(((scores[:, k] > 0.5) == (yte > 0)).mean())
           for k in range(scores.shape[1])]
    emit({"phase": "serve", "lambdas": lams, "fits_s": path_s,
          "artifact_bytes": art_bytes, "n_active": eng.n_active,
          "test_rows": int(Xte.shape[0]), "score_coo_s": coo_s,
          "score_coo_rows_per_s": Xte.shape[0] / coo_s,
          "max_err": {"score_coo": e_coo, "predict": e_pred,
                      "traffic": e_traffic},
          "test_accuracy": acc,
          "traffic": {"requests": n_req, "clients": n_clients,
                      "loop": "closed", "wall_s": traffic_s, **st,
                      "occupancy": st["mean_batch"] / batcher.max_batch},
          "shapes": {"buckets": n_shapes, "after_warmup": n_warm,
                     "after_traffic": n_traffic},
          "engine_calls": calls[0], "launches": counts,
          "predict_tile": report["predict_tile"]})
    return counts


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
    from repro_torch.kernels import gram_tc, ops, ref
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

    xb = torch.from_numpy((rng.normal(size=n) * 1.5).astype(np.float32)) \
        .to(dev)
    xdb = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    err_k1 = 0.0
    for fam in fams:
        yy = labels_for(np, torch, rng, fam, y)
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
        yy = labels_for(np, torch, rng, fam, y)
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
    # only G's upper blocks are computed and mirrored, with no atomics: G
    # is exactly symmetric and the same from run to run
    G3, g3 = ops.tile_gram(tb, rows, K, w0, s0)
    check(torch.equal(G, G.T), "tile_gram: G is not symmetric")
    check(torch.equal(G, G3) and torch.equal(g, g3),
          "tile_gram: G differs from run to run")
    del G3, g3
    e3 = max(errs(G, G2)[0], errs(g, g2)[0])
    k3_ms = time_ms(torch, lambda: tile_gram_k.launch(tb, rows, K, w0, s0),
                    20)
    k3_plain = time_ms(torch, lambda: ref.tile_gram(
        tb, rows, K, w0.reshape(-1, rb), s0.reshape(-1, rb)), 5)
    wk = w0.reshape(-1, rb)[rows.long()]
    k3_lib = time_ms(torch, lambda: torch.einsum("kit,ki,kiu->tu", tb, wk,
                                                 tb), 5)
    # G is symmetric, so the least work is its T (T + 1) / 2 unique
    # entries (one FMA a row each), beside the w scaling and g's FMAs
    k3_bytes = K * rb * T * 4 + K * 4 + 2 * K * rb * 4 + (T * T + T) * 4
    bn, slab = gram_tc.band(T), gram_tc.SLAB
    streamed = K * -(-rb // slab) * slab
    bounds = gram_bounds(k3_bytes, 1.0 * K * rb * T * (T + 1),
                         3.0 * K * rb * T,
                         6.0 * gram_tc.n_pairs(T) * bn * bn * streamed, k3_ms)
    report["tile_gram"] = dict(ms=k3_ms, plain_ms=k3_plain, **bounds,
                               library_ms=k3_lib, max_abs_err=e3, K=K)

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
    couplings = {"gauss-seidel": DGLMNETConfig(tile_size=256),
                 "jacobi-fused": DGLMNETConfig(tile_size=256,
                                               coupling="jacobi"),
                 "jacobi-unfused": DGLMNETConfig(tile_size=256,
                                                 coupling="jacobi",
                                                 fuse_superstep=False)}
    for kind_small in ("sparse", "dense"):
        small = (synthetic.make_sparse(n=3000, p=700, avg_nnz=20,
                                       k_true=30, seed=SEED + 1)
                 if kind_small == "sparse" else
                 synthetic.make_dense(n=3000, p=300, k_true=20,
                                      seed=SEED + 1))
        for coupling, cfg in couplings.items():
            res = []
            for d in ("cpu", dev):
                s = GLMSolver(small.train.X, small.train.y,
                              family="logistic", config=cfg,
                              fit_intercept=True, device=d)
                r = s.fit(lam1=0.05 * s.lambda_max(), max_outer=8, tol=0.0)
                res.append(r)
            f_err = float(np.max(np.abs(np.array(res[1].history["f"])
                                        / np.array(res[0].history["f"])
                                        - 1)))
            b_err = float(np.max(np.abs(res[1].beta - res[0].beta)))
            ref_fit[f"{kind_small}/{coupling}"] = {
                "f_rel_err": f_err, "beta_abs_err": b_err,
                "alpha_cpu": res[0].history["alpha"],
                "alpha_gpu": res[1].history["alpha"]}
            check(f_err <= 1e-4 and b_err <= 1e-3,
                  f"{kind_small} {coupling} small fit: card vs CPU f "
                  f"{f_err} beta {b_err}")
    emit({"phase": "reference_fit", "tolerance": {"f_rel": 1e-4,
                                                  "beta_abs": 1e-3},
          **ref_fit})

    # --------------------------------------------------------- the fits
    def run_fit(tag, solver, X_test, y_test, want_per_step, prefixes=None):
        """Fit at LAM1_FRACTION * lambda_max for 5 supersteps with the
        launch counts set to 0 just before; ``want_per_step`` the exact
        launches of one superstep.  With ``prefixes`` (kernel: name prefix
        of its CUDA functions) a profiled fit then counts the CUDA launches
        behind each logical one: every CUDA function of the kernel must run
        once per logical launch."""
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
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        f = np.array(res.history["f"])
        it = res.n_iter
        want = {k: it * want_per_step.get(k, 0) for k in counts}
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
        extra = {}
        if prefixes:
            found, logical, n_prof = cuda_launches(
                torch, solver, LAM1_FRACTION * lmax, prefixes)
            for k, fns in found.items():
                check(bool(fns) and all(c == logical[k] for c in
                                        fns.values()),
                      f"{tag}: CUDA launches of {k} {fns} for "
                      f"{logical[k]} logical launches")
            extra = {"cuda_launches_per_superstep": {
                         k: sum(fns.values()) / n_prof
                         for k, fns in found.items()},
                     "cuda_functions": found, "profiled_supersteps": n_prof}
        emit({"phase": f"{tag}_fit", "lambda_max": lmax,
              "lambda_max_s": lmax_s, "lam1": LAM1_FRACTION * lmax,
              "n_iter": it,
              "f": f.tolist(), "alpha": res.history["alpha"],
              "nnz": res.history["nnz"], "superstep_s": res.history["step_s"],
              "fit_s": fit_s, "launches": counts,
              "launches_per_superstep": {k: v / it for k, v in
                                         counts.items()},
              **extra, "peak_mem_gb": peak_gb, "test_accuracy": acc})
        return counts

    sparse_counts = run_fit("sparse", solver, ds.test.X, ds.test.y,
                            {"glm_stats": 1, "cd_tile_solve": nt,
                             "tile_gram": nt, "alpha_search": 2})
    del design, tb, rows, h, y, wobs, off, s0, w0, penf
    serve_counts = serve_phase(np, torch, solver, ds, dev, report, parity)
    del solver, ds
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dd = full_size_data(synthetic, "dense")
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dsolver = full_size_solver(GLMSolver, dd, dev)
    torch.cuda.synchronize()
    dnt = dsolver.design.n_tiles
    emit({"phase": "dense_setup", "train_shape": list(dd.train.X.shape),
          "padded_shape": list(dsolver.design.shape),
          "n_tiles": dnt,
          "design_gb": dsolver.design.data.numel() * 4 / 1e9,
          "generate_s": gen_s, "place_s": time.perf_counter() - t0})
    dense_counts = run_fit("dense", dsolver, dd.test.X, dd.test.y,
                           {"glm_stats": 1, "cd_tile_solve": dnt,
                            "alpha_search": 2})
    del dsolver
    torch.cuda.empty_cache()

    jsolver = full_size_solver(GLMSolver, dd, dev,
                               DGLMNETConfig(coupling="jacobi"))
    fused_parity(np, torch, jsolver, dev, report, parity)
    jacobi_counts = run_fit("dense_jacobi", jsolver, dd.test.X, dd.test.y,
                            {"stats_gram_solve": 1, "margin_ls": 1},
                            {"stats_gram_solve": "sgs_",
                             "margin_ls": "margin_ls_"})
    del jsolver
    torch.cuda.empty_cache()
    # the unfused Jacobi superstep on the same data: a cuBLAS Gram per
    # tile, K2 per tile, one matvec and the two-launch line search (K4)
    usolver = full_size_solver(GLMSolver, dd, dev,
                               DGLMNETConfig(coupling="jacobi",
                                             fuse_superstep=False))
    run_fit("dense_jacobi_unfused", usolver, dd.test.X, dd.test.y,
            {"glm_stats": 1, "cd_tile_solve": dnt, "alpha_search": 2})
    del usolver
    emit({"phase": "kernel_parity_report", "max_rel_err": parity})

    # ------------------------------------------------------------- report
    src = {"glm_stats": "src/repro/kernels/glm_stats.py:72",
           "cd_tile_solve": "src/repro/kernels/cd_tile_solve.py:74",
           "tile_gram": "src/repro/kernels/tile_gram.py:59",
           "alpha_search": "src/repro/kernels/alpha_search.py:48",
           "stats_gram_solve": "src/repro/kernels/superstep_tile.py:152",
           "margin_ls": "src/repro/kernels/superstep_tile.py:251",
           "predict_tile": "src/repro/kernels/predict_tile.py:68"}
    # each kernel's launches come from the run of its own path
    main_path = {"glm_stats": sparse_counts, "cd_tile_solve": sparse_counts,
                 "tile_gram": sparse_counts, "alpha_search": sparse_counts,
                 "stats_gram_solve": jacobi_counts,
                 "margin_ls": jacobi_counts, "predict_tile": serve_counts}
    kernels = []
    for name in src:
        rep = report[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": src[name], "launches": main_path[name][name],
            "launches_dense": dense_counts[name],
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            **{k: rep[k] for k in ("bound_fma_ms", "bound_fma_by",
                                   "share_of_tensor_core_bound",
                                   "share_of_fma_bound", "tflops_needed",
                                   "tf32_tflops_executed", "plain_note")
               if k in rep}})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
