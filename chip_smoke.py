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
    ``MicroBatcher`` traffic (predict_tile), then the same traffic traced
    through a fresh engine: one ``serve/flush`` span a batch,
    ``serve.compiled_shapes`` equal to ``compile_count``;
  * dense fit: make_dense(n=500000, p=2000) -> a 400000 x 2000 train split
    (glm_stats, cd_tile_solve, alpha_search; the dense tile Gram is a plain
    matrix product);
  * dense Jacobi fit: the same data with ``coupling="jacobi"``, the fused
    superstep (stats_gram_solve, margin_ls), then a short profiled fit that
    counts the CUDA launches behind each of its logical launches; the
    unfused Jacobi superstep on the same data follows for comparison;
  * precision="bf16": the dense Jacobi fit again through the bf16 modes of
    stats_gram_solve and margin_ls, and Jacobi fits of the sparse data in
    fp32 and bf16 (glm_stats, tile_gram or its bf16 mode, the batched
    cd_tile_solve, a matvec and alpha_search); each bf16 fit is held
    against its fp32 twin by the reference's own bar (tests/test_fused.py:
    alpha equal on at least 80% of supersteps, beta within 0.05 max(max
    |beta_fp32|, 1));
  * sparse_path: ``GLMSolver.fit_path(n_lambdas=12, lam_ratio=0.05)`` on
    the sparse solver, with strong-rule screening and KKT re-entry, then
    unscreened on the same grid: every lambda converged, no frozen
    coordinate failing the KKT test after a lambda's last round, the
    screened f at most the unscreened f + 1e-5 max(1, |f|), screened tiles
    skipped, K2 and K3 launched once a live tile, K4 twice a superstep, K1
    once a superstep or a gradient check; one gradient check taken apart;
  * path_reference: 6-lambda paths of small sparse and dense inputs
    (Gauss-Seidel and fused Jacobi) and a 3-fold standardized ``fit_cv``
    of the dense one, the card against the CPU;
  * dense_cv: ``fit_cv(n_folds=3, n_lambdas=8)`` of the dense split,
    standardized (centered, the intercept column left exact ones), fused
    Jacobi: K5 and K6 once a superstep, K1 once a gradient check, and the
    unscaled copy of the design freed after construction;
  * checkpoint: on the sparse solver, two fits run through show whether
    the card gives the same bits; the fit cut at its last save before its
    end (``ckpt_every=5``) and sparse_path's grid cut after 6 of its 12
    lambdas (async saves), both resumed in a fresh session, are held to
    those bits (else within 1e-6); each save's and the restore's ms and
    the bytes on disk;
  * trace (after checkpoint): the sparse fit traced (``repro_torch.obs``:
    spans, ``record_function`` and NVTX ranges, a convergence stream) for
    5 supersteps with checkpoints every 2, equal bit for bit to the same
    fit untraced, with one stream event a superstep (f equal to
    ``history["f"]``), the span counts, a resume's ``ckpt/restore``;
    ``ops.launch_trace()`` of one superstep equal to its
    ``launch_counts()``; one profiled superstep whose ``solver/superstep``
    range holds the host launches of K1-K4; a screened 4-lambda path's
    stream context; overheads (traced and untraced supersteps in turns,
    each part of tracing alone); ``trace_report`` over the directory;
  * multinomial: ``MultinomialGLM`` on the sparse train split, 4 classes,
    3 cycles: K1-K4 launched exactly for the class visits' supersteps,
    the standardized objective never rising, training accuracy at least
    the majority share + 0.1, ``predict_proba`` rows summing to 1;
  * estimator: ``LogisticRegressionCD`` fitted, saved (fp32 and int8) and
    loaded, the loaded model's test-split margins (K7) equal to the
    fitted one's and int8 within the manifest's bound,
    ``repro_torch.launch.serve_glm.main`` over the artifact; a family
    registered with the squared formulas fitted on the card only through
    the plain route (``"<kernel>/plain"``), against the squared fit on
    the CPU;
  * stream (after dense_cv): the dense train split kept as a host array
    and streamed by ``streaming_design`` in chunks of 8,192 rows (49, the
    last 6,784; p_pad 2,048, 8 tiles): 5 Gauss-Seidel and 3 Jacobi
    supersteps held against the in-memory fits of as many supersteps
    (the same alpha at each, f within 1e-5 relative, beta within 1e-3),
    K1 and K4 once a chunk and K2 once a swept tile (Jacobi: once a
    superstep); every chunk and a superstep with prefetch off against on,
    bit for bit, each superstep timed by part; the fit cut by its chunk
    source mid-pass (chunk 25 of superstep 3, a chunk-cursor save every
    16 chunks) and resumed in a fresh session; a screened 4-lambda path
    with the KKT test held; the pinned copy rate, the idle share of one
    profiled superstep, the checkpoint's bytes and save ms, K1, K2 and K4
    at the chunk shapes; one superstep traced, its ``phase_us`` (the three
    passes) summing to its ``step_us``;
  * ingest: the sparse train split's first 65,536 rows written as libsvm
    text, then ``repro_torch.launch.ingest_train.main`` in process
    (hashed into 4,096 columns, chunks of 4,096 rows, 3 supersteps: f
    never rising, K1 and K4 once a chunk) and its ``--smoke`` (file
    against memory within 1e-5); write, scan and parse rates and one
    profiled superstep.
  * dist (last): the mesh on torch.distributed, worlds of processes
    started by ``repro_torch.dist.launcher`` (this script is their worker,
    ``--dist-worker``), each under a timeout: (a) NCCL, a world of one,
    mesh (1, 1): the sparse fit's 5 supersteps against the single-device
    fit above (the same alphas and n_iter, beta within 1e-6, whether the
    bits are equal), then the same fit run to tol; (b) gloo, worlds of 2
    ((1, 2)) and 4 ((2, 2)) sharing the one card, the sparse fit at full
    width run to tol, f within 2e-3 |f| of (a)'s, each rank's K1 once a
    superstep, K3 and K2 once a budgeted local tile, K4 twice, seconds a
    superstep, the host seconds inside collectives, world start-up; over
    NCCL too when the machine has a card per rank; (c) small (1, 2) and
    (2, 2) fits on the card against the same worlds on the CPU (beta
    within 1e-5, the same alphas and n_iter); (d) ``dist_run`` under
    ``--faults "1:4.0" --telemetry``: process 1 down-budgeted after the
    warm-up, every rank the same budgets; (e) a 2-process restart from a
    checkpoint (the same bits) and an elastic resume (1, 2) -> (2, 1)
    within 2e-3 |f| of the uninterrupted fit; (f) ``dist_run --data``
    over the dense train split (memory-mapped .npy, chunks of 8,192
    rows): 2 processes over their chunk ranges equal 1 within 1e-6.
    Gloo stages the card's tensors through the host: its times are not
    NCCL's.
No built-in family takes a plain route in any phase.

K3 and K5 run on the tensor cores (3xTF32): their report gives both bounds,
the fp32 FMA one and the tensor-core one, with the share of each and the
TF32 TFLOP/s executed, and checks that G is exactly symmetric.  K2, a
dependent chain, is held bit for bit at T = 256 and 512 and in its batched
launch; beside its bytes bound the report gives its dependency floor, T
times the time of the step's 13 dependent rounded operations run alone,
and the time of one step of the kernel's own panel loop (both measured by
the probes of tools/chain_floor.cu, built here with nvcc).  K6 must give
the same bits on two runs and is timed beside torch.mv on the same X.  K7
is held and timed at 4,096 rows (bulk scoring) and at 64 (the batcher's
largest bucket); beside K1, K4 and K7 stands their launch floor, an empty
kernel on the same grid timed the same way (tools/launch_floor.cu).  K1
and K4 are held for the four families at the sparse fit's n and at the
dense fit's 400,000 rows (K1 also with every vector off a 16-byte
boundary, its element path); K4 at 14, 20, 21, 294 and 321 candidates,
and timed at the main path's shapes (14 and 20 for the Gauss-Seidel line
search, 294 for the fused Jacobi superstep on bricks; 21 beside them).
Their bound is the larger of their bytes and their per-example work at
the rate that the probes of tools/loss_floor.cu (built here with nvcc)
measure on the whole card: one candidate loss for K4, one row's
statistics for K1.  K4 must give the same bits on two runs and leave its
ticket counter at 0.
The bf16 modes of K3, K5 and K6 are held against their plain bf16 versions
(the same roundings, summed in float64 or float32) at 1e-5 relative to the
largest entry; K5's G and g in that mode against the plain bf16 Gram at
the kernel's own w and s (see ``bf16_fused_parity``).  Their bound is the
larger of bytes over the memory rate and all of G's flops at the dense bf16
tensor-core rate (K6: its operations on the fp32 pipes).

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
H100_BF16_FLOPS = 989e12    # dense bf16 on the tensor cores (SXM, 700 W)
H100_BYTES_PER_S = 3.35e12  # HBM3


LAM1_FRACTION = 0.05        # lam1 of the full-size fits, over lambda_max
N_DENSE = 400_000           # train rows of the dense fit (K1 and K4 run there)
SERVE_FRACTIONS = (0.2, 0.1, 0.05, 0.02)   # the served model's columns
DIST_TIMEOUT_S = 300        # one world of the dist phase
DIST_SMALL_STEPS = 8        # supersteps of the small card-vs-CPU fits


def full_size_data(synthetic, kind: str):
    """The data set of one of the two full-size fits (``profile_superstep.py``
    profiles the same two)."""
    if kind == "sparse":
        return synthetic.make_sparse(n=163_840, p=16_384, avg_nnz=50,
                                     k_true=200, seed=SEED)
    return synthetic.make_dense(n=500_000, p=2_000, k_true=200, seed=SEED)


def full_size_solver(GLMSolver, ds, dev, config=None, **kw):
    """The solver of a full-size fit: logistic with an intercept."""
    return GLMSolver(ds.train.X, ds.train.y, family="logistic",
                     fit_intercept=True, device=dev, config=config, **kw)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(bytes_moved: float, flops: float,
             peak_flops: float = H100_FP32_FLOPS):
    """The larger of the bytes over the memory rate and the flops over
    ``peak_flops`` (a bf16 Gram's: all of G at the dense bf16 rate)."""
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_bf16_ms(torch, a, b, reps: int):
    """(ms, what was timed) of one PyTorch product of bf16 operands with a
    float32 result: ``torch.mm`` (2-D) or ``torch.bmm`` (3-D) with
    ``out_dtype=torch.float32``; where this torch lacks that, a float32
    product of the same rounded operands."""
    mm = torch.bmm if a.dim() == 3 else torch.mm
    name = "bmm" if a.dim() == 3 else "mm"
    try:
        mm(a, b, out_dtype=torch.float32)
        return (time_ms(torch, lambda: mm(a, b, out_dtype=torch.float32),
                        reps),
                f"torch.{name}(bf16, bf16, out_dtype=torch.float32)")
    except (TypeError, RuntimeError, NotImplementedError):
        a32, b32 = a.float(), b.float()
        return (time_ms(torch, lambda: mm(a32, b32), reps),
                f"torch.{name} in float32 of the bf16-rounded operands "
                "(no out_dtype in this torch)")


def bf16_tracks_fp32(np, tag: str, r32, r16) -> dict:
    """The reference's bar for a bf16 fit (tests/test_fused.py,
    test_bf16_tracks_fp32_alpha_sequence): alpha equal to the fp32 fit's
    on at least 80% of the supersteps both ran, beta within 0.05 max(max
    |beta_fp32|, 1); and the two differ (the mode did round)."""
    a32 = np.asarray(r32.history["alpha"])
    a16 = np.asarray(r16.history["alpha"])
    k = min(len(a32), len(a16))
    match = float(np.mean(np.isclose(a32[:k], a16[:k], rtol=1e-6)))
    err = float(np.abs(r16.beta - r32.beta).max())
    scale = float(np.abs(r32.beta).max())
    check(k > 0 and match >= 0.8,
          f"{tag}: alpha matches the fp32 fit on {match} of {k} supersteps")
    check(err <= 0.05 * max(scale, 1.0),
          f"{tag}: beta {err} off the fp32 fit (scale {scale})")
    check(err > 0, f"{tag}: beta equals the fp32 fit's bit for bit")
    return {"phase": f"{tag}_vs_fp32", "supersteps": k,
            "alpha_match": match, "alpha_fp32": a32[:k].tolist(),
            "alpha_bf16": a16[:k].tolist(), "beta_max_abs_diff": err,
            "beta_scale": scale, "f_fp32": r32.history["f"],
            "f_bf16": r16.history["f"],
            "bar": {"alpha_match": 0.8, "beta": 0.05 * max(scale, 1.0)}}


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


def build_tool(name: str):
    """A probe of ``tools/`` (on no path of the package), built here with
    nvcc into a temporary directory and loaded with ctypes."""
    import ctypes

    from repro_torch.kernels import build

    src = REPO / "tools" / f"{name}.cu"
    with tempfile.TemporaryDirectory(prefix=f"{name}-") as tmp:
        lib_path = pathlib.Path(tmp) / f"lib{name}.so"
        out = subprocess.run(
            [build.nvcc_path(), *build.ARCH, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-I", str(build.CSRC),
             str(src), "-o", str(lib_path)], capture_output=True, text=True,
            timeout=600)
        check(out.returncode == 0,
              f"{src.name} did not build:\n{out.stdout}{out.stderr}")
        return ctypes.CDLL(str(lib_path))


def floor_tool():
    """tools/launch_floor.cu, built and bound: ``launch_floor_empty(gx, gy,
    threads, stream)`` launches one empty kernel."""
    import ctypes

    lib = build_tool("launch_floor")
    lib.launch_floor_empty.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def launch_floor(torch, lib, grids, reps: int) -> float:
    """The launch floor of a kernel: ms per call of one empty kernel on each
    of its CUDA launches' grids ((gx, gy, threads) each), launched through
    ctypes and timed by ``time_ms`` as the kernel itself is."""
    fn = lib.launch_floor_empty

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        for gx, gy, threads in grids:
            check(fn(gx, gy, threads, stream) == 0,
                  f"launch_floor: launch {gx}x{gy}x{threads} failed")

    return time_ms(torch, run, reps)


def chain_floor(torch, G, g, beta_t, penf, mu, nu, lam1, lam2) -> dict:
    """K2's dependency floor and its design's step latency, from the
    probes of tools/chain_floor.cu (built here with nvcc): SM cycles and
    nanoseconds a step, each pair from one timed loop, so the clock is the
    one the probe ran at.  The minimal probe runs the step's 13 dependent
    rounded operations on the first 16 coordinates of the tile (entering
    step 0, as K2 is timed); the design probe, the kernel's own panel loop
    on the first 32.  Neither counts as a launch of K2."""
    import ctypes

    from repro_torch.kernels import ops

    lib = build_tool("chain_floor")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.chain_floor_minimal.argtypes = [P, I, P, P, P]
    lib.chain_floor_design.argtypes = [P, P, P, P, I, I, P, P, P]
    n = 16
    h = torch.diagonal(G)[:n]
    bk, pk = beta_t[:n], penf[:n]
    muh = mu * h
    den = muh + nu + lam2 * pk
    div = torch.where(den > 0, den.clamp(min=1e-30), torch.ones_like(den))
    consts = torch.cat([muh * bk, nu * bk, lam1 * pk, div, 1.0 / div, bk,
                        torch.zeros_like(bk),
                        torch.diagonal(G[1:n + 1, :n]),
                        torch.stack([mu.reshape(()).float(), g[0]])]) \
        .float().contiguous()
    params = ops.solve_params(mu, nu, lam1, lam2, g)
    res = torch.zeros(2, dtype=torch.int64, device=g.device)
    sink = torch.empty(32, device=g.device)
    stream = P(torch.cuda.current_stream().cuda_stream)
    T = g.shape[0]
    runs = {
        "floor": (lambda reps: lib.chain_floor_minimal(
            consts.data_ptr(), reps, res.data_ptr(), sink.data_ptr(),
            stream), 8192, n),
        "design": (lambda reps: lib.chain_floor_design(
            G.data_ptr(), g.data_ptr(), beta_t.data_ptr(), params.data_ptr(),
            T, reps, res.data_ptr(), sink.data_ptr(), stream), 2000, 32)}
    rep = {}
    for who, (run, reps, steps) in runs.items():
        for _ in range(2):          # the second run is the one kept
            check(run(reps) == 0, f"chain_floor {who}: launch failed")
            torch.cuda.synchronize()
        cycles, ns = (int(v) for v in res.tolist())
        check(cycles > 0 and ns > 0, f"chain_floor {who}: no time taken")
        rep[f"{who}_step_cycles"] = cycles / (reps * steps)
        rep[f"{who}_step_ns"] = ns / (reps * steps)
        rep[f"{who}_probe_clock_mhz"] = cycles / ns * 1e3
    return rep


def k2_bound(T: int):
    """K2's bound at tile width T: it reads only G's entries on and below
    the diagonal (T (T + 1) / 2), g, h, beta, the entering step and penf,
    the 4 params, and writes T steps; it makes T (T - 1) / 2 updates of 3
    operations each and about 12 operations a step."""
    return bound_ms((T * (T + 1) / 2 + 6 * T + 4) * 4,
                    3.0 * T * (T - 1) / 2 + 12 * T)


def loss_floors(np, torch, codes) -> dict:
    """{family: {"loss_ns", "stats_ns"}}: the nanoseconds the whole card
    needs for one K4 candidate loss (m = b + alpha d, loss times c, summed)
    and for one K1 row's statistics (Stats<F>::all, three outputs times
    c), from the probes of tools/loss_floor.cu (built here with nvcc):
    inputs in registers, one full wave, no memory traffic.  ``codes``:
    family -> its code in the kernels."""
    import ctypes

    lib = build_tool("loss_floor")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.loss_floor_run.argtypes = [I, I, I, P, P, P, P, P]
    props = torch.cuda.get_device_properties(0)
    sink = torch.empty(props.multi_processor_count * 2048, device="cuda")
    rng = np.random.default_rng(SEED + 5)
    threads, work = ctypes.c_int(0), ctypes.c_longlong(0)
    out = {}
    for fam, code in codes.items():
        y = rng.poisson(2.0, 1024) if fam == "poisson" \
            else rng.choice([-1.0, 1.0], 1024)
        rows = np.stack([y, 1.5 * rng.normal(size=1024),
                         rng.normal(size=1024), rng.random(1024)], axis=1)
        inp = torch.from_numpy(rows.astype(np.float32).ravel()).cuda()
        rec = {}
        for mode, key in ((0, "loss_ns"), (1, "stats_ns")):
            def run():
                check(lib.loss_floor_run(
                    code, mode, 1000, inp.data_ptr(), sink.data_ptr(),
                    ctypes.byref(threads), ctypes.byref(work),
                    torch.cuda.current_stream().cuda_stream) == 0,
                    f"loss_floor {fam} mode {mode}: launch failed")
            ms = time_ms(torch, run, 3, warmup=1)
            rec[key] = ms * 1e6 / work.value
        out[fam] = rec
    return out


def shifted(torch, v, m: int):
    """The first m entries of v in a contiguous view one element into its
    storage: 4 bytes past a 16-byte boundary (None stays None)."""
    if v is None:
        return None
    return torch.cat([v.new_zeros(1), v[:m]])[1:]


def timed_bound(n_vec: float, n_ops: float, op_ns: float):
    """(bound ms, "bytes" or "operations", bytes ms, operations ms): the
    larger of n_vec bytes over the memory rate and n_ops operations of
    op_ns each on the whole card (a probe of tools/loss_floor.cu)."""
    t_bytes = n_vec / H100_BYTES_PER_S * 1e3
    t_ops = n_ops * op_ns * 1e-6
    return ((t_ops, "operations") if t_ops >= t_bytes else
            (t_bytes, "bytes")) + (t_bytes, t_ops)


def k1_report(np, torch, rng, sets, floors, floor_lib, tol, parity):
    """K1 against its plain version at each n of ``sets`` ({n: (y, wobs,
    off, xb, xdb)}) for the four families, and at n - 1 rows with every
    vector one element off a 16-byte boundary (the element path and a
    tail); timed at each n with its launch floor and its bound."""
    from repro_torch.kernels import glm_stats as glm_stats_k
    from repro_torch.kernels import ops, ref

    err = 0.0
    for n, (y, wobs, off, xb, _) in sets.items():
        for fam in glm_stats_k.FAMILY_CODES:
            yy = labels_for(np, torch, rng, fam, y)
            cases = [("", (yy, xb, wobs, off)),
                     ("/unaligned", tuple(shifted(torch, v, n - 1)
                                          for v in (yy, xb, wobs, off)))]
            for tag, (a_y, a_xb, a_w, a_off) in cases:
                got = ops.glm_stats(a_y, a_xb, fam, weights=a_w,
                                    offset=a_off)
                want = ref.glm_stats(a_y, a_xb, a_w, fam, offset=a_off)
                e = max(errs(a, b)[1] for a, b in zip(got, want))
                parity[f"glm_stats/n={n}/{fam}{tag}"] = e
                check(e <= tol["glm_stats_probit" if fam == "probit"
                               else "glm_stats"],
                      f"glm_stats n={n} {fam}{tag}: error {e}")
                err = max(err, max(errs(a, b)[0] for a, b in zip(got, want)))
    shapes = []
    for n, (y, wobs, off, xb, _) in sets.items():
        ms = time_ms(torch, lambda: glm_stats_k.launch(
            y, xb, wobs, "logistic", offset=off), 200)
        plain = time_ms(torch, lambda: ref.glm_stats(
            y, xb, wobs, "logistic", offset=off), 50)
        nb = glm_stats_k.grid(n)
        floor = launch_floor(torch, floor_lib,
                             [(nb, 1, glm_stats_k.THREADS)], 200)
        # y, xb, weights and offset in, loss, s and w out
        b_ms, b_by, t_bytes, t_ops = timed_bound(
            n * 4.0 * (3 + (off is not None) + 3), n,
            floors["logistic"]["stats_ns"])
        shapes.append(dict(n=n, ms=ms, plain_ms=plain, bound_ms=b_ms,
                           bound_by=b_by, bytes_bound_ms=t_bytes,
                           stats_floor_ms=t_ops, share_of_bound=b_ms / ms,
                           launch_floor_ms=floor,
                           share_of_launch_floor=floor / ms, grid_blocks=nb))
    main = shapes[0]
    return dict(main, library_ms=None, max_abs_err=err, shapes=shapes,
                stats_floor_ns=floors["logistic"]["stats_ns"])


def k4_report(np, torch, rng, sets, floors, floor_lib, tol, parity):
    """K4 against its plain version for the four families at each n of
    ``sets`` and K = 14 (the Gauss-Seidel grid), 20 (its backtracking
    chain), 21, 294 (every candidate of the fused Jacobi superstep) and 321
    (past one 320-candidate pass); bit-identical over two calls, the
    ticket counter back at 0; timed at the main path's shapes beside the
    launch floor of its grid and its bound, the larger of its bytes and n
    K candidate losses at the probe's rate.  Returns (the report, the
    candidate counts)."""
    from repro_torch.core import linesearch
    from repro_torch.kernels import alpha_search as alpha_search_k
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda", torch.cuda.current_device())
    grid14 = linesearch.candidate_alphas(1e-3, 13, dev)
    chain = lambda k: linesearch.backtrack_chains(grid14[5:6], 0.5, k)[0]
    full = linesearch.full_candidates(1e-3, 13, 0.5, 20, device=dev)
    cand = {14: grid14, 20: chain(20), 21: chain(21), 294: full,
            321: torch.cat([full, chain(27)])}
    err = 0.0
    n_small = min(sets)
    for n, (y, wobs, off, xb, xdb) in sets.items():
        for fam in ("logistic", "squared", "probit", "poisson"):
            yy = labels_for(np, torch, rng, fam, y)
            for K, al in cand.items():
                got = ops.alpha_search(yy, xb, xdb, al, fam, weights=wobs,
                                       offset=off)
                want = ref.alpha_search(yy, xb, xdb, wobs, al, fam,
                                        offset=off)
                ea, e = errs(got, want)
                parity[f"alpha_search/n={n}/{fam}/K={K}"] = e
                check(e <= tol["alpha_search"],
                      f"alpha_search n={n} {fam} K={K}: error {e}")
                err = max(err, ea)
        # fixed rows and fixed-order sums, no float atomics: two calls
        # give the same bits; the last block leaves the ticket at 0
        for K, al in cand.items():
            runs = [alpha_search_k.launch(y, xb, xdb, wobs, al, "logistic",
                                          offset=off) for _ in range(2)]
            check(torch.equal(runs[0], runs[1]),
                  f"alpha_search n={n} K={K}: two calls differ")
        torch.cuda.synchronize()
        check(int(alpha_search_k.ticket(dev).item()) == 0,
              "alpha_search: the ticket counter is not back at 0")
    shapes = []
    for n, K in ((n_small, 14), (n_small, 20), (n_small, 21),
                 (n_small, 294), (N_DENSE, 14), (N_DENSE, 20),
                 (N_DENSE, 21)):
        y, wobs, off, xb, xdb = sets[n]
        al = cand[K]
        ms = time_ms(torch, lambda: alpha_search_k.launch(
            y, xb, xdb, wobs, al, "logistic", offset=off), 200)
        plain = time_ms(torch, lambda: ref.alpha_search(
            y, xb, xdb, wobs, al, "logistic", offset=off), 20)
        nb, threads = alpha_search_k.grid(n, K)
        floor = launch_floor(torch, floor_lib, [(nb, 1, threads)], 200)
        b_ms, b_by, t_bytes, t_ops = timed_bound(
            n * 4.0 * (4 + (off is not None)) + 8.0 * K, n * K,
            floors["logistic"]["loss_ns"])
        shapes.append(dict(n=n, K=K, ms=ms, plain_ms=plain, bound_ms=b_ms,
                           bound_by=b_by, bytes_bound_ms=t_bytes,
                           loss_floor_ms=t_ops, share_of_bound=b_ms / ms,
                           at_half_of_bound=b_ms / ms >= 0.5,
                           launch_floor_ms=floor,
                           share_of_launch_floor=floor / ms, grid_blocks=nb,
                           threads=threads))
    # the line's numbers are the Gauss-Seidel chain's, at the sparse fit's n
    main = shapes[1]
    return (dict(main, library_ms=None, max_abs_err=err, shapes=shapes,
                 loss_floor_ns=floors["logistic"]["loss_ns"]),
            sorted(cand))


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


# host idle time at each edge of a profiled fit's recording window
PROFILE_EDGE_S = 0.1


def profiled_fit(torch, solver, lam1, steps: int):
    """A ``steps``-superstep fit under torch.profiler: (the profiler, the
    fit's result, its host seconds, the logical launch counts of the fit,
    set to 0 just before it).  The profiler's first cycle is a warm-up, a
    one-superstep fit traced and thrown away; the measured fit is its
    second and last cycle.  The profiler keeps only the device records
    whose times, moved onto the host's clock, fall inside the recording
    window, and on the H100 those times were seen running up to about 2
    ms early: a fit launched at the window's edge lost its first kernels
    (tools/profile_records.py).  So the host idles PROFILE_EDGE_S at both
    edges, outside the timed fit."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import ops

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        solver.fit(lam1=lam1, max_outer=1)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_EDGE_S)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = solver.fit(lam1=lam1, max_outer=steps, tol=0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        logical = ops.launch_counts()
        time.sleep(PROFILE_EDGE_S)
    return prof, res, wall, logical


def cuda_function_counts(torch, prof, prefixes) -> dict:
    """{kernel: {CUDA function: device records}} of a profile, for the
    kernels of ``prefixes`` (kernel: name prefix of its CUDA functions)."""
    from torch.autograd import DeviceType

    found = {k: {} for k in prefixes}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        name = short_name(evt.key)
        for k, pre in prefixes.items():
            if name.startswith(pre):
                found[k][name] = found[k].get(name, 0) + evt.count
    return found


def cuda_launches(torch, solver, lam1, prefixes, steps: int = 2):
    """The CUDA launches behind each logical launch, counted by
    torch.profiler over a ``steps``-superstep fit.  ``prefixes`` maps a
    kernel to the name prefix of its CUDA functions; returns ({kernel:
    {CUDA function: launches}}, the logical launch counts, supersteps)."""
    prof, res, _, logical = profiled_fit(torch, solver, lam1, steps)
    return cuda_function_counts(torch, prof, prefixes), logical, res.n_iter


def fused_parity(np, torch, solver, dev, report, parity):
    """K5 and K6 against their plain versions on the full-size dense
    design (one tile marked dead), timed beside a library yardstick; K2's
    batched launch (the Jacobi sweep's solves) on K5's G and g."""
    from repro_torch.core import linesearch
    from repro_torch.kernels import cd_tile_solve as cd_tile_solve_k
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
    params = ops.solve_params(**kw, like=y)
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
            # K5's solve pass and K2's batched launch are the same chain:
            # on K5's own G and g both give the plain chain's bits
            chain = ref.jacobi_tile_solves(got[4], got[5], beta, penf=penf,
                                           tile_live=live, **kw)
            k2b = ops.jacobi_tile_solves(got[4], got[5], beta, params,
                                         penf=penf, tile_live=live)
            check(torch.equal(dbeta, chain),
                  "stats_gram_solve: step differs from the plain chain")
            check(torch.equal(k2b, chain),
                  "cd_tile_solve (batched): not bit-exact")
            G_all, g_all = got[4], got[5]
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
    order, n_all = ops.tile_order(None, nt, dev)
    report["cd_tile_solve"]["batched_ms"] = time_ms(
        torch, lambda: cd_tile_solve_k.launch_tiles(
            G_all, g_all, beta, params, order, n_all, penf), 100)
    report["cd_tile_solve"]["batched_tiles"] = n_all
    del G_all, g_all
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
    # fixed row ranges and fixed-order sums, no atomics: the same bits on
    # every run
    runs = [margin_ls_k.launch(X, dbeta, y, xb, wobs, cand, "logistic",
                               offset=off) for _ in range(2)]
    check(torch.equal(runs[0][0], runs[1][0])
          and torch.equal(runs[0][1], runs[1][1]),
          "margin_ls: two runs differ")
    del runs
    # torch.mv before and after the kernel; the faster of the two is kept
    k6_lib = time_ms(torch, lambda: torch.mv(X, dbeta), 10)
    k6_ms = time_ms(torch, lambda: margin_ls_k.launch(
        X, dbeta, y, xb, wobs, cand, "logistic", offset=off), 10)
    k6_lib2 = time_ms(torch, lambda: torch.mv(X, dbeta), 10)
    k6_plain = time_ms(torch, lambda: ref.fused_ls_dense(
        design.tiles3(), y, xb, dbeta, wobs, cand, "logistic", offset=off),
        3, 1)
    k6_bytes = (n * p + 5 * n + p + 2 * K) * 4.0
    b_ms, b_by = bound_ms(k6_bytes, 2.0 * n * p + 12.0 * n * K)
    k6_lib = min(k6_lib, k6_lib2)
    report["margin_ls"] = dict(
        ms=k6_ms, plain_ms=k6_plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=k6_lib, library_covers="xdb only (torch.mv)",
        share_of_bound=b_ms / k6_ms, library_share_of_bound=b_ms / k6_lib,
        max_abs_err=err6, K=K, bit_identical_runs=True,
        grid_blocks=margin_ls_k.grid(n, p),
        sm_count=torch.cuda.get_device_properties(dev).multi_processor_count)
    emit({"phase": "fused_kernel_parity", "n": n, "p_pad": p, "T": T,
          "n_tiles": nt, "n_live_parity": n_live, "K": K, "tolerance": tol,
          "max_rel_err": {k: v for k, v in parity.items()
                          if k.split("/")[0] in ("stats_gram_solve",
                                                 "margin_ls")},
          "stats_gram_solve": report["stats_gram_solve"],
          "margin_ls": report["margin_ls"]})

    # ---- the bf16 modes (precision="bf16") on the same inputs.  K5's
    # stats are held like fp32's; its G and g against the plain bf16 Gram
    # at the kernel's own w and s: a float32 s one ulp off the plain
    # version's crosses a bf16 rounding boundary now and then, and such a
    # term moves by 2^-8 of itself, which a cancelling sum such as g can
    # show above the tolerance though the Gram's arithmetic is right.  Its
    # step is the chain on its own G and g (bit for bit) and within 1e-4
    # of the plain version's whole function.
    tolb = {"stats_gram_solve_bf16": 1e-5, "stats_gram_solve_bf16_probit":
            3e-4, "stats_gram_solve_bf16_dbeta": 1e-4,
            "margin_ls_bf16": 1e-5}
    err5b = 0.0
    for fam in ("logistic", "squared", "probit", "poisson"):
        yy = labels_for(np, torch, rng, fam, y)
        got = ops.fused_stats_sweep(design, yy, xb, beta, fam, weights=wobs,
                                    offset=off, penf=penf, tile_live=live,
                                    precision="bf16", **kw)
        want = ref.stats_gram_solve(design.tiles3(), yy, xb, wobs, beta, fam,
                                    offset=off, penf=penf, tile_live=live,
                                    precision="bf16", **kw)
        e_st = max(errs(a, b)[1] for a, b in zip(got[:3], want[:3]))
        check(e_st <= tolb["stats_gram_solve_bf16_probit" if fam == "probit"
                           else "stats_gram_solve_bf16"],
              f"stats_gram_solve bf16 {fam}: stats error {e_st}")
        G_own, g_own = ref.shaped_tile_grams(
            nt, lambda ids: ref.gram_dense_tiles(
                design.tiles3()[ids], got[2], got[1], "bf16"), live)
        e_g = max(errs(got[4], G_own)[1], errs(got[5], g_own)[1])
        check(e_g <= tolb["stats_gram_solve_bf16"],
              f"stats_gram_solve bf16 {fam}: G, g error {e_g}")
        parity[f"stats_gram_solve_bf16/{fam}"] = max(e_st, e_g)
        parity[f"stats_gram_solve_bf16/{fam}/G_g_vs_plain_stats"] = max(
            errs(got[4], want[3])[1], errs(got[5], want[4])[1])
        check(not bool(got[4][3].any()) and not bool(got[3][3 * T:4 * T]
                                                     .any()),
              f"stats_gram_solve bf16 {fam}: the dead tile was touched")
        # (squared's w is the observation weight, 1 on every row here, and
        # bf16(1 x) = bf16(x) leaves its G symmetric)
        check(fam == "squared" or all(not torch.equal(got[4][t], got[4][t].T)
                                      for t in np.flatnonzero(live)),
              f"stats_gram_solve bf16 {fam}: a live tile's G is symmetric")
        asym = errs(got[4] - got[4].transpose(1, 2),
                    G_own - G_own.transpose(1, 2))[0] / float(
                        G_own.abs().max())
        check(asym <= tolb["stats_gram_solve_bf16"],
              f"stats_gram_solve bf16 {fam}: asymmetry off by {asym}")
        ed = float((got[3] - want[5]).abs().max()) / max(
            float(want[5].abs().max()), 1e-3)
        parity[f"stats_gram_solve_bf16/{fam}/dbeta"] = ed
        check(ed <= tolb["stats_gram_solve_bf16_dbeta"],
              f"stats_gram_solve bf16 {fam}: step error {ed}")
        chain = ref.jacobi_tile_solves(got[4], got[5], beta, penf=penf,
                                       tile_live=live, **kw)
        check(torch.equal(got[3], chain),
              f"stats_gram_solve bf16 {fam}: step differs from the chain")
        err5b = max(err5b, max(errs(a, b)[0] for a, b in
                               zip(got[:3], want[:3])),
                    errs(got[4], G_own)[0], errs(got[5], g_own)[0])
        del got, want, G_own, g_own
    k5b = lambda: sgs_k.launch(X, y, xb, wobs, off, beta, penf, params,
                               order, n_all, T, "logistic",
                               precision="bf16")
    runs = [k5b() for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "stats_gram_solve bf16: two runs differ")
    del runs
    k5b_ms = time_ms(torch, k5b, 10)
    k5b_plain = time_ms(torch, lambda: ref.stats_gram_solve(
        design.tiles3(), y, xb, wobs, beta, "logistic", offset=off,
        penf=penf, precision="bf16", **kw), 2, 1)
    X3 = X.view(n, nt, T)
    A16 = (X3 * w_[:, None, None]).to(torch.bfloat16).permute(1, 2, 0) \
        .contiguous()
    B16 = X3.to(torch.bfloat16).permute(1, 0, 2).contiguous()
    k5b_lib, k5b_what = library_bf16_ms(torch, A16, B16, 5)
    del A16, B16
    b_ms, b_by = bound_ms(k5_bytes, 2.0 * n * T * T * n_all,
                          H100_BF16_FLOPS)
    report["stats_gram_solve_bf16"] = dict(
        ms=k5b_ms, plain_ms=k5b_plain, bound_ms=b_ms, bound_by=b_by,
        share_of_bound=b_ms / k5b_ms, library_ms=k5b_lib,
        library_covers=f"G only, operands rounded beforehand: {k5b_what}",
        max_abs_err=err5b, n_live=n_all, bit_identical_runs=True)

    err6b = 0.0
    for fam in ("logistic", "squared", "probit", "poisson"):
        yy = labels_for(np, torch, rng, fam, y)
        got = ops.fused_ls(design, yy, xb, dbeta, cand, fam, weights=wobs,
                           offset=off, precision="bf16")
        want = ref.fused_ls_dense(design.tiles3(), yy, xb, dbeta, wobs, cand,
                                  fam, offset=off, precision="bf16")
        e = max(errs(a, b)[1] for a, b in zip(got, want))
        parity[f"margin_ls_bf16/{fam}"] = e
        check(e <= tolb["margin_ls_bf16"], f"margin_ls bf16 {fam}: {e}")
        err6b = max(err6b, max(errs(a, b)[0] for a, b in zip(got, want)))
    k6b = lambda: margin_ls_k.launch(X, dbeta, y, xb, wobs, cand, "logistic",
                                     offset=off, precision="bf16")
    runs = [k6b() for _ in range(2)]
    check(torch.equal(runs[0][0], runs[1][0])
          and torch.equal(runs[0][1], runs[1][1]),
          "margin_ls bf16: two runs differ")
    del runs
    k6b_ms = time_ms(torch, k6b, 10)
    k6b_plain = time_ms(torch, lambda: ref.fused_ls_dense(
        design.tiles3(), y, xb, dbeta, wobs, cand, "logistic", offset=off,
        precision="bf16"), 3, 1)
    X16 = X.to(torch.bfloat16)
    k6b_lib, k6b_what = library_bf16_ms(
        torch, X16, dbeta.to(torch.bfloat16)[:, None], 10)
    del X16
    # the products run on the fp32 pipes: the bound of the fp32 mode
    b_ms, b_by = bound_ms(k6_bytes, 2.0 * n * p + 12.0 * n * K)
    report["margin_ls_bf16"] = dict(
        ms=k6b_ms, plain_ms=k6b_plain, bound_ms=b_ms, bound_by=b_by,
        share_of_bound=b_ms / k6b_ms, library_ms=k6b_lib,
        library_covers=f"xdb only, from a bf16 copy of X (half the bytes): "
                       f"{k6b_what}",
        max_abs_err=err6b, K=K, bit_identical_runs=True)
    emit({"phase": "bf16_kernel_parity", "n": n, "p_pad": p, "T": T,
          "n_live_parity": n_live, "tolerance": tolb,
          "max_rel_err": {k: v for k, v in parity.items()
                          if k.split("/")[0].endswith("_bf16")},
          "stats_gram_solve_bf16": report["stats_gram_solve_bf16"],
          "margin_ls_bf16": report["margin_ls_bf16"],
          "tile_gram_bf16": report["tile_gram_bf16"]})


def closed_loop(batcher, reqs, n_req: int, n_clients: int):
    """``n_req`` requests of ``reqs`` from ``n_clients`` closed-loop client
    threads through ``batcher``: (results, failures, wall seconds, whether
    every client thread ended)."""
    outs = [None] * n_req
    failed = []

    def client(c):
        try:
            for i in range(c, n_req, n_clients):
                idx, val = reqs[i]
                outs[i] = batcher.submit(idx, val).get(timeout=60.0)
        except Exception as exc:          # reported by the caller
            failed.append(repr(exc))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300.0)
    return outs, failed, time.perf_counter() - t0, \
        not any(th.is_alive() for th in threads)


SERVE_REQUESTS, SERVE_CLIENTS = 4096, 32
SERVE_BUCKETS = dict(max_delay_ms=2.0, batch_buckets=(1, 4, 16, 64),
                     nnz_buckets=(32, 64, 128))


def traced_traffic(np, torch, model, reqs, dev, tdir) -> dict:
    """The serve phase's closed-loop traffic again, traced, through a fresh
    engine and batcher, the metrics registry at 0 just before: one
    ``serve/flush`` span a batch, ``serve.compiled_shapes`` equal to the
    engine's ``compile_count``, and the ``serve.latency_ms`` histogram's
    p50/p99 beside the batcher's own ``stats()``."""
    from repro_torch.obs import metrics, trace
    from repro_torch.serve import MicroBatcher, ScoringEngine

    metrics.registry().reset()
    trace.enable(tdir)
    eng = ScoringEngine(model, device=dev)
    batcher = MicroBatcher(eng, **SERVE_BUCKETS)
    batcher.warmup()
    outs, failed, wall, ended = closed_loop(batcher, reqs, SERVE_REQUESTS,
                                            SERVE_CLIENTS)
    batcher.close()
    spans = span_counts(save_shard(tdir, "serve"))
    st = batcher.stats()
    snap = metrics.registry().snapshot()
    hist = snap["histograms"]["serve.latency_ms"]
    flushes = {r: snap["counters"].get(f"serve.flush.{r}", 0.0)
               for r in ("full", "deadline", "close")}
    check(not failed and ended, f"serve traced: traffic failed {failed[:3]}")
    check(spans.get("serve/flush") == st["n_batches"]
          == sum(flushes.values()) and hist["n"] == st["n_requests"]
          == SERVE_REQUESTS,
          f"serve traced: {spans.get('serve/flush')} flush spans, "
          f"{flushes} flushes, {hist['n']} latencies for {st}")
    check(snap["counters"].get("serve.compiled_shapes")
          == eng.compile_count > 0,
          f"serve traced: serve.compiled_shapes "
          f"{snap['counters'].get('serve.compiled_shapes')} for "
          f"compile_count {eng.compile_count}")
    return {"wall_s": wall, "flush_spans": spans.get("serve/flush"),
            "flushes": flushes, "compiled_shapes": eng.compile_count,
            "latency_hist_p50_ms": metrics.snapshot_quantile(hist, 50),
            "latency_hist_p99_ms": metrics.snapshot_quantile(hist, 99),
            "stats": st}


def serve_phase(np, torch, solver, ds, dev, report, parity, floor_lib,
                tdir):
    """Serving on the sparse model: a 4-column artifact from warm-started
    fits, saved and loaded; K7 against its plain version; the test split
    through ``score_coo`` and ``GLMSolver.predict``; closed-loop traffic
    through ``MicroBatcher``, then again traced into ``tdir``.  Returns
    the launch counts of the untraced run."""
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

    # K7 at the serving shapes: 4096 test rows (bulk scoring) and 64 (the
    # batcher's largest bucket) in the J = 64 bucket, L = 4; beside each,
    # its launch floor, an empty kernel on its grid timed the same way
    J = 64
    table, b0 = eng._table, eng._b0
    A1, L = table.shape
    fit_rows = [r for r in reqs if len(r[0]) <= J]
    err7 = 0.0
    by_b = {}
    for B in (4096, 64):
        check(len(fit_rows) >= B, "serve: too few test rows for the J bucket")
        slots_h, vals_h = eng.pack_requests(fit_rows[:B], nnz_pad=J)
        slots = torch.from_numpy(slots_h).to(dev)
        vals = torch.from_numpy(vals_h).to(dev)
        for fam in ("logistic", "squared", "probit", "poisson"):
            for kind_ in ("link", "response"):
                got = ops.predict_tile(slots, vals, table, b0, fam,
                                       kind=kind_)
                want = ref.predict_tile(slots, vals, table, b0, fam,
                                        kind=kind_)
                ea, e = errs(got, want)
                parity[f"predict_tile/B={B}/{fam}/{kind_}"] = e
                check(e <= 1e-5, f"predict_tile B={B} {fam} {kind_}: "
                                 f"error {e}")
                err7 = max(err7, ea)
        k7_ms = time_ms(torch, lambda: predict_tile_k.launch(
            slots, vals, table, b0, "logistic", "response"), 200)
        blocks, threads = predict_tile_k.grid(B, J)
        floor = launch_floor(torch, floor_lib, [(blocks, 1, threads)], 200)
        b_ms, b_by = bound_ms((B * J * 2 + A1 * L + L + B * L) * 4.0,
                              2.0 * B * J * L + 4.0 * B * L)
        by_b[B] = dict(ms=k7_ms, launch_floor_ms=floor,
                       share_of_launch_floor=floor / k7_ms, bound_ms=b_ms,
                       bound_by=b_by, slots=slots, vals=vals)
    big = by_b[4096]
    slots, vals = big.pop("slots"), big.pop("vals")
    k7_plain = time_ms(torch, lambda: ref.predict_tile(
        slots, vals, table, b0, "logistic", kind="response"), 50)
    k7_lib = time_ms(torch, lambda: F.embedding_bag(
        slots, table, per_sample_weights=vals, mode="sum"), 200)
    small = {k: v for k, v in by_b[64].items() if k not in ("slots", "vals")}
    report["predict_tile"] = dict(
        **big, plain_ms=k7_plain, library_ms=k7_lib,
        library_covers="margins only (F.embedding_bag, mode sum)",
        max_abs_err=err7, B=4096, J=J, L=L, A1=A1,
        **{f"{k}_B64": v for k, v in small.items()})
    del by_b, slots, vals

    # the path: the counts at 0, then score_coo, predict and traffic
    calls = [0]
    score_packed = ScoringEngine.score_packed

    def counted(self, *a, **k):
        calls[0] += 1
        return score_packed(self, *a, **k)

    ScoringEngine.score_packed = counted
    try:
        batcher = MicroBatcher(eng, **SERVE_BUCKETS)
        batcher.warmup()
        n_warm = eng.compile_count
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        calls[0] = 0

        n_req, n_clients = SERVE_REQUESTS, SERVE_CLIENTS
        outs, failed, traffic_s, ended = closed_loop(batcher, reqs, n_req,
                                                     n_clients)
        batcher.close()
        n_traffic = eng.compile_count
        t0 = time.perf_counter()
        scores = eng.score_coo(Xte, kind="response")
        coo_s = time.perf_counter() - t0
        pred = solver.predict(Xte, kind="response")
        counts = ops.launch_counts()
    finally:
        ScoringEngine.score_packed = score_packed
    check(not failed and ended, f"serve: traffic failed {failed[:3]}")
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
    traced = traced_traffic(np, torch, model, reqs, dev, tdir)
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
          "predict_tile": report["predict_tile"], "traced": traced})
    return counts


# the lambda path at full width (sparse_path) and the CV (dense_cv): a grid
# of PATH_LAMBDAS from lambda_max down to PATH_RATIO of it; tol stops each
# lambda at 1e-6 of f (about a dozen float32 ulps of the sparse fit's f),
# and the cap bounds a KKT round's supersteps
PATH_LAMBDAS, PATH_RATIO = 12, 0.05
PATH_TOL, PATH_MAX_OUTER = 1e-6, 40
# dense_cv's cap: the standardized fused path takes 40 supersteps and more
# at its two smallest lambdas (NVIDIA H100 80GB HBM3, 700 W)
CV_MAX_OUTER = 200
KKT_SLACK = 1e-4            # fit_path's default, the test it re-checks


def path_probe(torch, solver):
    """Log the path's events on this one solver: each ``_run`` (lam1,
    active mask, supersteps, seconds, its ``step_s``), each gradient ``g``
    (the screening and KKT gradients) with its seconds, and each whole path
    (``_path_impl``: fit_cv runs one per fold after the full-data one) with
    its seconds; the card is synchronized around each, so the seconds are
    the host clock's for finished work.  ``release(solver)`` removes the
    probe."""
    events = []
    impl, run, grad = solver._path_impl, solver._run, solver._grad_state

    def timed(fn, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def probe_run(state, lam1, lam2, **kw):
        out, sec = timed(run, state, lam1, lam2, **kw)
        events.append({"run": lam1, "active": kw.get("active"),
                       "supersteps": out[2], "s": sec,
                       "step_s": out[1]["step_s"]})
        return out

    def probe_grad(state, weights=None):
        g, sec = timed(grad, state, weights)
        events.append({"grad": g, "s": sec})
        return g

    def probe_impl(*a, **k):
        out, sec = timed(impl, *a, **k)
        events.append({"path": sec})
        return out

    solver._path_impl = probe_impl
    solver._run, solver._grad_state = probe_run, probe_grad
    return events


def release(solver):
    del solver._path_impl, solver._run, solver._grad_state


def kkt_rounds(np, events, pf, T):
    """Per lambda of a screened path: (KKT rounds, live tiles of the last
    round, frozen coordinates violating the KKT test after it).  Each run
    is followed by its KKT gradient; a violation after a lambda's last
    round means the eighth round still found one."""
    out = {}
    for i, ev in enumerate(events):
        if "run" not in ev or ev["active"] is None:
            continue
        lam = ev["run"]
        g = events[i + 1]["grad"]
        act = ev["active"]
        viol = (~act) & (np.abs(g) > pf * lam * (1.0 + KKT_SLACK) + 1e-7)
        rounds = out.get(lam, (0,))[0] + 1
        out[lam] = (rounds, int(act.reshape(-1, T).any(axis=1).sum()),
                    int(viol.sum()))
    return out


def host_ms(torch, fn, reps: int) -> float:
    """Mean host milliseconds per call of ``fn``, the card synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def sparse_path_phase(np, torch, solver):
    """fit_path at full width, screened and then unscreened on the same
    grid, each with the launch counts and ``launch_stats`` at 0 just
    before; then one gradient check taken apart."""
    from repro_torch.kernels import ops

    nt, T = solver.design.n_tiles, solver.config.tile_size
    runs = {}
    grid = dict(n_lambdas=PATH_LAMBDAS, lam_ratio=PATH_RATIO)
    for screen in (True, False):
        events = path_probe(torch, solver)
        solver.launch_stats.update(dict.fromkeys(solver.launch_stats, 0))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        path = solver.fit_path(**grid, screen=screen,
                               max_outer=PATH_MAX_OUTER, tol=PATH_TOL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, st = ops.launch_counts(), dict(solver.launch_stats)
        release(solver)
        grid = dict(lambdas=path.lambdas)
        n_grad = sum("grad" in ev for ev in events)
        steps = [s for ev in events if "run" in ev for s in ev["step_s"]]
        runs[screen] = dict(
            path=path, counts=counts, stats=st, events=events,
            wall_s=wall, n_grad=n_grad,
            superstep_s=sum(ev["s"] for ev in events if "run" in ev),
            gradient_s=sum(ev["s"] for ev in events if "grad" in ev),
            mean_step_s=float(np.mean(steps)),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        tag = "sparse_path" + ("" if screen else " unscreened")
        f = path.f
        check(np.isfinite(f).all(), f"{tag}: non-finite f {f}")
        check(bool(path.converged.all()),
              f"{tag}: lambdas not converged {path.converged.tolist()} "
              f"after {path.n_iters.tolist()} supersteps")
        # the head: every feature at 0 (nnz counts the intercept besides)
        check(np.count_nonzero(path.betas[0]) == 0 and path.nnz[0] == 1,
              f"{tag}: head nnz {path.nnz[0]}")
        check(st["sweep_tile_launches"] + st["sweep_tiles_skipped"]
              == st["supersteps"] * nt, f"{tag}: tiles {st}")
        want = {"tile_gram": st["sweep_tile_launches"],
                "cd_tile_solve": st["sweep_tile_launches"],
                "alpha_search": 2 * st["supersteps"],
                "glm_stats": st["supersteps"] + n_grad}
        got = {k: counts[k] for k in want}
        check(got == want and sum(counts.values()) == sum(want.values()),
              f"{tag}: launches {counts} != {want}")
    scr, uns = runs[True], runs[False]
    check(scr["stats"]["sweep_tiles_skipped"] > 0,
          f"sparse_path: no tile skipped {scr['stats']}")
    check(uns["stats"]["sweep_tiles_skipped"] == 0,
          f"sparse_path unscreened: tiles skipped {uns['stats']}")
    pf = solver._penf_host
    lambdas = scr["path"].lambdas
    kkt = kkt_rounds(np, scr["events"], pf, T)
    bad = {lam: v for lam, v in kkt.items() if v[2]}
    check(len(kkt) == len(lambdas) and not bad,
          f"sparse_path: KKT violated after the last round at {bad}")
    fs, fu = scr["path"].f, uns["path"].f
    gap = fs - fu - 1e-5 * np.maximum(1.0, np.abs(fu))
    check(bool((gap <= 0).all()),
          f"sparse_path: screened f above unscreened {fs} {fu}")
    # a gradient check at the path's last state, taken apart: K1, the
    # brick X^T s (a host loop of 65 einsums) and the copy of g to the
    # host; device ms from CUDA events (one call behind the sleep kernel),
    # host ms synchronized
    y, xb = solver._ys, solver._state.xb
    w, o = solver._wobs, solver._offsets
    _, s_i, _ = ops.glm_stats(y, xb, "logistic", weights=w, offset=o)
    rmatvec = lambda: solver.design.rmatvec(s_i)
    g = rmatvec()
    split = {"glm_stats_ms": time_ms(torch, lambda: ops.glm_stats(
                 y, xb, "logistic", weights=w, offset=o), 20),
             "rmatvec_ms": time_ms(torch, rmatvec, 1),
             "rmatvec_host_ms": host_ms(torch, rmatvec, 5),
             "to_host_ms": host_ms(torch, lambda: g.cpu(), 5),
             "check_host_ms": host_ms(torch, lambda: solver._grad_state(
                 solver._state), 5)}
    del g, s_i
    # standardize=True's passes on these bricks (scale-only): the moments,
    # tile by tile, and the new scaled copy, with the memory each adds above
    # what is held
    d = solver.design
    scale = torch.ones(d.n_tiles * T, device=d.device)
    std = {"bricks_gb": d.bricks.numel() * 4 / 1e9}
    for name, fn in (("col_moments", lambda: d.col_moments(w)),
                     ("scale_columns", lambda: d.scale_columns(scale))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        std[name + "_ms"] = host_ms(torch, fn, 1)
        std[name + "_extra_gb"] = \
            (torch.cuda.max_memory_allocated() - held) / 1e9
    per_lambda = [{"lam1": float(lam), "n_iters": int(scr["path"].n_iters[k]),
                   "kkt_rounds": kkt[lam][0], "live_tiles": kkt[lam][1],
                   "nnz": int(scr["path"].nnz[k]),
                   "f": float(fs[k]), "f_unscreened": float(fu[k]),
                   "n_iters_unscreened": int(uns["path"].n_iters[k])}
                  for k, lam in enumerate(map(float, lambdas))]
    emit({"phase": "sparse_path", "n_lambdas": len(lambdas),
          "lam_ratio": PATH_RATIO, "tol": PATH_TOL,
          "max_outer": PATH_MAX_OUTER, "per_lambda": per_lambda,
          **{("" if s else "unscreened_") + k: runs[s][k]
             for s in (True, False)
             for k in ("wall_s", "superstep_s", "gradient_s", "n_grad",
                       "mean_step_s", "peak_mem_gb", "stats", "counts")},
          "launches_per_superstep": {
              k: v / scr["stats"]["supersteps"]
              for k, v in scr["counts"].items() if v},
          "gradient_check": split, "standardize": std,
          "max_screened_minus_unscreened": float((fs - fu).max())})
    return scr["path"]


def path_reference_phase(np, GLMSolver, DGLMNETConfig, synthetic, dev):
    """Small paths and a small CV on the card against the same on the CPU
    (the card takes the CPU's grid): per lambda f within 1e-4 relative,
    beta within 1e-3 and nnz equal; the CV's dev_mean within 1e-4 relative
    and the same best_index."""
    out = {}
    couplings = {"gauss-seidel": DGLMNETConfig(tile_size=256),
                 "jacobi-fused": DGLMNETConfig(tile_size=256,
                                               coupling="jacobi")}
    small = {"sparse": synthetic.make_sparse(n=3000, p=700, avg_nnz=20,
                                             k_true=30, seed=SEED + 1),
             "dense": synthetic.make_dense(n=3000, p=300, k_true=20,
                                           seed=SEED + 1)}
    for kind, data in small.items():
        for coupling, cfg in couplings.items():
            paths = []
            for d in ("cpu", dev):
                s = GLMSolver(data.train.X, data.train.y, config=cfg,
                              fit_intercept=True, device=d)
                grid = dict(lambdas=paths[0].lambdas) if paths else \
                    dict(n_lambdas=6, lam_ratio=0.05)
                paths.append(s.fit_path(**grid, max_outer=30, tol=1e-4))
            pc, pg = paths
            f_err = float(np.max(np.abs(pg.f / pc.f - 1)))
            b_err = float(np.max(np.abs(pg.betas - pc.betas)))
            out[f"{kind}/{coupling}"] = {
                "f_rel_err": f_err, "beta_abs_err": b_err,
                "nnz_cpu": pc.nnz.tolist(), "nnz_gpu": pg.nnz.tolist(),
                "n_iters_cpu": pc.n_iters.tolist(),
                "n_iters_gpu": pg.n_iters.tolist()}
            check(f_err <= 1e-4 and b_err <= 1e-3
                  and np.array_equal(pc.nnz, pg.nnz),
                  f"path_reference {kind} {coupling}: f {f_err} beta "
                  f"{b_err} nnz {pc.nnz.tolist()} {pg.nnz.tolist()}")
    cvs = []
    for d in ("cpu", dev):
        s = GLMSolver(small["dense"].train.X, small["dense"].train.y,
                      config=couplings["jacobi-fused"], fit_intercept=True,
                      standardize=True, device=d)
        grid = dict(lambdas=cvs[0].lambdas) if cvs else \
            dict(n_lambdas=6, lam_ratio=0.01)
        cvs.append(s.fit_cv(n_folds=3, **grid, max_outer=30, tol=1e-4))
    cc, cg = cvs
    dev_err = float(np.max(np.abs(cg.dev_mean / cc.dev_mean - 1)))
    out["dense_cv_standardized"] = {
        "dev_mean_rel_err": dev_err, "best_index_cpu": cc.best_index,
        "best_index_gpu": cg.best_index}
    check(dev_err <= 1e-4 and cc.best_index == cg.best_index,
          f"path_reference cv: dev_mean {dev_err}, best index "
          f"{cc.best_index} {cg.best_index}")
    emit({"phase": "path_reference",
          "tolerance": {"f_rel": 1e-4, "beta_abs": 1e-3, "nnz": "equal",
                        "dev_mean_rel": 1e-4}, **out})


def dense_cv_phase(np, torch, GLMSolver, DGLMNETConfig, dd, dev):
    """fit_cv at full width: the dense split standardized (centered, with
    an intercept), fused Jacobi, 3 folds over an 8-lambda grid.  Every
    lambda of every path must converge within CV_MAX_OUTER supersteps.  On
    this split the validation deviance still falls at the grid's last
    lambda, so the selection lands on the grid's end: the phase holds the
    mechanics (folds, deviances, the refit at best_index), not an interior
    minimum."""
    from repro_torch.kernels import ops

    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    s = full_size_solver(GLMSolver, dd, dev, DGLMNETConfig(
        coupling="jacobi"), standardize=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    data = s.design.data
    design_gb = data.numel() * 4 / 1e9
    setup_peak = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    held = (torch.cuda.memory_allocated() - mem0) / 1e9
    # one copy is held after construction: the unscaled one was freed
    check(held < 1.2 * design_gb,
          f"dense_cv: {held} GB held after standardization for a "
          f"{design_gb} GB design")
    check(bool((data[:, s._icol()] == 1.0).all()),
          "dense_cv: the intercept column is not exact ones")
    # standardization's two device passes, timed again on the scaled
    # design (the same shapes): the moments, and the new scaled copy
    std_ms = {"col_moments_ms": host_ms(
                  torch, lambda: s.design.col_moments(s._wobs), 1),
              "scale_columns_ms": host_ms(
                  torch, lambda: s.design.scale_columns(
                      s._put(s._scale_packed), s._put(s._center_packed)), 1)}

    events = path_probe(torch, s)
    t0 = time.perf_counter()
    lmax = s.lambda_max()
    torch.cuda.synchronize()
    lmax_s = time.perf_counter() - t0
    s.launch_stats.update(dict.fromkeys(s.launch_stats, 0))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    n_before = len(events)
    t0 = time.perf_counter()
    cv = s.fit_cv(n_folds=3, n_lambdas=8, lam_ratio=1e-2,
                  max_outer=CV_MAX_OUTER, tol=PATH_TOL)
    torch.cuda.synchronize()
    cv_s = time.perf_counter() - t0
    counts, st = ops.launch_counts(), dict(s.launch_stats)
    peak = torch.cuda.max_memory_allocated() / 1e9
    release(s)
    events = events[n_before:]
    n_grad = sum("grad" in ev for ev in events)
    paths_s = [ev["path"] for ev in events if "path" in ev]
    check(np.isfinite(cv.dev_mean).all(),
          f"dense_cv: dev_mean {cv.dev_mean}")
    check(len(paths_s) == 4 and bool(cv.path.converged.all()),
          f"dense_cv: lambdas not converged {cv.path.converged.tolist()} "
          f"after {cv.path.n_iters.tolist()} supersteps")
    check(np.array_equal(cv.beta, cv.path.betas[cv.best_index]),
          "dense_cv: beta is not the full-data path's at best_index")
    want = {"stats_gram_solve": st["supersteps"],
            "margin_ls": st["supersteps"], "glm_stats": n_grad}
    check(counts == {k: want.get(k, 0) for k in counts},
          f"dense_cv: launches {counts} != {want}")
    check(st["sweep_tile_launches"] + st["sweep_tiles_skipped"]
          == st["supersteps"] * s.design.n_tiles, f"dense_cv: tiles {st}")
    emit({"phase": "dense_cv", "train_shape": list(dd.train.X.shape),
          "design_gb": design_gb, "setup_s": setup_s,
          "standardize": std_ms, "setup_peak_gb": setup_peak,
          "held_after_setup_gb": held, "lambda_max": lmax,
          "lambda_max_s": lmax_s, "cv_s": cv_s,
          "full_path_s": paths_s[0], "fold_path_s": paths_s[1:],
          "gradient_s": sum(ev["s"] for ev in events if "grad" in ev),
          "n_grad": n_grad, "superstep_s_mean": float(np.mean(
              [x for ev in events if "run" in ev for x in ev["step_s"]])),
          "dev_mean": cv.dev_mean.tolist(), "dev_se": cv.dev_se.tolist(),
          "best_index": cv.best_index, "lam_best": cv.lam_best,
          "selection_at_grid_end": cv.best_index == len(cv.lambdas) - 1,
          "max_outer": CV_MAX_OUTER,
          "nnz": cv.path.nnz.tolist(), "n_iters": cv.path.n_iters.tolist(),
          "converged": cv.path.converged.tolist(), "stats": st,
          "launches": counts, "peak_mem_gb": peak})


# checkpoint: the sparse fit cut at CKPT_CUT supersteps (a save every
# CKPT_EVERY) and resumed in a fresh session, against the fit run through
# (tol 0: a fit stops only where f repeats to the last bit, or at
# CKPT_MAX_OUTER); the path cut after PATH_CUT of sparse_path's lambdas
CKPT_EVERY, CKPT_CUT, CKPT_MAX_OUTER, PATH_CUT = 5, 10, 20, 6
# multinomial: classes, nonzero rows of B a class, cycles
MN_CLASSES, MN_SUPPORT, MN_CYCLES = 4, 50, 3


def checkpoint_phase(np, torch, GLMSolver, solver, ds, dev, path):
    """Checkpoints of the sparse solver (``fit(ckpt_manager=)`` saved
    synchronously, ``fit_path(ckpt_manager=)`` asynchronously), each cut
    and resumed in a fresh session.  Two fits run through first show
    whether the card's fits give the same bits; if they do the resumed
    beta, f and alpha are held to those bits, else within 1e-6.  ``path``
    is sparse_path's screened path, the uninterrupted one."""
    from repro_torch.checkpoint import CheckpointManager

    class Timed(CheckpointManager):
        """Records each save's seconds: the call (what the fit waits for)
        and until the checkpoint is durable (the writer joined)."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.saves = []

        def save(self, step, tree, *, metadata=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().save(step, tree, metadata=metadata)
            call = time.perf_counter() - t0
            self.wait()
            self.saves.append({"step": step, "call_ms": call * 1e3,
                               "durable_ms":
                                   (time.perf_counter() - t0) * 1e3})

    def on_disk(mgr):
        d = mgr.dir / f"ckpt_{mgr.latest_step()}"
        return sum(f.stat().st_size for f in d.iterdir())

    fit = dict(lam1=LAM1_FRACTION * solver.lambda_max(), tol=0.0)
    runs = [solver.fit(max_outer=CKPT_MAX_OUTER, **fit) for _ in range(2)]
    full = runs[0]
    same = np.array_equal(runs[0].beta, runs[1].beta) and all(
        runs[0].history[k] == runs[1].history[k] for k in ("f", "alpha"))
    twice_gap = float(np.abs(runs[0].beta - runs[1].beta).max())
    check(full.n_iter > CKPT_EVERY, f"checkpoint: the fit stops after "
          f"{full.n_iter} supersteps, before its first save")
    cut = min(CKPT_CUT, CKPT_EVERY * ((full.n_iter - 1) // CKPT_EVERY))
    pargs = dict(max_outer=PATH_MAX_OUTER, tol=PATH_TOL)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        fit_mgr = Timed(tmp / "fit")
        solver.fit(max_outer=cut, ckpt_manager=fit_mgr,
                   ckpt_every=CKPT_EVERY, **fit)
        check(fit_mgr.latest_step() == cut,
              f"checkpoint: last save {fit_mgr.latest_step()}, cut {cut}")
        fit_bytes = on_disk(fit_mgr)
        st = solver._state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back, _ = fit_mgr.restore({"beta": st.beta, "xb": st.xb,
                                   "mu": st.mu})
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        check(all(v.is_cuda for v in back.values()),
              "checkpoint: restore left a tensor off the card")
        del back, st
        path_mgr = Timed(tmp / "path", async_save=True)
        solver.fit_path(lambdas=path.lambdas[:PATH_CUT],
                        ckpt_manager=path_mgr, **pargs)
        path_bytes = on_disk(path_mgr)

        t0 = time.perf_counter()
        fresh = full_size_solver(GLMSolver, ds, dev)
        torch.cuda.synchronize()
        fresh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = fresh.fit(max_outer=CKPT_MAX_OUTER, ckpt_every=CKPT_EVERY,
                        ckpt_manager=CheckpointManager(tmp / "fit"), **fit)
        resume_fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pres = fresh.fit_path(lambdas=path.lambdas, **pargs,
                              ckpt_manager=CheckpointManager(tmp / "path"))
        resume_path_s = time.perf_counter() - t0
        del fresh
    torch.cuda.empty_cache()

    def held(a, b):
        """The same bits on a deterministic card, else within 1e-6."""
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.array_equal(a, b) if same else \
            bool(np.all(np.abs(a - b) <= 1e-6 * np.maximum(1.0, np.abs(b))))

    gaps = {"fit_beta": float(np.abs(res.beta - full.beta).max()),
            "path_prefix_beta": float(np.abs(
                pres.betas[:PATH_CUT] - path.betas[:PATH_CUT]).max()),
            "path_tail_beta": float(np.abs(
                pres.betas[PATH_CUT:] - path.betas[PATH_CUT:]).max()),
            "path_tail_f_rel": float(np.max(np.abs(
                pres.f[PATH_CUT:] / path.f[PATH_CUT:] - 1)))}
    check(res.n_iter == full.n_iter,
          f"checkpoint: resumed n_iter {res.n_iter} != {full.n_iter}")
    check(held(res.beta, full.beta) and all(
        held(res.history[k], full.history[k][cut:]) for k in ("f", "alpha")),
        f"checkpoint: the resumed fit parts from the uninterrupted one "
        f"{gaps}")
    check(np.array_equal(pres.betas[:PATH_CUT], path.betas[:PATH_CUT])
          if same else held(pres.betas[:PATH_CUT], path.betas[:PATH_CUT]),
          f"checkpoint: the path's completed prefix changed {gaps}")
    check(np.array_equal(pres.nnz, path.nnz)
          and np.array_equal(pres.n_iters, path.n_iters)
          and held(pres.f, path.f) and held(pres.betas, path.betas),
          f"checkpoint: the resumed path's tail parts {gaps} nnz "
          f"{pres.nnz.tolist()} {path.nnz.tolist()} n_iters "
          f"{pres.n_iters.tolist()} {path.n_iters.tolist()}")
    emit({"phase": "checkpoint", "deterministic": bool(same),
          "two_runs_beta_gap": twice_gap, "n_iter": full.n_iter, "cut": cut,
          "ckpt_every": CKPT_EVERY, "path_cut": PATH_CUT,
          "n_lambdas": len(path.lambdas), "fit_ckpt_bytes": fit_bytes,
          "path_ckpt_bytes": path_bytes, "fit_saves_sync": fit_mgr.saves,
          "path_saves_async": path_mgr.saves, "restore_ms": restore_ms,
          "fresh_session_s": fresh_s, "resume_fit_s": resume_fit_s,
          "resume_path_s": resume_path_s, "gaps": gaps,
          "f_after_cut": res.history["f"],
          "alpha_after_cut": res.history["alpha"]})


# the trace phase: supersteps of the traced fit and its checkpoint period,
# the lambdas of sparse_path's grid it traces (from the third: the strong
# rule at a cold start below lambda_max misses coordinates, so KKT rounds
# follow), traced and untraced fits timed in turns, disabled spans timed
TRACE_STEPS, TRACE_CKPT_EVERY = 5, 2
TRACE_PATH_FROM, TRACE_PATH_LAMBDAS = 2, 4
TRACE_TURNS = (False, True, True, False, False, True)
TRACE_NOOP_SPANS, RECORD_LAUNCH_CALLS = 1000, 100_000
K1_K4 = {"glm_stats": "glm_stats_", "tile_gram": "tile_gram_",
         "cd_tile_solve": "cd_tile_solve_", "alpha_search": "alpha_search_"}


def save_shard(tdir, tag: str):
    """Write the enabled tracer's events as ``trace_<pid>_<tag>.json`` in
    ``tdir`` (each traced part of the run its own shard, so a later
    ``enable`` overwrites none), then disable it; returns its events."""
    from repro_torch.obs import trace

    tr = trace.get_tracer()
    tr.save(pathlib.Path(tdir) / f"trace_{tr.pid}_{tag}.json")
    trace.disable()
    return tr.export()["traceEvents"]


def span_counts(events) -> dict:
    out = {}
    for e in events:
        if e["ph"] == "B":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def ranges_hold_launches(torch, prof, name: str, prefixes) -> tuple:
    """(the host ranges named ``name`` in a profile, {kernel: [device
    records, records whose host launch was found, launches inside a
    range]}) for the kernels of ``prefixes``.  A record's launch is the
    runtime call with its correlation id, on the host's clock."""
    from torch.autograd import DeviceType

    evs = prof.events()
    ranges = [(e.time_range.start, e.time_range.end) for e in evs
              if e.name == name and e.device_type == DeviceType.CPU]
    launch_at = {e.id: e.time_range.start for e in evs
                 if e.device_type == DeviceType.CPU and "aunch" in e.name}
    out = {k: [0, 0, 0] for k in prefixes}
    for e in evs:
        if e.device_type != DeviceType.CUDA:
            continue
        kname = short_name(e.name)
        for k, pre in prefixes.items():
            if kname.startswith(pre):
                out[k][0] += 1
                t = launch_at.get(e.id)
                if t is not None:
                    out[k][1] += 1
                    out[k][2] += any(a <= t <= b for a, b in ranges)
    return ranges, out


def tracing_parts(torch, tdir) -> dict:
    """Median us of each part of tracing a superstep, alone, over
    TRACE_NOOP_SPANS calls: a disabled span, an enabled span with its
    ``record_function`` and NVTX ranges, one convergence event written and
    flushed into ``tdir`` (the trace directory's file system); and their
    sum for the one span and one event a traced superstep adds."""
    from repro_torch.obs import convergence, trace
    from repro_torch.timing import percentiles

    def median_us(fn):
        out = []
        for _ in range(TRACE_NOOP_SPANS):
            t0 = time.perf_counter_ns()
            fn()
            out.append((time.perf_counter_ns() - t0) / 1e3)
        return percentiles(out)["p50"]

    def span_in(tr):
        def fn():
            with tr.span("bench/noop"):
                pass
        return fn

    event = dict(step=1, outer_it=1, lam1=1.0, lam2=0.0, f=1.0, loss=1.0,
                 deviance=1.0, alpha=1.0, mu=1.0, nnz=1, accepted_unit=1.0,
                 active_size=1, supersteps=1, sweep_tile_launches=65,
                 sweep_tiles_skipped=0, step_us=20000.0)
    path = pathlib.Path(tdir) / "bench.jsonl"
    with convergence.ConvergenceStream(path) as cs:
        emit_us = median_us(lambda: cs.emit(**event))
    path.unlink()
    span_us = median_us(span_in(trace.Tracer()))
    return {"disabled_span_us_median": median_us(span_in(trace.NullTracer())),
            "enabled_span_us_median": span_us,
            "stream_event_us_median": emit_us,
            "tracing_us_per_superstep": span_us + emit_us}


def trace_phase(np, torch, solver, path, tdir, card):
    """The sparse fit traced (``repro_torch.obs``), through the entry
    points a user calls: ``trace.enable``, a convergence stream on the
    session, ``fit`` with checkpoints and its resume, a profiled
    superstep, a screened ``fit_path`` over TRACE_PATH_LAMBDAS lambdas of
    sparse_path's grid, then ``trace_report`` over the directory.  Gates:
    the traced fit equals the untraced one bit for bit (beta, f, alpha,
    n_iter, launch counts); one stream event a superstep with f equal to
    ``history["f"]``; the span counts; ``launch_trace`` of one superstep
    equal to its ``launch_counts``; the profiled superstep's range
    holding the host launches of K1-K4; the path's stream context.  Then
    the overheads: traced and untraced ``superstep_s`` in turns, the
    disabled span, ``record_launch`` outside a trace."""
    import collections
    import contextlib

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch import trace_report
    from repro_torch.obs import convergence, metrics, trace

    t_phase = time.perf_counter()
    nt = solver.design.n_tiles
    lam1 = LAM1_FRACTION * solver.lambda_max()
    fit = dict(lam1=lam1, max_outer=TRACE_STEPS, tol=0.0,
               ckpt_every=TRACE_CKPT_EVERY)

    def counted(**kw):
        ops.reset_launch_counts()
        res = solver.fit(**kw)
        torch.cuda.synchronize()
        return res, ops.launch_counts()

    with tempfile.TemporaryDirectory(prefix="trace-ckpt-") as ck:
        ck = pathlib.Path(ck)
        plain, plain_counts = counted(
            ckpt_manager=CheckpointManager(ck / "untraced"), **fit)
        tr = trace.enable(tdir)
        conv_path = pathlib.Path(tdir) / f"convergence_{tr.pid}.jsonl"
        stream = convergence.ConvergenceStream(conv_path)
        solver.set_convergence_stream(stream)
        traced, traced_counts = counted(
            ckpt_manager=CheckpointManager(ck / "traced"), **fit)
        n_fit = stream.n_events
        fit_spans = span_counts(tr.export()["traceEvents"])
        resumed = solver.fit(ckpt_manager=CheckpointManager(ck / "traced"),
                             **fit)
        torch.cuda.synchronize()
    spans = span_counts(tr.export()["traceEvents"])
    check(np.array_equal(traced.beta, plain.beta)
          and traced.history["f"] == plain.history["f"]
          and traced.history["alpha"] == plain.history["alpha"]
          and traced.n_iter == plain.n_iter == TRACE_STEPS
          and traced_counts == plain_counts,
          f"trace: the traced fit differs from the untraced one: n_iter "
          f"{traced.n_iter} / {plain.n_iter}, f {traced.history['f']} / "
          f"{plain.history['f']}, launches {traced_counts} / "
          f"{plain_counts}, beta gap "
          f"{float(np.abs(traced.beta - plain.beta).max())}")
    evs = convergence.read_events(conv_path)
    check(n_fit == TRACE_STEPS and [e["f"] for e in evs[:n_fit]]
          == traced.history["f"] and all(e["step_us"] for e in evs),
          f"trace: {n_fit} stream events, f {[e['f'] for e in evs]} for "
          f"{traced.history['f']}")
    n_saves = TRACE_STEPS // TRACE_CKPT_EVERY
    check(fit_spans == {"solver/superstep": TRACE_STEPS,
                        "ckpt/save": n_saves, "ckpt/commit": n_saves},
          f"trace: spans of the traced fit {fit_spans}")
    # the resumed fit restores the last save and runs the supersteps after
    # it, to the fit run through
    check(spans.get("ckpt/restore") == 1 and resumed.n_iter == TRACE_STEPS
          and np.array_equal(resumed.beta, traced.beta)
          and resumed.history["f"] == traced.history["f"][n_saves
                                                         * TRACE_CKPT_EVERY:],
          f"trace: resume spans {spans}, n_iter {resumed.n_iter}, f "
          f"{resumed.history['f']}")

    # one profiled superstep, traced: its range, its K1-K4 launches, and
    # the span's us beside step_s and the device's busy time
    prof, pres, pwall, _ = profiled_fit(torch, solver, lam1, 1)
    ranges, held = ranges_hold_launches(torch, prof, "solver/superstep",
                                        K1_K4)
    want_rec = {"glm_stats": 1, "alpha_search": 2}
    check(len(ranges) == 1 and all(
        n_rec >= want_rec.get(k, nt) and n_rec == found == inside
        for k, (n_rec, found, inside) in held.items()),
        f"trace: profiled superstep ranges {len(ranges)}, K1-K4 records "
        f"[records, launches found, inside] {held}")
    busy = device_idle(torch, prof, pwall)
    prof_span_us = convergence.read_events(conv_path)[-1]["step_us"]
    del prof

    # a screened path over part of sparse_path's grid
    lambdas = path.lambdas[TRACE_PATH_FROM:TRACE_PATH_FROM
                           + TRACE_PATH_LAMBDAS]
    n0 = stream.n_events
    tpath = solver.fit_path(lambdas=lambdas, max_outer=PATH_MAX_OUTER,
                            tol=PATH_TOL)
    pev = convergence.read_events(conv_path)[n0:]
    check(len(pev) == int(tpath.n_iters.sum()), f"trace path: {len(pev)} "
          f"events for {tpath.n_iters.tolist()} supersteps")
    rounds = collections.Counter()
    ctx_ok = True
    for e in pev:
        k = e["lam_index"]
        if e["outer_it"] == 1:
            rounds[k] += 1
        first = rounds[k] == 1
        ctx_ok &= isinstance(e["screened"], int) and e["screened"] >= 0 and (
            e["kkt_violations"] is None if first
            else isinstance(e["kkt_violations"], int)
            and e["kkt_violations"] > 0)
    ctx = [(e["lam_index"], e["outer_it"], e["screened"],
            e["kkt_violations"]) for e in pev]
    check(sorted(rounds) == list(range(len(lambdas))) and ctx_ok,
          f"trace path: lam_index rounds {dict(rounds)}, context "
          f"{ctx[:20]}")
    solver.set_convergence_stream(None)
    stream.close()
    all_spans = span_counts(save_shard(tdir, "fit"))

    # logical launches of one superstep, against the kernels' counts
    ops.reset_launch_counts()
    with ops.launch_trace() as lev:
        solver.fit(lam1=lam1, max_outer=1, tol=0.0)
    torch.cuda.synchronize()
    delta = ops.launch_counts()
    by = collections.Counter(lev)
    want = {"glm_stats": 1, "cd_tile_solve": nt, "tile_gram": nt,
            "alpha_search": 2}
    check({k: by.get(k, 0) for k in want} == {k: delta[k] for k in want}
          == want and set(by) <= set(want) | {"matvec"}
          and sum(delta.values()) == sum(want.values()),
          f"trace: launch_trace {dict(by)} against launch_counts {delta}")

    # overheads: traced and untraced superstep_s in turns (the traced fits
    # with a stream), then each part of the tracing alone
    turns = []
    with tempfile.TemporaryDirectory(prefix="trace-turns-") as td:
        for i, on in enumerate(TRACE_TURNS):
            with contextlib.ExitStack() as stack:
                if on:
                    trace.enable()
                    stack.callback(trace.disable)
                    st = stack.enter_context(convergence.ConvergenceStream(
                        pathlib.Path(td) / f"c{i}.jsonl"))
                    solver.set_convergence_stream(st)
                    stack.callback(solver.set_convergence_stream, None)
                r = solver.fit(lam1=lam1, max_outer=TRACE_STEPS, tol=0.0)
            turns.append({"traced": on, "superstep_s": r.history["step_s"]})
    steps_of = {on: [x for t in turns if t["traced"] == on
                     for x in t["superstep_s"][1:]] for on in (False, True)}
    med = {on: float(np.median(v)) for on, v in steps_of.items()}
    parts = tracing_parts(torch, tdir)
    t0 = time.perf_counter()
    for _ in range(RECORD_LAUNCH_CALLS):
        ops.record_launch("glm_stats")
    record_us = (time.perf_counter() - t0) / RECORD_LAUNCH_CALLS * 1e6

    # the report over what the serve and trace phases wrote
    metrics.save_default(tdir)
    out_json = pathlib.Path(tdir) / "summary.json"
    with contextlib.redirect_stdout(sys.stderr):
        rc = trace_report.main([str(tdir), "--json", str(out_json)])
    check(rc == 0, f"trace_report exited {rc}")
    rep = json.loads(out_json.read_text())
    out_json.unlink()
    rep_counts = {r["span"]: r["count"] for r in rep["spans"]}
    check(all(rep_counts.get(k, 0) >= v for k, v in all_spans.items())
          and rep["convergence"]["n_events"] == len(
              convergence.read_events(conv_path)),
          f"trace_report: spans {rep_counts} for {all_spans}")
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "trace", "card": card, "phase_s": phase_s,
          "supersteps": TRACE_STEPS, "ckpt_every": TRACE_CKPT_EVERY,
          "traced_equals_untraced": True, "spans": all_spans,
          "stream_events": len(convergence.read_events(conv_path)),
          "span_us_vs_step_s": [
              {"span_us": e["step_us"], "step_s": s_}
              for e, s_ in zip(evs[:n_fit], traced.history["step_s"])],
          "profiled_superstep": {
              "span_us": prof_span_us, "step_s": pres.history["step_s"][0],
              "device_busy_ms": busy["busy_s"] * 1e3,
              "idle_share": busy["idle_share"],
              "k1_k4_records_launches_inside": held},
          "launches": {k: v for k, v in traced_counts.items() if v},
          "launch_trace": dict(by), "launch_counts_delta": {
              k: v for k, v in delta.items() if v},
          "path": {"lambdas": [float(x) for x in lambdas],
                   "n_iters": tpath.n_iters.tolist(),
                   "kkt_rounds": {str(k): v for k, v in rounds.items()},
                   "events": len(pev)},
          "overhead": {
              "turns": turns, "median_superstep_s_untraced": med[False],
              "median_superstep_s_traced": med[True],
              "traced_over_untraced": med[True] / med[False] - 1.0,
              "min_superstep_s_untraced": min(steps_of[False]),
              "min_superstep_s_traced": min(steps_of[True]),
              **parts,
              "record_launch_us_per_call": record_us,
              "record_launch_us_per_superstep": record_us * sum(by.values()),
              "logical_launches_per_superstep": sum(by.values())},
          "report": {"n_spans": rep["n_spans"], "top_spans": rep["spans"][:8],
                     "phase_attribution": rep["phase_attribution"],
                     "convergence": rep["convergence"],
                     "metrics_counters": (rep["metrics"] or {}).get(
                         "counters")}})


def multinomial_phase(np, torch, GLMSolver, DGLMNETConfig, ds, dev):
    """``MultinomialGLM`` on the sparse train split, 4 classes: labels the
    argmax of X B + 0.3 noise (B seeded, 50 nonzero rows a class, on
    frequent features, each class's margins scaled to std 2 as
    make_sparse plants its signal); lam1 0.05 of class 0's one-vs-rest
    logistic lambda_max on the session the estimator fits (standardized,
    with an intercept).  Each class visit is a full-width logistic fit
    through K1-K4.  The estimator's objective (the reference's) puts the
    penalty on the original-scale coefficients while each visit minimizes
    it on the standardized ones, so the objective held to never rise is
    the latter: the same loss with the penalty on coef / scale."""
    from repro_torch.glm import MultinomialGLM
    from repro_torch.kernels import ops

    X = ds.train.X
    n, p = X.shape
    rng = np.random.default_rng(SEED + 2)
    t0 = time.perf_counter()
    M = np.zeros((n, MN_CLASSES))
    for k in range(MN_CLASSES):
        b = np.zeros(p)
        b[rng.choice(min(p, 4000), MN_SUPPORT, replace=False)] = \
            rng.normal(size=MN_SUPPORT)
        m = np.bincount(X.rows, weights=X.vals * b[X.cols], minlength=n)
        M[:, k] = m / max(m.std(), 1e-6) * 2.0
    yk = np.argmax(M + 0.3 * rng.normal(size=M.shape), axis=1)
    labels_s = time.perf_counter() - t0
    del M
    majority = max(float(np.mean(yk == k)) for k in range(MN_CLASSES))
    cfg = DGLMNETConfig(tile_size=256, max_outer=50, tol=1e-6)
    t0 = time.perf_counter()
    s0 = GLMSolver(X, np.where(yk == 0, 1.0, -1.0), family="logistic",
                   config=cfg, fit_intercept=True, standardize=True,
                   device=dev)
    lam1 = 0.05 * s0.lambda_max()
    lmax_s = time.perf_counter() - t0
    del s0
    torch.cuda.empty_cache()

    est = MultinomialGLM(lam1=lam1, tile_size=256, standardize=True,
                         max_cycles=MN_CYCLES, max_outer=50, tol=1e-6,
                         device=dev)
    objs, std_objs, visits = [], [], []
    objective = est._objective

    def recorded(*a):
        """The estimator's objective, and beside it the standardized one."""
        f = objective(*a)
        scale = est.solver_._info.unpack_beta(
            est.solver_._scale_packed)[:est.coef_.shape[0]]
        objs.append(f)
        std_objs.append(f + lam1 * float(
            np.abs(est.coef_ / scale[:, None]).sum()
            - np.abs(est.coef_).sum()))
        return f

    est._objective = recorded
    fit = GLMSolver.fit

    def visit(self, *a, **k):
        t = time.perf_counter()
        r = fit(self, *a, **k)
        visits.append((r.n_iter, time.perf_counter() - t))
        return r

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    GLMSolver.fit = visit
    try:
        t0 = time.perf_counter()
        est.fit(X, yk)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        GLMSolver.fit = fit
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    S = est.solver_.launch_stats["supersteps"]
    nt = est.solver_.design.n_tiles
    check(S == sum(v[0] for v in visits)
          and len(visits) == MN_CLASSES * est.n_cycles_,
          f"multinomial: {S} supersteps, visits {visits}")
    want = {"glm_stats": S, "cd_tile_solve": nt * S, "tile_gram": nt * S,
            "alpha_search": 2 * S}
    check(counts == {k: want.get(k, 0) for k in counts},
          f"multinomial: launches {counts} != {want}")
    check(all(np.isfinite(std_objs)) and all(
        b <= a + 1e-6 * abs(a) for a, b in zip(std_objs, std_objs[1:])),
          f"multinomial: the objective rose {std_objs}")
    ops.reset_launch_counts()
    proba = est.predict_proba(X)
    pred_counts = ops.launch_counts()
    check(pred_counts["predict_tile"] > 0 and sum(pred_counts.values())
          == pred_counts["predict_tile"],
          f"multinomial: predict launches {pred_counts}")
    row_err = float(np.abs(proba.sum(axis=1) - 1.0).max())
    acc = float(np.mean(est.classes_[np.argmax(proba, axis=1)] == yk))
    check(proba.shape == (n, MN_CLASSES) and row_err <= 1e-5,
          f"multinomial: predict_proba rows off 1 by {row_err}")
    check(acc >= majority + 0.1,
          f"multinomial: training accuracy {acc}, majority {majority}")
    K = MN_CLASSES
    cycle_s = [sum(v[1] for v in visits[c * K:(c + 1) * K])
               for c in range(est.n_cycles_)]
    emit({"phase": "multinomial", "classes": K, "n": n, "p": p,
          "support_per_class": MN_SUPPORT, "labels_s": labels_s,
          "lam1": lam1, "lambda_max_s": lmax_s, "n_cycles": est.n_cycles_,
          "objective_per_cycle": objs,
          "standardized_objective_per_cycle": std_objs, "fit_s": fit_s,
          "cycle_s": cycle_s, "supersteps_per_visit": [v[0] for v in visits],
          "visit_s": [v[1] for v in visits], "supersteps": S,
          "superstep_ms_mean": 1e3 * sum(v[1] for v in visits) / S,
          "peak_mem_gb": peak, "launches": counts,
          "predict_launches": pred_counts, "train_accuracy": acc,
          "majority_share": majority, "proba_row_sum_err": row_err,
          "nnz_per_class": (est.coef_ != 0).sum(axis=0).tolist()})
    del est
    torch.cuda.empty_cache()
    return counts


def estimator_phase(np, torch, GLMSolver, DGLMNETConfig, synthetic, ds, dev,
                    lam1):
    """``LogisticRegressionCD`` on the sparse data ({0, 1} labels, the
    sparse fit's lam1, unstandardized like that fit): saved in fp32 and
    int8 and loaded; the loaded model's test-split predictions (SparseCOO,
    K7) against the fitted estimator's, int8 margins within the manifest's
    bound; ``serve_glm.main`` over the artifact; then a family registered
    under a new name with the squared formulas, fitted on the card (it
    must take the plain route) and held against the squared fit on the
    CPU."""
    import contextlib
    import io

    from repro_torch.core import glm
    from repro_torch.glm import LogisticRegressionCD
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_glm
    from repro_torch.serve import artifact_bytes, load_artifact

    y01 = (ds.train.y > 0).astype(np.int64)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    est = LogisticRegressionCD(lam1=lam1, tile_size=256, standardize=False,
                               max_outer=50, tol=1e-6, device=dev)
    est.fit(ds.train.X, y01)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = ops.launch_counts()
    S = est.solver_.launch_stats["supersteps"]
    nt = est.solver_.design.n_tiles
    want = {"glm_stats": S, "cd_tile_solve": nt * S, "tile_gram": nt * S,
            "alpha_search": 2 * S}
    check(fit_counts == {k: want.get(k, 0) for k in fit_counts},
          f"estimator: fit launches {fit_counts} != {want}")
    Xte = ds.test.X
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        est.save(tmp / "fp32")
        est.save(tmp / "int8", quantize="int8")
        save_s = time.perf_counter() - t0
        sizes = {q: artifact_bytes(tmp / q) for q in ("fp32", "int8")}
        ops.reset_launch_counts()
        loaded = LogisticRegressionCD.load(tmp / "fp32")
        quant = LogisticRegressionCD.load(tmp / "int8")
        m_fit = est.decision_function(Xte)
        m_load = loaded.decision_function(Xte)
        m_q = quant.decision_function(Xte)
        same_pred = bool(np.array_equal(est.predict(Xte),
                                        loaded.predict(Xte)))
        pred_counts = ops.launch_counts()
        per_l1 = load_artifact(tmp / "int8").quant["bound_per_l1"]
        row_l1 = np.bincount(Xte.rows, weights=np.abs(Xte.vals),
                             minlength=Xte.shape[0])
        q_over = float(np.max(np.abs(m_q - m_fit) - per_l1 * row_l1))
        e_load = float(np.abs(m_load - m_fit).max())
        check(same_pred and e_load <= 1e-6,
              f"estimator: loaded predictions differ ({e_load})")
        check(q_over <= 1e-5, f"estimator: int8 margins past their bound "
                              f"by {q_over}")
        check(pred_counts["predict_tile"] > 0 and sum(pred_counts.values())
              == pred_counts["predict_tile"],
              f"estimator: predict launches {pred_counts}")
        ops.reset_launch_counts()
        rec_path = tmp / "serve_glm.json"
        with contextlib.redirect_stdout(io.StringIO()):
            rc = serve_glm.main(["--artifact", str(tmp / "fp32"),
                                 "--requests", "2000",
                                 "--json", str(rec_path)])
        serve_counts = ops.launch_counts()
        rec = json.loads(rec_path.read_text())
    check(rc == 0 and all(rec.get(k) is not None
                          for k in ("p50_ms", "p99_ms", "rows_per_s"))
          and rec["n_requests"] == 2000
          and rec["compiled_shapes"] <= rec["shape_bucket_bound"],
          f"estimator: serve_glm rc {rc}, record {rec}")
    check(serve_counts["predict_tile"] > 0 and sum(serve_counts.values())
          == serve_counts["predict_tile"],
          f"estimator: serve_glm launches {serve_counts}")
    acc = float(np.mean(est.predict(Xte) == (ds.test.y > 0)))
    out.update(fit_s=fit_s, supersteps=S, fit_launches=fit_counts,
               save_s=save_s, artifact_bytes=sizes,
               loaded_margin_err=e_load, int8_past_bound=q_over,
               int8_bound_per_l1=per_l1, predict_launches=pred_counts,
               test_accuracy=acc, serve_glm=rec,
               serve_glm_launches=serve_counts)

    # a registered family: the plain route on the card, counted apart
    small = synthetic.make_dense(n=3000, p=300, k_true=20, seed=SEED + 1)
    name = "squared_registered"
    glm.register_family(glm.GLMFamily(name, glm.SQUARED.raw_stats,
                                      glm.SQUARED.predict, 1.0))
    registered = {}
    try:
        for coupling, cfg in (
                ("gauss-seidel", DGLMNETConfig(tile_size=256)),
                ("jacobi-fused", DGLMNETConfig(tile_size=256,
                                               coupling="jacobi"))):
            kw = dict(config=cfg, fit_intercept=True)
            cpu = GLMSolver(small.train.X, small.train.y, family="squared",
                            device="cpu", **kw)
            lam = 0.05 * cpu.lambda_max()
            rc_ = cpu.fit(lam1=lam, max_outer=8, tol=0.0)
            card = GLMSolver(small.train.X, small.train.y, family=name,
                             device=dev, **kw)
            ops.reset_launch_counts()
            rg = card.fit(lam1=lam, max_outer=8, tol=0.0)
            counts = ops.launch_counts()
            S = rg.n_iter
            want = ({"glm_stats/plain": S, "alpha_search/plain": 2 * S,
                     "cd_tile_solve": card.design.n_tiles * S}
                    if coupling == "gauss-seidel" else
                    {"stats_gram_solve/plain": S, "margin_ls/plain": S})
            # tol 0 stops a fit where f repeats to the last bit, which
            # sums in another order may reach a superstep apart: the f of
            # the supersteps both ran are compared
            k = min(rg.n_iter, rc_.n_iter)
            f_err = float(np.max(np.abs(np.array(rg.history["f"][:k])
                                        / np.array(rc_.history["f"][:k])
                                        - 1)))
            b_err = float(np.max(np.abs(rg.beta - rc_.beta)))
            registered[coupling] = {"f_rel_err": f_err, "beta_abs_err": b_err,
                                    "supersteps": S,
                                    "supersteps_cpu": rc_.n_iter,
                                    "launches": {k: v for k, v in
                                                 counts.items() if v}}
            check(counts == {k: want.get(k, 0) for k in counts},
                  f"registered family {coupling}: launches {counts} != "
                  f"{want}")
            check(f_err <= 1e-4 and b_err <= 1e-3,
                  f"registered family {coupling}: card vs CPU f {f_err} "
                  f"beta {b_err}")
    finally:
        del glm.FAMILIES[name]
    emit({"phase": "estimator", **out, "registered_family": registered,
          "tolerance": {"loaded_margin_abs": 1e-6, "f_rel": 1e-4,
                        "beta_abs": 1e-3}})
    del est, loaded, quant
    torch.cuda.empty_cache()
    return fit_counts, pred_counts, serve_counts


# stream: the dense train split as a host array streamed in chunks of
# STREAM_ROWS rows (49 chunks, the last ragged) with tiles of STREAM_TILE;
# the chunk-cursor checkpoint saves every STREAM_CKPT_CHUNKS chunks and the
# fit is cut at chunk STREAM_CUT_CHUNK + 1 of superstep STREAM_CUT_STEP
STREAM_ROWS, STREAM_TILE = 8192, 256
STREAM_CKPT_CHUNKS, STREAM_CUT_STEP, STREAM_CUT_CHUNK = 16, 3, 24
STREAM_PATH_LAMBDAS, STREAM_PATH_MAX_OUTER = 4, 8
# ingest: the first INGEST_ROWS rows of the sparse train split as libsvm
# text, fitted through the CLI (the whole split, 131,072 rows, ran past the
# phase's 90 s in a trial: parsing is host Python)
INGEST_ROWS = 65_536
INGEST_ARGS = ["--hash-dim", "4096", "--chunk-rows", "4096", "--tile",
               "256", "--steps", "3"]


class _Cut(Exception):
    """The chunk source's simulated crash."""


class CutSource:
    """A chunk source over a host array that raises when it is asked for
    chunk ``chunk + 1`` in the first pass of superstep ``step`` (pass 2 s
    - 1; it counts the passes by their chunk 0): a fit cut mid-pass, after
    the chunk ``chunk`` was made."""

    def __init__(self, X, rows: int, step: int, chunk: int):
        self.X, self.rows, self.passes = X, rows, 0
        self.cut_pass, self.cut_chunk = 2 * step - 1, chunk + 1

    def __call__(self, i):
        if i == 0:
            self.passes += 1
        if self.passes == self.cut_pass and i == self.cut_chunk:
            raise _Cut(f"chunk {i} of pass {self.passes}")
        return self.X[i * self.rows:(i + 1) * self.rows]


def device_idle(torch, prof, wall_s: float) -> dict:
    """The card's busy time in a profile as the union of its records'
    intervals (the copy stream overlaps the compute stream, so their sum
    would count that time twice), and the idle share of ``wall_s``."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("ProfilerStep"))
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy_s = busy * 1e-6
    return {"busy_s": busy_s, "wall_s": wall_s,
            "idle_share": 1.0 - busy_s / wall_s, "device_records": len(spans)}


def profiled_superstep(torch, solver, lam1) -> dict:
    """One superstep of ``solver`` under torch.profiler (the host idles
    PROFILE_EDGE_S at both edges of the window, outside the timed fit):
    the card's busy time and idle share over the fit's host seconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_EDGE_S)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.fit(lam1=lam1, max_outer=1, tol=0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_EDGE_S)
    return device_idle(torch, prof, wall)


def stream_phases(torch, solver, lam1, prefetch: bool):
    """One streaming superstep from the solver's fitted state, the card
    synchronized after each of its three parts: (host seconds of the
    statistics pass, the sweep and the line-search pass, the new beta)."""
    sd, fns = solver.design, solver._superstep
    state = solver._state
    p = sd.p_pad
    sd.prefetch = prefetch
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = (torch.zeros((p, p), device=sd.device),
               torch.zeros(p, device=sd.device),
               torch.zeros((), device=sd.device))
        for _, Xc, yc, wc, oc in solver._iter_row_chunks():
            acc = fns.stats_chunk(Xc, yc, wc, oc, state.beta, acc)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prep = fns.prepare(acc, state.beta, state.mu, (lam1, 0.0),
                           solver._penf, state.cursor)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        losses = torch.zeros(fns.n_candidates, device=sd.device)
        for _, Xc, yc, wc, oc in solver._iter_row_chunks():
            losses = fns.ls_chunk(Xc, yc, wc, oc, state.beta, prep["dbeta"],
                                  losses)
        new, _ = fns.finish(losses, prep, state, (lam1, 0.0), solver._penf)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        sd.prefetch = True
    return ({"stats_s": t1 - t0, "sweep_s": t2 - t1, "line_search_s": t3 - t2,
             "superstep_s": t3 - t0}, new.beta)


def stream_kernel_report(np, torch, solver, floors, floor_lib, parity):
    """K1 and K4 (over the 294 candidates of ``full_candidates``) at the
    chunk shapes of the streaming passes (n = STREAM_ROWS and the ingest
    phase's 4,096), against their plain versions, timed beside their
    launch floor and bound as at the fit's shapes; K2 on a diagonal block
    of the streaming solver's Gram (the Gauss-Seidel sweep's input)."""
    from repro_torch.core import linesearch
    from repro_torch.kernels import alpha_search as alpha_search_k
    from repro_torch.kernels import cd_tile_solve as cd_tile_solve_k
    from repro_torch.kernels import glm_stats as glm_stats_k
    from repro_torch.kernels import ops, ref

    dev = solver.device
    rng = np.random.default_rng(SEED + 7)
    cand = linesearch.full_candidates(1e-3, 13, 0.5, 20, device=dev)
    K = int(cand.shape[0])
    vec = lambda v: torch.from_numpy(v.astype(np.float32)).to(dev)
    k1, k4 = [], []
    for n in (STREAM_ROWS, 4096):
        y = vec(rng.choice([-1.0, 1.0], n))
        w, o = vec(rng.random(n)), vec(0.1 * rng.normal(size=n))
        xb, xdb = vec(1.5 * rng.normal(size=n)), vec(rng.normal(size=n))
        got = ops.glm_stats(y, xb, "logistic", weights=w, offset=o)
        want = ref.glm_stats(y, xb, w, "logistic", offset=o)
        e1 = max(errs(a, b)[1] for a, b in zip(got, want))
        parity[f"glm_stats/n={n}/stream"] = e1
        check(e1 <= 1e-5, f"glm_stats n={n}: error {e1}")
        got = ops.alpha_search(y, xb, xdb, cand, "logistic", weights=w,
                               offset=o)
        e4 = errs(got, ref.alpha_search(y, xb, xdb, w, cand, "logistic",
                                        offset=o))[1]
        parity[f"alpha_search/n={n}/K={K}/stream"] = e4
        check(e4 <= 1e-5, f"alpha_search n={n} K={K}: error {e4}")
        ms = time_ms(torch, lambda: glm_stats_k.launch(
            y, xb, w, "logistic", offset=o), 200)
        floor = launch_floor(torch, floor_lib,
                             [(glm_stats_k.grid(n), 1, glm_stats_k.THREADS)],
                             200)
        b_ms, b_by, _, _ = timed_bound(n * 4.0 * 7, n,
                                       floors["logistic"]["stats_ns"])
        k1.append(dict(n=n, ms=ms, plain_ms=time_ms(torch, lambda: ref.
                                                    glm_stats(y, xb, w,
                                                              "logistic",
                                                              offset=o), 50),
                       bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
                       launch_floor_ms=floor, max_rel_err=e1))
        ms = time_ms(torch, lambda: alpha_search_k.launch(
            y, xb, xdb, w, cand, "logistic", offset=o), 200)
        nb, threads = alpha_search_k.grid(n, K)
        floor = launch_floor(torch, floor_lib, [(nb, 1, threads)], 200)
        b_ms, b_by, _, _ = timed_bound(n * 4.0 * 5 + 8.0 * K, n * K,
                                       floors["logistic"]["loss_ns"])
        k4.append(dict(n=n, K=K, ms=ms, plain_ms=time_ms(
            torch, lambda: ref.alpha_search(y, xb, xdb, w, cand, "logistic",
                                            offset=o), 20),
            bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
            launch_floor_ms=floor, max_rel_err=e4))
    # K2 on the Gram of the solver's last superstep state: its first tile
    T = solver.config.tile_size
    p = solver.design.p_pad
    acc = (torch.zeros((p, p), device=dev), torch.zeros(p, device=dev),
           torch.zeros((), device=dev))
    beta = solver._state.beta
    for i, Xc, yc, wc, oc in solver._iter_row_chunks():
        acc = solver._superstep.stats_chunk(Xc, yc, wc, oc, beta, acc)
        if i == 3:
            break
    G = acc[0][:T, :T].contiguous()
    g = acc[1][:T].contiguous()
    params = ops.solve_params(1.0, 1e-6, 0.05 * float(g.abs().max()), 0.0, g)
    zeros = torch.zeros(T, device=dev)
    got = ops.cd_tile_solve(G, g, torch.diagonal(G), beta[:T], zeros, params)
    want = ref.cd_tile_solve(G, g, torch.diagonal(G), beta[:T], zeros,
                             *params.unbind())
    check(torch.equal(got, want), "cd_tile_solve on the stream Gram: not "
          "bit-exact")
    k2_ms = time_ms(torch, lambda: cd_tile_solve_k.launch(
        G, g, torch.diagonal(G), beta[:T], zeros, params, None), 200)
    return {"glm_stats": k1, "alpha_search": k4,
            "cd_tile_solve": dict(T=T, ms=k2_ms, bound_ms=k2_bound(T)[0],
                                  bit_exact=True)}


def stream_phase(np, torch, GLMSolver, DGLMNETConfig, dd, dev, gs_ref,
                 jacobi_ref, lmax, floors, floor_lib, parity, card, tdir):
    """The out-of-core mode at full width: the dense train split stays a
    host array and streams through ``streaming_design`` in chunks of
    STREAM_ROWS rows.  Its Gauss-Seidel fit against the in-memory fit of
    the same superstep count (``gs_ref`` = (lam1, result)), its Jacobi fit
    against the unfused in-memory Jacobi fit (``jacobi_ref``): the same
    alpha at every superstep, f within 1e-5 relative, beta within 1e-3;
    K1 and K4 once a chunk, K2 once a swept tile or once a Jacobi
    superstep.  Prefetch off against on: every chunk, and a superstep
    from the same state, bit for bit; each timed by part.  A chunk-cursor
    resume, a short screened path with the KKT test held, the copy rate,
    the idle share of one profiled superstep and the kernels at the chunk
    shapes.  One more superstep runs traced into ``tdir``: its stream
    event's ``phase_us`` holds the three passes and sums to its
    ``step_us``; then ``trace_report`` summarizes the whole directory."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.design import streaming_design
    from repro_torch.kernels import ops
    from repro_torch.launch import trace_report
    from repro_torch.obs import convergence, trace

    t_phase = time.perf_counter()
    X, y = dd.train.X, dd.train.y
    n, p_src = X.shape

    def session(config=None, source=None):
        sd, _ = streaming_design(X if source is None else source,
                                 STREAM_TILE, chunk_rows=STREAM_ROWS,
                                 n_rows=n, n_cols=p_src, device=dev)
        return GLMSolver(sd, y, family="logistic", fit_intercept=True,
                         device=dev, config=config)

    def fit_counted(tag, s, lam1, steps, want_per_step, **kw):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = s.fit(lam1=lam1, max_outer=steps, tol=0.0, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = {k: res.n_iter * want_per_step.get(k, 0) for k in counts}
        check(counts == want, f"{tag}: launches {counts} != {want}")
        return res, counts, wall, torch.cuda.max_memory_allocated() / 1e9

    def against(tag, res, ref):
        f, fr = np.asarray(res.history["f"]), np.asarray(ref.history["f"])
        f_err = float(np.max(np.abs(f / fr - 1))) if len(f) == len(fr) \
            else np.inf
        b_err = float(np.max(np.abs(res.beta - ref.beta)))
        check(res.n_iter == ref.n_iter
              and res.history["alpha"] == ref.history["alpha"]
              and f_err <= 1e-5 and b_err <= 1e-3,
              f"{tag}: against the in-memory fit: n_iter {res.n_iter} / "
              f"{ref.n_iter}, alpha {res.history['alpha']} / "
              f"{ref.history['alpha']}, f {f_err}, beta {b_err}")
        return {"f_rel_err": f_err, "beta_abs_err": b_err,
                "alpha": res.history["alpha"]}

    t0 = time.perf_counter()
    s = session()
    setup_s = time.perf_counter() - t0
    sd = s.design
    nc, nt = sd.n_chunks, sd.n_tiles
    last = sd.n_rows_data - (nc - 1) * STREAM_ROWS
    check((nc, sd.p_pad, nt, last) == (49, 2048, 8, 6784),
          f"stream: layout {(nc, sd.p_pad, nt, last)}")
    lam1, gs_res = gs_ref
    steps = gs_res.n_iter
    res, gs_counts, gs_wall, peak = fit_counted(
        "stream", s, lam1, steps,
        {"glm_stats": nc, "alpha_search": nc, "cd_tile_solve": nt})
    gs_vs = against("stream", res, gs_res)

    # prefetch on against off: the chunks, then a superstep from the same
    # state, timed by part (on, off, on)
    same_chunks = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        sd.iter_chunks(prefetch=True), sd.iter_chunks(prefetch=False)))
    check(same_chunks, "stream: double-buffered chunks differ from serial")
    timing, betas = [], []
    for prefetch in (True, False, True):
        parts, beta = stream_phases(torch, s, lam1, prefetch)
        timing.append(dict(prefetch=prefetch, **parts))
        betas.append(beta)
    check(all(torch.equal(b, betas[0]) for b in betas),
          "stream: a superstep with prefetch off differs from on")
    del betas

    # one superstep traced: the pass spans and the stream's phase split
    tr = trace.enable(tdir)
    conv_path = pathlib.Path(tdir) / f"convergence_{tr.pid}.jsonl"
    with convergence.ConvergenceStream(conv_path) as cs:
        s.set_convergence_stream(cs)
        s.fit(lam1=lam1, max_outer=1, tol=0.0)
        s.set_convergence_stream(None)
    ev = convergence.read_events(conv_path)[-1]
    tspans = span_counts(save_shard(tdir, "stream"))
    parts = ev["phase_us"] or {}
    check(set(parts) == {"stats", "sweep", "line_search"}
          and abs(sum(parts.values()) - ev["step_us"]) <= 1e-6 * ev["step_us"]
          and tspans == {"solver/stream_stats": 1, "solver/stream_sweep": 1,
                         "solver/stream_line_search": 1},
          f"stream traced: event {ev}, spans {tspans}")
    summary = trace_report.summarize(tdir)
    traced_step = {"phase_us": parts, "step_us": ev["step_us"],
                   "spans": tspans,
                   "report_phase_attribution": summary["phase_attribution"],
                   "report_spans": summary["spans"][:8]}
    idle = profiled_superstep(torch, s, lam1)
    kernels = stream_kernel_report(np, torch, s, floors, floor_lib, parity)

    # the host-to-device copy of one chunk from pinned memory, and the
    # bytes a superstep copies (two passes); the chunk Gram's float32 work
    pinned = torch.zeros((STREAM_ROWS, sd.p_pad), pin_memory=True)
    dst = torch.empty((STREAM_ROWS, sd.p_pad), device=dev)
    copy_ms = time_ms(torch, lambda: dst.copy_(pinned, non_blocking=True),
                      20)
    chunk_bytes = STREAM_ROWS * sd.p_pad * 4
    # the host's part of a chunk: its rows written into a pinned buffer
    t0 = time.perf_counter()
    for i in range(8):
        sd._fill(pinned, i)
    fill_ms = (time.perf_counter() - t0) / 8 * 1e3
    del pinned, dst
    bytes_step = 2 * nc * chunk_bytes
    gram_flops = nc * 2.0 * STREAM_ROWS * sd.p_pad ** 2

    # the Jacobi fit against the unfused in-memory one
    lam1_j, j_res = jacobi_ref
    sj = session(DGLMNETConfig(coupling="jacobi"))
    jres, j_counts, j_wall, _ = fit_counted(
        "stream_jacobi", sj, lam1_j, j_res.n_iter,
        {"glm_stats": nc, "alpha_search": nc, "cd_tile_solve": 1})
    j_vs = against("stream_jacobi", jres, j_res)
    del sj

    # chunk-cursor resume: two fits run through, then one cut mid-pass
    # (saves every STREAM_CKPT_CHUNKS chunks) and resumed in a fresh session
    ck_steps = STREAM_CUT_STEP + 1
    through = [session().fit(lam1=lam1, max_outer=ck_steps, tol=0.0)
               for _ in range(2)]
    same_bits = np.array_equal(through[0].beta, through[1].beta) and \
        through[0].history["f"] == through[1].history["f"]
    with tempfile.TemporaryDirectory(prefix="stream-ckpt-") as td:
        mgr = CheckpointManager(td)
        save_ms = []
        orig = mgr.save

        def timed_save(step, tree, **kw):
            t = time.perf_counter()
            orig(step, tree, **kw)
            save_ms.append((time.perf_counter() - t) * 1e3)

        mgr.save = timed_save
        cut = session(source=CutSource(X, STREAM_ROWS, STREAM_CUT_STEP,
                                       STREAM_CUT_CHUNK))
        try:
            cut.fit(lam1=lam1, max_outer=ck_steps, tol=0.0, ckpt_manager=mgr,
                    ckpt_every_chunks=STREAM_CKPT_CHUNKS)
            fail("stream: the cut fit ran through")
        except _Cut:
            pass
        del cut
        md = mgr.read_metadata()
        saved = STREAM_CUT_CHUNK // STREAM_CKPT_CHUNKS * STREAM_CKPT_CHUNKS
        check(md.get("stream_chunk") == saved
              and md.get("next_it") == STREAM_CUT_STEP,
              f"stream: the last save before the cut is {md}")
        ck_dir = pathlib.Path(td) / f"ckpt_{mgr.latest_step()}"
        ck_bytes = sum(f.stat().st_size for f in ck_dir.iterdir())
        p = sd.p_pad
        like = {"beta": torch.zeros(p, device=dev),
                "mu": torch.zeros((), device=dev),
                "G": torch.zeros((p, p), device=dev),
                "g0": torch.zeros(p, device=dev),
                "L": torch.zeros((), device=dev)}
        restore_ms = host_ms(torch, lambda: CheckpointManager(td).restore(
            like), 1)
        del like
        resumed = session().fit(lam1=lam1, max_outer=ck_steps, tol=0.0,
                                ckpt_manager=CheckpointManager(td),
                                ckpt_every_chunks=STREAM_CKPT_CHUNKS)
    want = through[0]
    k = STREAM_CUT_STEP - 1
    gap = float(np.max(np.abs(resumed.beta - want.beta)))
    if same_bits:
        check(np.array_equal(resumed.beta, want.beta)
              and resumed.history["f"] == want.history["f"][k:]
              and resumed.history["alpha"] == want.history["alpha"][k:],
              f"stream resume: not the fit run through (beta gap {gap})")
    else:
        check(gap <= 1e-6 and resumed.history["alpha"]
              == want.history["alpha"][k:],
              f"stream resume: beta gap {gap}")
    del through, resumed

    # a short screened path below the in-memory lambda_max: gradient
    # checks by chunk pass, the KKT test held after each lambda
    sp = session()
    lambdas = lmax * np.geomspace(0.5, LAM1_FRACTION * 2,
                                  STREAM_PATH_LAMBDAS)
    events = path_probe(torch, sp)
    sp.launch_stats.update(dict.fromkeys(sp.launch_stats, 0))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    path = sp.fit_path(lambdas, max_outer=STREAM_PATH_MAX_OUTER,
                       tol=PATH_TOL)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts, st = ops.launch_counts(), dict(sp.launch_stats)
    release(sp)
    n_grad = sum("grad" in ev for ev in events)
    kkt = kkt_rounds(np, events, sp._penf_host, STREAM_TILE)
    bad = {lam: v for lam, v in kkt.items() if v[2]}
    check(np.isfinite(path.f).all() and len(kkt) == len(lambdas)
          and not bad, f"stream path: f {path.f}, KKT violated at {bad}")
    want_p = {"glm_stats": nc * (st["supersteps"] + n_grad),
              "alpha_search": nc * st["supersteps"],
              "cd_tile_solve": st["sweep_tile_launches"]}
    check(counts == {k: want_p.get(k, 0) for k in counts},
          f"stream path: launches {counts} != {want_p}")
    del sp

    emit({"phase": "stream", "card": card,
          "phase_s": time.perf_counter() - t_phase,
          "train_shape": [n, p_src], "chunk_rows": STREAM_ROWS,
          "n_chunks": nc, "last_chunk_rows": last, "p_pad": sd.p_pad,
          "n_tiles": nt, "session_setup_s": setup_s,
          "gauss_seidel": dict(gs_vs, supersteps=steps, fit_s=gs_wall,
                               superstep_s=res.history["step_s"],
                               launches=gs_counts, peak_mem_gb=peak),
          "jacobi": dict(j_vs, supersteps=jres.n_iter, fit_s=j_wall,
                         superstep_s=jres.history["step_s"],
                         launches=j_counts),
          "prefetch_same_bits": True, "superstep_parts": timing,
          "bytes_copied_per_superstep": bytes_step,
          "chunk_copy_ms": copy_ms, "host_fill_ms_per_chunk": fill_ms,
          "host_fill_s_per_superstep": 2 * nc * fill_ms / 1e3,
          "host_threads": torch.get_num_threads(),
          "pinned_copy_gb_per_s": chunk_bytes / copy_ms / 1e6,
          "copy_bound_s_per_superstep": bytes_step / chunk_bytes * copy_ms
          / 1e3,
          "gram_flops_per_superstep": gram_flops,
          "gram_fp32_bound_s": gram_flops / H100_FP32_FLOPS,
          "profiled_superstep": idle,
          "checkpoint": {"two_runs_same_bits": same_bits,
                         "stream_chunk": md["stream_chunk"],
                         "next_it": md["next_it"], "bytes": ck_bytes,
                         "save_ms": save_ms, "restore_ms": restore_ms,
                         "resumed_beta_gap": gap},
          "path": {"lambdas": lambdas.tolist(), "f": path.f.tolist(),
                   "nnz": path.nnz.tolist(),
                   "n_iters": path.n_iters.tolist(), "wall_s": path_s,
                   "n_grad": n_grad, "stats": st, "launches": counts,
                   "kkt_rounds": {str(lam): v[0] for lam, v in kkt.items()}},
          "kernels_at_chunk_shapes": kernels, "traced": traced_step})
    return {"counts": gs_counts, "jacobi_counts": j_counts,
            "kernels": kernels}


def ingest_phase(np, torch, coo, y, dev, card):
    """The file path at the sparse fit's width: the first INGEST_ROWS rows
    of its train split written once as plain libsvm text, then
    ``repro_torch.launch.ingest_train.main`` in process (hashed into 4,096
    columns, chunks of 4,096 rows, 3 supersteps on the card), then its
    ``--smoke``.  Parsing is host Python: this phase measures the host."""
    from repro_torch import io as io_lib
    from repro_torch.core.solver import GLMSolver
    from repro_torch.kernels import ops
    from repro_torch.launch import ingest_train

    t_phase = time.perf_counter()
    n = min(INGEST_ROWS, coo.shape[0])
    coo, y = coo.take_rows(np.arange(n)), y[:n]
    with tempfile.TemporaryDirectory(prefix="ingest-") as td:
        path = pathlib.Path(td) / "train.libsvm"
        t0 = time.perf_counter()
        io_lib.write_libsvm(path, coo, y)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reader = io_lib.LibsvmReader(path, chunk_rows=4096)
        scan_s = time.perf_counter() - t0
        probe = min(8, reader.n_chunks)    # chunks parsed and hashed alone
        t0 = time.perf_counter()
        for i in range(probe):
            reader.chunk(i)
        parse_s = time.perf_counter() - t0
        hasher = io_lib.FeatureHasher(4096, tile_size=256)
        fn = reader.hashed_chunk_fn(hasher)
        t0 = time.perf_counter()
        for i in range(probe):
            fn(i)
        hashed_s = time.perf_counter() - t0
        probe_rows = min(probe * 4096, n)
        rec_path = pathlib.Path(td) / "record.json"
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc = ingest_train.main(["--data", str(path), *INGEST_ARGS,
                                "--json", str(rec_path)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        check(rc == 0, f"ingest: ingest_train exited {rc}")
        rec = json.loads(rec_path.read_text())
        f = np.asarray(rec["f_history"])
        check(np.isfinite(f).all() and bool(np.all(np.diff(f) <= 1e-6
                                                   * np.abs(f[:-1]))),
              f"ingest: f {f.tolist()}")
        nc = rec["chunks"]
        tiles = -(-(rec["design_cols"] + 1) // 256)     # the intercept too
        want = {"glm_stats": nc * rec["n_iter"],
                "alpha_search": nc * rec["n_iter"],
                "cd_tile_solve": rec["n_iter"] * tiles}
        check(counts == {k: want.get(k, 0) for k in counts},
              f"ingest: launches {counts} != {want}")
        # one superstep of the same design, profiled
        design, labels, _ = io_lib.open_design(
            str(path), tile_size=256, chunk_rows=4096, hasher=hasher,
            prefetch_chunks=2, device=dev)
        s = GLMSolver(design, labels, family="logistic", fit_intercept=True,
                      device=dev)
        idle = profiled_superstep(torch, s, 0.01)
        del s, design
        smoke_path = pathlib.Path(td) / "smoke.json"
        rc = ingest_train.main(["--smoke", "--json", str(smoke_path)])
        smoke = json.loads(smoke_path.read_text())
        check(rc == 0 and smoke["beta_max_err"] <= 1e-5
              and smoke["device"].startswith("cuda"),
              f"ingest --smoke: rc {rc}, record {smoke}")
        file_bytes = path.stat().st_size
    emit({"phase": "ingest", "card": card,
          "phase_s": time.perf_counter() - t_phase, "rows": n,
          "features": coo.shape[1], "nnz": int(coo.nnz),
          "file_bytes": file_bytes, "write_s": write_s,
          "write_rows_per_s": n / write_s, "scan_s": scan_s,
          "scan_rows_per_s": n / scan_s,
          "parse_rows_per_s": probe_rows / parse_s,
          "parse_and_hash_rows_per_s": probe_rows / hashed_s,
          "cli_s": cli_s, "record": rec, "launches": counts,
          "profiled_superstep": idle, "smoke": smoke})
    return counts


# ---------------------------------------------------------------------------
# dist: the mesh on torch.distributed (this script is also the worker)
# ---------------------------------------------------------------------------

def small_problem(np, kind: str, n: int = 600, p: int = 300):
    """A small logistic problem whose rows and features pad on a (2, 2)
    mesh; ``kind="block"`` is sparse (a SparseCOO is built from it)."""
    rng = np.random.default_rng(SEED + 3)
    X = rng.normal(size=(n, p)).astype(np.float32)
    if kind == "block":
        X = np.where(rng.random((n, p)) < 0.1, X, 0.0).astype(np.float32)
    beta = np.zeros((p,), np.float32)
    beta[: p // 6] = rng.normal(size=p // 6).astype(np.float32)
    y = np.where(X @ beta + 0.5 * rng.normal(size=n) > 0, 1.0,
                 -1.0).astype(np.float32)
    return X, y


def dist_task(np, torch, task: dict, mesh, dev) -> dict:
    """One task of a dist worker on its mesh; returns its JSON record."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.core.solver import GLMSolver
    from repro_torch.data import sparse, synthetic
    from repro_torch.kernels import ops
    from repro_torch.sharding import collectives

    def sync():
        if torch.cuda.is_available():     # the CPU worlds of (c) too
            torch.cuda.synchronize()

    kind = task["kind"]
    if kind == "full":
        t0 = time.perf_counter()
        ds = full_size_data(synthetic, "sparse") if "size" not in task \
            else synthetic.make_sparse(**task["size"])
        solver = full_size_solver(GLMSolver, ds, dev, mesh=mesh)
        sync()
        setup_s = time.perf_counter() - t0
        out = {"setup_s": setup_s, "n_tiles_local": solver.design.n_tiles,
               "local_shape": list(solver.design.shape)}
        for name, steps, tol in task["fits"]:
            ops.reset_launch_counts()
            collectives.reset_stats()
            t0 = time.perf_counter()
            res = solver.fit(lam1=task["lam1"], max_outer=steps, tol=tol)
            sync()
            fit_s = time.perf_counter() - t0
            st = collectives.stats()
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            out[name] = {
                "n_iter": res.n_iter, "converged": res.converged,
                "f": res.history["f"], "alpha": res.history["alpha"],
                "nnz": res.history["nnz"], "step_s": res.history["step_s"],
                "fit_s": fit_s, "collective_s": st["seconds"],
                "collective_calls": st["calls"],
                "collective_mb": st["bytes"] / 1e6, "launches": counts,
                "budget_tiles": solver.design.n_tiles * res.n_iter}
            if task.get("beta"):
                np.save(pathlib.Path(task["out"]) / f"{name}_beta.npy",
                        res.beta)
        return out
    if kind == "small":
        out = {}
        for design in ("dense", "block"):
            X, y = small_problem(np, design)
            Xin = X
            if design == "block":
                r, c = np.nonzero(X)
                Xin = sparse.SparseCOO(r.astype(np.int32), c.astype(np.int32),
                                       X[r, c], X.shape)
            for coup in ("gauss-seidel", "jacobi"):
                s = GLMSolver(Xin, y, config=DGLMNETConfig(
                    tile_size=64, coupling=coup), mesh=mesh, row_block=64,
                    device=dev)
                res = s.fit(lam1=0.01, max_outer=DIST_SMALL_STEPS, tol=0.0)
                out[f"{design}/{coup}"] = {
                    "alpha": res.history["alpha"], "n_iter": res.n_iter,
                    "f": res.history["f"],
                    "beta": s._host_beta(s._state.beta).tolist()}
        return out
    if kind == "ckpt":
        # a dense fit: uninterrupted, cut at 4 supersteps (saves at 2 and
        # 4), or resumed from the cut; an elastic source saved after 12
        # supersteps and its uninterrupted run to convergence
        X, y = small_problem(np, "dense")
        cfg = DGLMNETConfig(tile_size=64, max_outer=12, tol=0.0)
        d = pathlib.Path(task["dir"])
        out = {}
        for name in task["fits"]:
            s = GLMSolver(X, y, config=cfg, mesh=mesh, device=dev)
            if name == "full":
                res = s.fit(lam1=0.01)
            elif name == "cut":
                res = s.fit(lam1=0.01, max_outer=4, ckpt_every=2,
                            ckpt_manager=CheckpointManager(d / "cut"))
            else:
                res = s.fit(lam1=0.01, ckpt_every=2,
                            ckpt_manager=CheckpointManager(d / "cut"))
            out[name] = {"n_iter": res.n_iter, "n_hist": len(
                res.history["f"]), "beta": s._host_beta(
                s._state.beta).tolist()}
        ds = synthetic.make_dense(n=4000, p=256, seed=11)
        ecfg = DGLMNETConfig(lam1=0.5, lam2=0.5, tile_size=64,
                             max_outer=12, tol=1e-13)
        if "elastic_src" in task:
            s = GLMSolver(ds.train.X, ds.train.y, config=ecfg, mesh=mesh,
                          device=dev)
            s.fit(ckpt_every=4, ckpt_manager=CheckpointManager(
                d / "elastic", keep_last=2))
            s = GLMSolver(ds.train.X, ds.train.y, config=ecfg, mesh=mesh,
                          device=dev)
            res = s.fit(max_outer=200)
            out["elastic_ref"] = {"f": res.history["f"][-1],
                                  "n_iter": res.n_iter}
        if "elastic" in task:
            from repro_torch.dist import bootstrap
            mesh21 = bootstrap.make_dist_mesh(2, 1)
            s = GLMSolver(ds.train.X, ds.train.y, config=ecfg, mesh=mesh21,
                          device=dev)
            res = s.fit(max_outer=200, ckpt_every=500,
                        ckpt_manager=CheckpointManager(d / "elastic",
                                                       keep_last=2))
            out["elastic"] = {"f": res.history["f"][-1],
                              "n_hist": len(res.history["f"]),
                              "n_iter": res.n_iter}
        return out
    raise ValueError(f"unknown dist task {kind!r}")


def dist_worker(spec_path: str) -> None:
    """One rank of a dist-phase world: the spec's tasks on its mesh, its
    record in ``<out>/rank<r>.json``."""
    sys.path.insert(0, str(REPO / "src"))
    import numpy as np
    import torch

    from repro_torch.dist import bootstrap, faults
    spec = json.loads(pathlib.Path(spec_path).read_text())
    ctx = bootstrap.initialize(backend=spec["backend"],
                               device=spec["device"], timeout_s=120)
    ready = time.time()
    mesh = bootstrap.make_dist_mesh(*spec["mesh"])
    dev = None if spec["device"] is None else spec["device"]
    rec = {"ready_at": ready, "backend": ctx.backend, "device": ctx.device}
    if ctx.device == "cpu":
        torch.set_num_threads(2)
    for task in spec["tasks"]:
        rec[task["name"]] = dist_task(np, torch, task, mesh, dev)
    out = pathlib.Path(spec["out"])
    (out / f"rank{ctx.process_id}.json").write_text(json.dumps(rec))
    faults.guarded_barrier("chip-smoke-dist-exit", timeout_s=120)
    bootstrap.shutdown()


def dist_world(tdir: pathlib.Path, tag: str, n: int, mesh, tasks,
               backend="gloo", device=None):
    """Run one world of the dist phase; (every rank's record, seconds from
    launch to the last rank's process group, the world's wall seconds)."""
    from repro_torch.dist import launcher
    out = tdir / tag
    out.mkdir(parents=True, exist_ok=True)
    spec = out / "spec.json"
    spec.write_text(json.dumps({"backend": backend, "device": device,
                                "mesh": list(mesh), "tasks": tasks,
                                "out": str(out)}))
    t0 = time.time()
    res = launcher.run_local(n, REPO / "chip_smoke.py",
                             args=["--dist-worker", str(spec)],
                             timeout_s=DIST_TIMEOUT_S, grace_s=10)
    check(res.ok, f"dist world {tag} failed:\n{res.summary(3000)}")
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(n)]
    return ranks, max(r["ready_at"] for r in ranks) - t0, res.seconds


def dist_run_cli(tdir: pathlib.Path, tag: str, n: int, args) -> dict:
    """``python -m repro_torch.launch.dist_run`` as a user runs it; the
    coordinator's record."""
    out = tdir / f"{tag}.json"
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dist_run", "--nprocs",
         str(n), "--timeout", str(DIST_TIMEOUT_S), "--out", str(out),
         *map(str, args)], capture_output=True, text=True,
        timeout=DIST_TIMEOUT_S + 60, cwd=str(REPO),
        env={**__import__("os").environ,
             "PYTHONPATH": str(REPO / "src")})
    check(r.returncode == 0 and out.exists(),
          f"dist_run {tag} failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    row = json.loads(out.read_text())
    row["cli_s"] = time.time() - t0
    return row


def same_ranks(np, ranks, task, keys=("f", "alpha", "nnz", "n_iter")):
    """Every rank reports the same values of each fit of ``task``."""
    for name, fit in ranks[0][task].items():
        if not isinstance(fit, dict):
            continue
        for r in ranks[1:]:
            for k in keys:
                if k in fit:
                    check(r[task][name][k] == fit[k],
                          f"ranks disagree on {task}/{name}/{k}")


def dist_phase(np, torch, sparse_res, lam1, dense_npy, lam1_dense, card,
               size=None):
    """The dist phase (module docstring): worlds (a)-(f); returns the
    per-rank K1-K4 launches of the sharded fits.  ``size`` (the
    make_sparse arguments) replaces the full-size sparse data in a
    rehearsal on the CPU."""
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-dist-")
    tdir = pathlib.Path(tmp.name)
    steps5 = sparse_res.n_iter

    def full(name, fits, beta=False):
        return {"name": name, "kind": "full", "lam1": lam1, "fits": fits,
                "beta": beta, "out": str(tdir),
                **({"size": size} if size else {})}

    # (a) NCCL, a world of one: the single-device fit's supersteps, then
    # to tol
    ra, start_a, wall_a = dist_world(
        tdir, "a_nccl_1x1", 1, (1, 1),
        [full("full", [["parity", steps5, 0.0], ["to_tol", 200, 1e-8]],
              beta=True)], backend=None)
    pa = ra[0]["full"]["parity"]
    beta_a = np.load(tdir / "parity_beta.npy")
    d_beta = float(np.max(np.abs(beta_a - sparse_res.beta)))
    check(pa["alpha"] == sparse_res.history["alpha"]
          and pa["n_iter"] == sparse_res.n_iter and d_beta <= 1e-6,
          f"(a) NCCL (1, 1) vs single device: alphas {pa['alpha']} vs "
          f"{sparse_res.history['alpha']}, beta {d_beta}")
    tol_a = ra[0]["full"]["to_tol"]
    check(tol_a["converged"], "(a) the (1, 1) fit did not reach tol")
    f_single = tol_a["f"][-1]
    nt_a = ra[0]["full"]["n_tiles_local"]

    def launches_hold(tag, rk, fit):
        c = rk["full"][fit]["launches"]
        it = rk["full"][fit]["n_iter"]
        tiles = rk["full"][fit]["budget_tiles"]
        want = {"glm_stats": it, "tile_gram": tiles, "cd_tile_solve": tiles,
                "alpha_search": 2 * it}
        check(c == want, f"{tag}: launches {c} != {want}")
        return c

    launches_hold("(a)", ra[0], "parity")
    report = {"phase": "dist", "card": card,
              "a_nccl_1x1": {
                  "alpha_equal": True, "n_iter": pa["n_iter"],
                  "beta_max_abs_diff": d_beta,
                  "beta_bits_equal": bool(np.array_equal(beta_a,
                                                          sparse_res.beta)),
                  "to_tol_n_iter": tol_a["n_iter"], "f_to_tol": f_single,
                  "superstep_s_median": float(np.median(
                      tol_a["step_s"][1:])),
                  "collective_share": tol_a["collective_s"]
                  / tol_a["fit_s"], "startup_s": start_a,
                  "world_s": wall_a, "setup_s": ra[0]["full"]["setup_s"]}}

    # (b) gloo worlds of 2 and 4 on the one card (+ (c)'s card side, and
    # (e)'s sources in the world of 2)
    per_rank = {}
    worlds = {}
    backends = [("gloo", "gloo")]
    if torch.cuda.device_count() >= 2:
        backends.append(("nccl", None))
    for bname, backend in backends:
        for n, mesh in ((2, (1, 2)), (4, (2, 2))):
            if bname == "nccl" and n > torch.cuda.device_count():
                continue
            tag = f"b_{bname}_{mesh[0]}x{mesh[1]}"
            tasks = [full("full", [["to_tol", 200, 1e-8]])]
            if bname == "gloo":
                tasks.append({"name": "small", "kind": "small"})
                if n == 2:
                    tasks.append({"name": "ckpt", "kind": "ckpt",
                                  "dir": str(tdir / "ckpt"),
                                  "fits": ["full", "cut"],
                                  "elastic_src": True})
            ranks, start, wall = dist_world(tdir, tag, n, mesh, tasks,
                                            backend=backend)
            same_ranks(np, ranks, "full")
            fit = ranks[0]["full"]["to_tol"]
            check(fit["converged"], f"{tag}: did not reach tol")
            f = fit["f"][-1]
            check(f <= f_single + 2e-3 * abs(f_single),
                  f"{tag}: f {f} vs the (1, 1) fit's {f_single}")
            counts = [launches_hold(f"{tag} rank {r}", rk, "to_tol")
                      for r, rk in enumerate(ranks)]
            per_rank[f"{mesh[0]}x{mesh[1]}_{bname}"] = counts
            worlds[tag] = ranks
            report[tag] = {
                "n_iter": fit["n_iter"], "f": f,
                "f_rel_to_1x1": (f - f_single) / abs(f_single),
                "superstep_s_median": float(np.median(fit["step_s"][1:])),
                "superstep_s": fit["step_s"], "fit_s": fit["fit_s"],
                "collective_s": [rk["full"]["to_tol"]["collective_s"]
                                 for rk in ranks],
                "collective_share": [rk["full"]["to_tol"]["collective_s"]
                                     / rk["full"]["to_tol"]["fit_s"]
                                     for rk in ranks],
                "collective_calls": fit["collective_calls"],
                "collective_mb": fit["collective_mb"],
                "launches_per_rank": counts,
                "n_tiles_local": ranks[0]["full"]["n_tiles_local"],
                "local_shape": ranks[0]["full"]["local_shape"],
                "setup_s": max(rk["full"]["setup_s"] for rk in ranks),
                "startup_s": start, "world_s": wall,
                "backend": ranks[0]["backend"],
                "gloo_on_one_card": bname == "gloo"}
    if len(backends) == 1:
        report["nccl_across_cards"] = (
            f"not run: {torch.cuda.device_count()} card(s), NCCL needs a "
            "card per rank")

    # (c) the small fits on the card against the same worlds on the CPU
    small = {}
    for n, mesh in ((2, (1, 2)), (4, (2, 2))):
        cpu, _, _ = dist_world(tdir, f"c_cpu_{mesh[0]}x{mesh[1]}", n, mesh,
                               [{"name": "small", "kind": "small"}],
                               device="cpu")
        gpu = worlds[f"b_gloo_{mesh[0]}x{mesh[1]}"]
        same_ranks(np, gpu, "small")
        same_ranks(np, cpu, "small")
        for key, ref in cpu[0]["small"].items():
            got = gpu[0]["small"][key]
            db = float(np.max(np.abs(np.asarray(got["beta"])
                                     - np.asarray(ref["beta"]))))
            check(got["alpha"] == ref["alpha"] and got["n_iter"]
                  == ref["n_iter"] and db <= 1e-5,
                  f"(c) {mesh} {key}: card vs CPU alphas {got['alpha']} "
                  f"{ref['alpha']}, beta {db}")
            small[f"{mesh[0]}x{mesh[1]}/{key}"] = db
    report["c_card_vs_cpu_beta_max_abs"] = small

    # (d) ALB under a fault plan, through dist_run
    d = dist_run_cli(tdir, "d_alb", 2, [
        "--demo", "--backend", "gloo", "--faults", "1:4.0", "--telemetry",
        "--tile-cost-s", "0.002", "--steps", "8"])
    hist = d["budget_history"]
    check(d["budgets_agree"] and hist[0] == hist[1] and hist[0][0]
          == hist[0][1] and hist[-1][1] < hist[-1][0],
          f"(d) budgets {hist} (agree {d['budgets_agree']})")
    report["d_alb"] = {k: d[k] for k in ("budget_history", "budgets_agree",
                                         "speeds", "f", "n_iter", "fit_s",
                                         "collective_s", "cli_s")}

    # (e) restart and elastic resume in a fresh world of 2
    re_, _, _ = dist_world(tdir, "e_restart", 2, (1, 2), [
        {"name": "ckpt", "kind": "ckpt", "dir": str(tdir / "ckpt"),
         "fits": ["resume"], "elastic": True}])
    src = worlds["b_gloo_1x2"][0]["ckpt"]
    got = re_[0]["ckpt"]
    bits = got["resume"]["beta"] == src["full"]["beta"]
    db = float(np.max(np.abs(np.asarray(got["resume"]["beta"])
                             - np.asarray(src["full"]["beta"]))))
    check(got["resume"]["n_hist"] == 8 and got["resume"]["n_iter"]
          == src["full"]["n_iter"] and db <= 1e-6,
          f"(e) restart: beta {db}, {got['resume']}")
    f_ref = src["elastic_ref"]["f"]
    check(got["elastic"]["f"] <= f_ref + 2e-3 * abs(f_ref),
          f"(e) elastic {got['elastic']} vs {f_ref}")
    report["e_checkpoint"] = {"restart_bits_equal": bool(bits),
                              "restart_beta_max_abs": db,
                              "elastic_f": got["elastic"]["f"],
                              "elastic_supersteps": got["elastic"]["n_hist"],
                              "uninterrupted_f": f_ref}

    # (f) the dense split streamed by 2 processes against 1
    X_path, y_path = dense_npy
    common = ["--data", X_path, "--labels", y_path, "--chunk-rows", "8192",
              "--tile", "256", "--steps", "2", "--lam1", str(lam1_dense),
              "--tol", "0"]
    one = dist_run_cli(tdir, "f_stream_1", 1, common)
    two = dist_run_cli(tdir, "f_stream_2", 2, [*common, "--backend",
                                                "gloo"])
    df = max(abs(a - b) / abs(b) for a, b in zip(two["f"], one["f"]))
    dbeta = float(np.max(np.abs(np.asarray(two["beta"])
                                - np.asarray(one["beta"]))))
    check(df <= 1e-6 and dbeta <= 1e-6 and two["supersteps"] == 2,
          f"(f) streamed 2 vs 1: f {df}, beta {dbeta}")
    report["f_stream"] = {"f_rel": df, "beta_max_abs": dbeta,
                          "chunks_local": [two["chunks_local"],
                                           one["chunks_local"]],
                          "superstep_s": [two["wall_s"] / 2,
                                          one["wall_s"] / 2],
                          "cli_s": [two["cli_s"], one["cli_s"]],
                          "collective_s": two["collective_s"]}
    report["phase_s"] = time.perf_counter() - t_phase
    emit(report)
    tmp.cleanup()
    return per_rank


def main() -> None:
    if "--dist-worker" in sys.argv:
        dist_worker(sys.argv[sys.argv.index("--dist-worker") + 1])
        return
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

    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.core.solver import GLMSolver
    from repro_torch.data import synthetic
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

    # the traced parts of the run (serve, trace, stream) write here
    trace_tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-trace-")
    tdir = pathlib.Path(trace_tmp.name)

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
    # tolerances on max |kernel - plain| / max(max |plain|, 1): float32
    # with the same formulas (1e-5; probit 3e-4, erfc against log_ndtr);
    # K3 and K4 are the same float32 sums in another order (1e-5); K2 is
    # rounded step by step like its plain version and must match exactly
    # (torch.equal); K3's bf16 mode 1e-6, below bf16's own effect on the
    # smoke's G (its fault controls show the margin)
    tol = {"glm_stats": 1e-5, "glm_stats_probit": 3e-4,
           "alpha_search": 1e-5, "cd_tile_solve": 0.0, "tile_gram": 1e-5,
           "tile_gram_bf16": 1e-6}
    parity = {}

    # K1 and K4 at the sparse fit's n (its labels, weights and offsets) and
    # at the dense fit's n = 400,000 (random, with random weights), against
    # the throughput floor of their per-example work (tools/loss_floor.cu)
    xb = torch.from_numpy((rng.normal(size=n) * 1.5).astype(np.float32)) \
        .to(dev)
    xdb = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    vec = lambda v: torch.from_numpy(v.astype(np.float32)).to(dev)
    sets = {n: (y, wobs, off, xb, xdb),
            N_DENSE: (vec(rng.choice([-1.0, 1.0], N_DENSE)),
                      vec(rng.random(N_DENSE)),
                      vec(0.1 * rng.normal(size=N_DENSE)),
                      vec(1.5 * rng.normal(size=N_DENSE)),
                      vec(rng.normal(size=N_DENSE)))}
    floors = loss_floors(np, torch, glm_stats_k.FAMILY_CODES)
    floor_lib = floor_tool()
    report["glm_stats"] = k1_report(np, torch, rng, sets, floors, floor_lib,
                                    tol, parity)
    report["alpha_search"], alpha_counts = k4_report(
        np, torch, rng, sets, floors, floor_lib, tol, parity)
    emit({"phase": "k1_k4", "card": card, "loss_floor_ns": floors,
          "glm_stats": report["glm_stats"],
          "alpha_search": report["alpha_search"]})
    del sets

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

    # K3's bf16 mode (precision="bf16" of the fused Jacobi superstep on
    # bricks) on the same tile: every block pair computed, none mirrored,
    # so G is not symmetric; its asymmetry must be the plain version's.
    # Its w and r are a later superstep's, at the random margins xb: the
    # first superstep's w is 1/4 on every row, and bf16(x / 4) = bf16(x) / 4
    # leaves that G exactly symmetric.
    _, s1, w1 = ops.glm_stats(y, xb, "logistic", weights=wobs, offset=off)
    Gb, gb = ops.tile_gram(tb, rows, K, w1, s1, precision="bf16")
    Gb2, gb2 = ref.tile_gram(tb, rows, K, w1.reshape(-1, rb),
                             s1.reshape(-1, rb), precision="bf16")
    scale = float(Gb2.abs().max())

    def k3b_off(Gx):
        """(G's error, its asymmetry's error) off the plain bf16 G,
        over the plain G's largest entry."""
        return (float((Gx - Gb2).abs().max()) / scale,
                errs(Gx - Gx.T, Gb2 - Gb2.T)[0] / scale)

    e3b_G, asym = k3b_off(Gb)
    e3b = max(e3b_G, errs(gb, gb2)[1])
    parity["tile_gram_bf16"] = e3b
    check(e3b <= tol["tile_gram_bf16"], f"tile_gram bf16: error {e3b}")
    check(not torch.equal(Gb, Gb.T) and asym <= tol["tile_gram_bf16"],
          f"tile_gram bf16: asymmetry {asym} off the plain version's")
    # Over 131,072 rows bf16 moves this G by only a few 1e-6 of its
    # largest entry, so the tolerance sits below that: the G of a kernel
    # that skipped a rounding, or mirrored its upper blocks, formed plainly
    # on the same inputs, must fail the same two checks
    A = tb * w1.reshape(-1, rb)[rows.long()][:, :, None]
    A32, A16 = A.double(), A.to(torch.bfloat16).double()
    B32, B16 = tb.double(), tb.to(torch.bfloat16).double()
    gram = lambda a, b: torch.einsum("kit,kiu->tu", a, b).float()
    upper = torch.triu(torch.ones(T, T, dtype=torch.bool, device=dev))
    faults = {"no_rounding": gram(A32, B32), "A_not_rounded": gram(A32, B16),
              "B_not_rounded": gram(A16, B32),
              "mirrored": torch.where(upper, Gb2, Gb2.T)}
    del A, A32, A16, B16, B32
    k3b_faults = {}
    for name, Gx in faults.items():
        ef, af = k3b_off(Gx)
        k3b_faults[name] = {"G_err": ef, "asymmetry_err": af}
        check(max(ef, af) > tol["tile_gram_bf16"],
              f"tile_gram bf16: the check passes a kernel with fault "
              f"{name} (G {ef}, asymmetry {af})")
    del faults
    Gb3, gb3 = ops.tile_gram(tb, rows, K, w1, s1, precision="bf16")
    check(torch.equal(Gb, Gb3) and torch.equal(gb, gb3),
          "tile_gram bf16: G differs from run to run")
    e3b = max(errs(Gb, Gb2)[0], errs(gb, gb2)[0])
    del Gb2, gb2, Gb3, gb3
    k3b_ms = time_ms(torch, lambda: tile_gram_k.launch(
        tb, rows, K, w1, s1, precision="bf16"), 20)
    k3b_plain = time_ms(torch, lambda: ref.tile_gram(
        tb, rows, K, w1.reshape(-1, rb), s1.reshape(-1, rb),
        precision="bf16"), 5)
    wk1 = w1.reshape(-1, rb)[rows.long()]
    A16 = (tb * wk1[:, :, None]).reshape(-1, T).to(torch.bfloat16)
    B16 = tb.reshape(-1, T).to(torch.bfloat16)
    k3b_lib, k3b_lib_what = library_bf16_ms(torch, A16.T, B16, 20)
    del A16, B16, wk1
    b_ms, b_by = bound_ms(k3_bytes, 2.0 * K * rb * T * T, H100_BF16_FLOPS)
    report["tile_gram_bf16"] = dict(
        ms=k3b_ms, plain_ms=k3b_plain, bound_ms=b_ms, bound_by=b_by,
        share_of_bound=b_ms / k3b_ms, library_ms=k3b_lib,
        library_covers=f"G only, operands rounded beforehand: {k3b_lib_what}",
        max_abs_err=e3b, K=K, asymmetry_vs_plain=asym,
        G_asymmetry=float((Gb - Gb.T).abs().max() / Gb.abs().max()),
        fault_controls=k3b_faults)
    del Gb, gb, s1, w1

    # K2 on that tile's Gram block (T = 256, h the strided diagonal view)
    # and on a T = 512 block, held bit for bit against the plain version;
    # T times the minimal step of tools/chain_floor.cu is its dependency
    # floor
    beta_t = torch.from_numpy((rng.normal(size=T) * 0.1).astype(np.float32)) \
        .to(dev)
    zeros = torch.zeros_like(beta_t)
    penf = solver._penf[tid * T:(tid + 1) * T].contiguous()
    mu = torch.full((), 1.0, device=dev)
    lam1 = 0.05 * float(g.abs().max())
    params = ops.solve_params(mu, 1e-6, lam1, 0.0, g)
    h = torch.diagonal(G)
    got = ops.cd_tile_solve(G, g, h, beta_t, zeros, params, penf=penf)
    want = ref.cd_tile_solve(G, g, h, beta_t, zeros, mu, 1e-6, lam1, 0.0,
                             penf=penf)
    check(torch.equal(got, want), "cd_tile_solve T=256: not bit-exact")
    e2 = float((got - want).abs().max())
    parity["cd_tile_solve"] = e2
    k2_ms = time_ms(torch, lambda: cd_tile_solve_k.launch(
        G, g, h, beta_t, zeros, params, penf), 200)
    k2_plain = time_ms(torch, lambda: ref.cd_tile_solve(
        G, g, h, beta_t, zeros, mu, 1e-6, lam1, 0.0, penf=penf), 3, 1)
    b_ms, b_by = k2_bound(T)
    steps = chain_floor(torch, G, g, beta_t, penf, mu, 1e-6, lam1, 0.0)
    T2 = 2 * T
    X2 = rng.normal(size=(4 * T2, T2)).astype(np.float32)
    w2 = rng.uniform(0.01, 0.25, 4 * T2).astype(np.float32)
    G2b = torch.from_numpy((X2.T * w2) @ X2).to(dev)
    g2b = torch.from_numpy(X2.T @ rng.normal(size=4 * T2)
                           .astype(np.float32)).to(dev)
    beta2 = torch.from_numpy((rng.normal(size=T2) * 0.1).astype(np.float32)) \
        .to(dev)
    zeros2 = torch.zeros_like(beta2)
    lam1_2 = 0.05 * float(g2b.abs().max())
    params2 = ops.solve_params(mu, 1e-6, lam1_2, 0.0, g2b)
    got2 = ops.cd_tile_solve(G2b, g2b, torch.diagonal(G2b), beta2, zeros2,
                             params2)
    want2 = ref.cd_tile_solve(G2b, g2b, torch.diagonal(G2b), beta2, zeros2,
                              mu, 1e-6, lam1_2, 0.0)
    check(torch.equal(got2, want2), "cd_tile_solve T=512: not bit-exact")
    k2_ms_512 = time_ms(torch, lambda: cd_tile_solve_k.launch(
        G2b, g2b, torch.diagonal(G2b), beta2, zeros2, params2, None), 200)
    del X2, G2b, g2b
    floor = T * steps["floor_step_ns"] * 1e-6
    floor_512 = T2 * steps["floor_step_ns"] * 1e-6
    report["cd_tile_solve"] = dict(
        ms=k2_ms, plain_ms=k2_plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, max_abs_err=e2, T=T, ms_T512=k2_ms_512,
        bound_ms_T512=k2_bound(T2)[0], dependency_floor_ms=floor,
        share_of_dependency_floor=floor / k2_ms,
        dependency_floor_ms_T512=floor_512,
        share_of_dependency_floor_T512=floor_512 / k2_ms_512, **steps)
    emit({"phase": "kernel_parity", "max_rel_err": parity,
          "tolerance": tol, "n": n, "T": T, "row_block": rb, "K": K,
          "alpha_counts": alpha_counts})
    del G, g, G2, g2, xb, xdb, wk, h

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
    def run_fit(tag, solver, X_test, y_test, want_per_step, prefixes=None,
                steps=5):
        """Fit at LAM1_FRACTION * lambda_max for ``steps`` supersteps with
        the launch counts set to 0 just before; ``want_per_step`` the exact
        launches of one superstep.  With ``prefixes`` (kernel: name prefix
        of its CUDA functions) a profiled fit then counts the CUDA launches
        behind each logical one: every CUDA function of the kernel must run
        once per logical launch.  Returns (the counts, the fit's result)."""
        t0 = time.perf_counter()
        lmax = solver.lambda_max()
        torch.cuda.synchronize()
        lmax_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = solver.fit(lam1=LAM1_FRACTION * lmax, max_outer=steps)
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
        return counts, res

    sparse_counts, sparse_res = run_fit("sparse", solver, ds.test.X,
                                        ds.test.y,
                               {"glm_stats": 1, "cd_tile_solve": nt,
                                "tile_gram": nt, "alpha_search": 2})
    del design, tb, rows, y, wobs, off, s0, w0, penf
    serve_counts = serve_phase(np, torch, solver, ds, dev, report, parity,
                               floor_lib, tdir)
    path = sparse_path_phase(np, torch, solver)
    checkpoint_phase(np, torch, GLMSolver, solver, ds, dev, path)
    trace_phase(np, torch, solver, path, tdir, card)
    path_reference_phase(np, GLMSolver, DGLMNETConfig, synthetic, dev)
    lam1_sparse = LAM1_FRACTION * solver.lambda_max()
    del solver, path
    torch.cuda.empty_cache()
    multinomial_counts = multinomial_phase(np, torch, GLMSolver,
                                           DGLMNETConfig, ds, dev)
    estimator_counts = estimator_phase(np, torch, GLMSolver, DGLMNETConfig,
                                       synthetic, ds, dev, lam1_sparse)
    # the fused Jacobi superstep on bricks, in fp32 and in bf16: K1, K3 (or
    # its bf16 mode) for every tile, K2 once for all of them (batched), a
    # float32 matvec and K4 over all 294 candidates; a profiled fit holds
    # each kernel's CUDA functions to its logical launches
    sparse_jacobi = {}
    for prec, k3 in (("fp32", "tile_gram"), ("bf16", "tile_gram_bf16")):
        sj = full_size_solver(GLMSolver, ds, dev, DGLMNETConfig(
            coupling="jacobi", precision=prec))
        tag = "sparse_jacobi" + ("_bf16" if prec == "bf16" else "")
        sparse_jacobi[prec] = run_fit(
            tag, sj, ds.test.X, ds.test.y,
            {"glm_stats": 1, k3: nt, "cd_tile_solve": 1, "alpha_search": 1},
            {"glm_stats": "glm_stats_", k3: "tile_gram_",
             "cd_tile_solve": "cd_tile_solve_",
             "alpha_search": "alpha_search_"}, steps=3)
        del sj
        torch.cuda.empty_cache()
    emit(bf16_tracks_fp32(np, "sparse_jacobi_bf16", sparse_jacobi["fp32"][1],
                          sparse_jacobi["bf16"][1]))
    ingest_data = (ds.train.X, ds.train.y)      # the ingest phase's rows
    del ds

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
    dense_counts, dense_res = run_fit("dense", dsolver, dd.test.X, dd.test.y,
                                      {"glm_stats": 1, "cd_tile_solve": dnt,
                                       "alpha_search": 2})
    lmax_dense = dsolver.lambda_max()
    del dsolver
    torch.cuda.empty_cache()

    jsolver = full_size_solver(GLMSolver, dd, dev,
                               DGLMNETConfig(coupling="jacobi"))
    fused_parity(np, torch, jsolver, dev, report, parity)
    jacobi_counts, jres = run_fit(
        "dense_jacobi", jsolver, dd.test.X, dd.test.y,
        {"stats_gram_solve": 1, "margin_ls": 1},
        {"stats_gram_solve": "sgs_", "margin_ls": "margin_ls_"})
    del jsolver
    torch.cuda.empty_cache()
    # the same fit in bf16: the bf16 modes of K5 and K6, held against the
    # fp32 fit above
    bsolver = full_size_solver(GLMSolver, dd, dev, DGLMNETConfig(
        coupling="jacobi", precision="bf16"))
    bf16_counts, bres = run_fit(
        "dense_jacobi_bf16", bsolver, dd.test.X, dd.test.y,
        {"stats_gram_solve_bf16": 1, "margin_ls_bf16": 1},
        {"stats_gram_solve_bf16": "sgs_", "margin_ls_bf16": "margin_ls_"})
    emit(bf16_tracks_fp32(np, "dense_jacobi_bf16", jres, bres))
    del bsolver, jres, bres
    torch.cuda.empty_cache()
    # the unfused Jacobi superstep on the same data: a cuBLAS Gram per
    # tile, one K2 launch for every tile (as the reference's vmap is one
    # program), one matvec and the two-launch line search (K4)
    usolver = full_size_solver(GLMSolver, dd, dev,
                               DGLMNETConfig(coupling="jacobi",
                                             fuse_superstep=False))
    run_fit("dense_jacobi_unfused", usolver, dd.test.X, dd.test.y,
            {"glm_stats": 1, "cd_tile_solve": 1, "alpha_search": 2})
    # the streaming Jacobi fit's reference: 3 unfused supersteps
    lam1_unfused = LAM1_FRACTION * usolver.lambda_max()
    unfused_res = usolver.fit(lam1=lam1_unfused, max_outer=3, tol=0.0)
    del usolver
    torch.cuda.empty_cache()
    dense_cv_phase(np, torch, GLMSolver, DGLMNETConfig, dd, dev)
    torch.cuda.empty_cache()
    stream = stream_phase(np, torch, GLMSolver, DGLMNETConfig, dd, dev,
                          (LAM1_FRACTION * lmax_dense, dense_res),
                          (lam1_unfused, unfused_res), lmax_dense, floors,
                          floor_lib, parity, card, tdir)
    # the dist phase streams the dense train split from a .npy
    dist_tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-npy-")
    dense_npy = (str(pathlib.Path(dist_tmp.name) / "X.npy"),
                 str(pathlib.Path(dist_tmp.name) / "y.npy"))
    np.save(dense_npy[0], np.asarray(dd.train.X, np.float32))
    np.save(dense_npy[1], np.asarray(dd.train.y, np.float32))
    del dd, dense_res, unfused_res
    torch.cuda.empty_cache()
    ingest_counts = ingest_phase(np, torch, *ingest_data, dev, card)
    del ingest_data
    torch.cuda.empty_cache()
    dist_counts = dist_phase(np, torch, sparse_res, lam1_sparse, dense_npy,
                             LAM1_FRACTION * lmax_dense, card)
    dist_tmp.cleanup()
    for name in ("glm_stats", "cd_tile_solve", "alpha_search"):
        report[name]["chunk_shapes"] = stream["kernels"][name]
        report[name]["launches_stream"] = stream["counts"][name]
    emit({"phase": "kernel_parity_report", "max_rel_err": parity})
    # the four built-in families never took a plain route on the card
    built_in = {"sparse": sparse_counts, "serve": serve_counts,
                "multinomial": multinomial_counts,
                **{f"estimator_{i}": c
                   for i, c in enumerate(estimator_counts)},
                "sparse_jacobi": sparse_jacobi["fp32"][0],
                "sparse_jacobi_bf16": sparse_jacobi["bf16"][0],
                "dense": dense_counts, "dense_jacobi": jacobi_counts,
                "dense_jacobi_bf16": bf16_counts, "stream": stream["counts"],
                "stream_jacobi": stream["jacobi_counts"],
                "ingest": ingest_counts}
    plain = {tag: {k: v for k, v in c.items() if k.endswith("/plain") and v}
             for tag, c in built_in.items()}
    check(not any(plain.values()) and all(
        f"{k}/plain" in c for c in built_in.values()
        for k in ops.PLAIN_ROUTES),
          f"built-in families took a plain route: {plain}")
    emit({"phase": "plain_routes", "built_in_plain_calls": 0,
          "runs_checked": sorted(built_in)})
    trace_tmp.cleanup()

    # ------------------------------------------------------------- report
    # the bf16 modes replace the bf16 branches of the TPU kernels' bodies;
    # the reference forms the brick route's bf16 Gram in ref.py
    src = {"glm_stats": "src/repro/kernels/glm_stats.py:72",
           "cd_tile_solve": "src/repro/kernels/cd_tile_solve.py:74",
           "tile_gram": "src/repro/kernels/tile_gram.py:59",
           "alpha_search": "src/repro/kernels/alpha_search.py:48",
           "stats_gram_solve": "src/repro/kernels/superstep_tile.py:152",
           "margin_ls": "src/repro/kernels/superstep_tile.py:251",
           "predict_tile": "src/repro/kernels/predict_tile.py:68",
           "stats_gram_solve_bf16": "src/repro/kernels/superstep_tile.py:123",
           "margin_ls_bf16": "src/repro/kernels/superstep_tile.py:217",
           "tile_gram_bf16": "src/repro/kernels/ref.py:161"}
    # each kernel's launches come from the run of its own path
    main_path = {"glm_stats": sparse_counts, "cd_tile_solve": sparse_counts,
                 "tile_gram": sparse_counts, "alpha_search": sparse_counts,
                 "stats_gram_solve": jacobi_counts,
                 "margin_ls": jacobi_counts, "predict_tile": serve_counts,
                 "stats_gram_solve_bf16": bf16_counts,
                 "margin_ls_bf16": bf16_counts,
                 "tile_gram_bf16": sparse_jacobi["bf16"][0]}
    kernels = []
    for name in src:
        rep = report[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      f"{name.removesuffix('_bf16')}.cu",
            "replaces": src[name], "launches": main_path[name][name],
            "launches_dense": dense_counts[name],
            **({"launches_dist_per_rank": {
                mesh: [c.get(name, 0) for c in per_rank]
                for mesh, per_rank in dist_counts.items()}}
               if name in ("glm_stats", "cd_tile_solve", "tile_gram",
                           "alpha_search") else {}),
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            **{k: rep[k] for k in ("bound_fma_ms", "bound_fma_by",
                                   "share_of_tensor_core_bound",
                                   "share_of_fma_bound", "tflops_needed",
                                   "tf32_tflops_executed", "plain_note",
                                   "dependency_floor_ms",
                                   "share_of_dependency_floor", "ms_T512",
                                   "bound_ms_T512",
                                   "dependency_floor_ms_T512",
                                   "share_of_dependency_floor_T512",
                                   "floor_step_cycles", "floor_step_ns",
                                   "floor_probe_clock_mhz",
                                   "design_step_cycles", "design_step_ns",
                                   "design_probe_clock_mhz", "batched_ms",
                                   "batched_tiles", "launch_floor_ms",
                                   "share_of_launch_floor", "share_of_bound",
                                   "library_share_of_bound", "grid_blocks",
                                   "sm_count", "ms_B64", "launch_floor_ms_B64",
                                   "share_of_launch_floor_B64",
                                   "bound_ms_B64", "library_covers",
                                   "shapes", "loss_floor_ns",
                                   "stats_floor_ns", "bytes_bound_ms",
                                   "loss_floor_ms", "stats_floor_ms",
                                   "at_half_of_bound", "threads", "n", "K",
                                   "asymmetry_vs_plain", "G_asymmetry",
                                   "fault_controls", "launches_stream",
                                   "chunk_shapes")
               if k in rep}})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
