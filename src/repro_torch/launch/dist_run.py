"""Distributed GLM launcher: ``python -m repro_torch.launch.dist_run [...]``
(mirrors ``repro.launch.dist_run``).

Two modes of one entry point:

  * **parent** (no ``REPRO_DIST_PROCID`` in the environment and
    ``--nprocs`` > 1): spawn ``--nprocs`` coordinated local workers through
    ``repro_torch.dist.launcher`` (each under ``--timeout``) and relay
    their output;
  * **worker** (env set, or ``--nprocs 1``): ``bootstrap.initialize()``,
    the (``--data-shards`` x rest) mesh, and the ``--demo`` lasso fit on a
    synthetic dense design, optionally under a fault plan (``--faults
    "1:4.0"``) with telemetry-driven ALB (``--telemetry``).

``--data FILE`` is multi-process out-of-core training: every process opens
the same libsvm or Parquet file through ``repro_torch.io`` (or a ``.npy``
array, memory-mapped, with ``--labels`` a ``.npy`` of y), takes its own
contiguous chunk range (``StreamingDesign.process_slice``) and runs the
streaming superstep on its chunks only; the statistics (G, g0, L) and the
candidate losses are summed over the processes by ``all_reduce``, so the
fit is the single-process fit (``--nprocs 1`` on the same file is the
baseline).

``--backend`` is the process group's (default: ``"cpu:gloo,cuda:nccl"``,
NCCL needing a card per rank; ``gloo`` lets several ranks share one card
or run on the CPU); ``--device cpu`` keeps the ranks off the card.  The
coordinator prints one JSON line (``--out`` also writes it).
"""
import argparse
import json
import os
import sys
import time


def _emit(args, row: dict):
    blob = json.dumps(row)
    print(blob, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(blob)


def _worker_stream(args) -> int:
    """Out-of-core multi-process worker: its chunk range, summed."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import io as io_lib
    from repro_torch.core.dglmnet import (DGLMNETConfig, FitState,
                                          make_streaming_superstep)
    from repro_torch.data.design import streaming_design
    from repro_torch.device import resolve_device
    from repro_torch.dist import bootstrap, faults
    from repro_torch.sharding import collectives

    ctx = bootstrap.initialize(backend=args.backend, device=args.device)
    dev = resolve_device(args.device)
    world = dist.group.WORLD if dist.is_initialized() else None

    if args.data.endswith(".npy"):
        # a host array, memory-mapped: chunks are read where they lie
        Xh = np.load(args.data, mmap_mode="r")
        labels = np.load(args.labels)
        design = streaming_design(Xh, args.tile, chunk_rows=args.chunk_rows,
                                  device=dev)[0]
        n_rows, n_features = Xh.shape
    else:
        hasher = io_lib.FeatureHasher(args.hash_dim, tile_size=args.tile) \
            if args.hash_dim else None
        design, labels, reader = io_lib.open_design(
            args.data, tile_size=args.tile, chunk_rows=args.chunk_rows,
            hasher=hasher, prefetch_chunks=2 if args.prefetch else 0,
            device=dev)
        n_rows, n_features = reader.n_rows, reader.n_features
    local, rows = design.process_slice(ctx.process_id, ctx.num_processes)
    n_loc = rows.stop - rows.start
    n_pad = local.n_chunks * local.chunk_rows

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    y = put(np.pad(np.asarray(labels[rows], np.float32), (0, n_pad - n_loc),
                   constant_values=1.0))
    w = put(np.pad(np.ones((n_loc,), np.float32), (0, n_pad - n_loc)))
    o = put(np.zeros((n_pad,), np.float32))
    p_pad = local.shape[1]
    cfg = DGLMNETConfig(tile_size=args.tile, max_outer=args.steps)
    fns = make_streaming_superstep(cfg, n_tiles=p_pad // args.tile,
                                   device=dev)
    lams = (args.lam1, args.lam2)
    penf = put(np.ones((p_pad,), np.float32))
    state = FitState(beta=torch.zeros(p_pad, device=dev),
                     xb=torch.zeros(0, device=dev),
                     mu=torch.tensor(cfg.mu_init, device=dev), cursor=0,
                     step=0)

    def chunks():
        for i, Xc in local.iter_chunks():
            sl = local.row_slice(i)
            yield Xc, y[sl], w[sl], o[sl]

    collectives.reset_stats()
    t0 = time.perf_counter()
    f_prev, n_iter, f = None, 0, float("nan")
    fs = []
    for it in range(args.steps):
        acc = (torch.zeros((p_pad, p_pad), device=dev),
               torch.zeros(p_pad, device=dev), torch.zeros((), device=dev))
        for Xc, yc, wc, oc in chunks():
            acc = fns.stats_chunk(Xc, yc, wc, oc, state.beta, acc)
        # this process's partial (G, g0, L) -> the job's, one reduction
        acc = tuple(collectives.all_reduce_many(acc, world))
        prep = fns.prepare(acc, state.beta, state.mu, lams, penf,
                           state.cursor)
        losses = torch.zeros(fns.n_candidates, device=dev)
        for Xc, yc, wc, oc in chunks():
            losses = fns.ls_chunk(Xc, yc, wc, oc, state.beta,
                                  prep["dbeta"], losses)
        losses = collectives.all_reduce(losses, world)
        state, metrics = fns.finish(losses, prep, state, lams, penf)
        n_iter = it + 1
        # every process holds the same sums, so the same f and stop
        f = float(metrics["f"])
        fs.append(f)
        if f_prev is not None and abs(f_prev - f) <= args.tol * max(
                abs(f_prev), 1.0):
            break
        f_prev = f
    wall = time.perf_counter() - t0
    beta = state.beta.cpu().numpy()
    if ctx.is_coordinator:
        _emit(args, {
            "mode": "stream", "data": str(args.data),
            "num_processes": ctx.num_processes, "device": ctx.device,
            "rows": n_rows, "features": n_features,
            "design_cols": p_pad, "chunks_local": local.n_chunks,
            "chunk_rows": args.chunk_rows,
            "hash_dim": args.hash_dim or None,
            "prefetch": bool(args.prefetch), "supersteps": n_iter,
            "f_final": f, "f": fs, "nnz": int((np.abs(beta) > 1e-8).sum()),
            "wall_s": wall,
            "rows_per_s": n_rows * n_iter * 2 / max(wall, 1e-9),
            "collective_s": collectives.stats()["seconds"],
            "beta": beta.tolist()})
    faults.guarded_barrier("dist-run-stream-exit")
    bootstrap.shutdown()
    return 0


def _worker(args) -> int:
    import numpy as np

    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.core.solver import GLMSolver
    from repro_torch.dist import bootstrap, faults, telemetry
    from repro_torch.sharding import collectives

    t_start = time.perf_counter()
    ctx = bootstrap.initialize(backend=args.backend, device=args.device)
    mesh = bootstrap.make_dist_mesh(args.data_shards)
    rng = np.random.default_rng(0)
    n, p = args.rows, args.cols
    X = rng.normal(size=(n, p)).astype(np.float32)
    beta_true = np.zeros((p,), np.float32)
    beta_true[: p // 8] = rng.normal(size=p // 8)
    y = (X @ beta_true + 0.1 * rng.normal(size=n)).astype(np.float32)

    plan = None
    if args.faults:
        plan = faults.FaultPlan.parse(args.faults, ctx.num_processes,
                                      tile_cost_s=args.tile_cost_s)
    tel = telemetry.SuperstepTelemetry(phase_aware=args.phase_aware) \
        if args.telemetry else None

    solver = GLMSolver(
        X, y, config=DGLMNETConfig(tile_size=args.tile,
                                   max_outer=args.steps),
        mesh=mesh, telemetry=tel, fault_plan=plan, device=args.device)
    budget_history = []
    budgets = solver._budgets

    def recorded():
        b = budgets()
        budget_history.append(solver._budgets_host.tolist())
        return b

    solver._budgets = recorded
    collectives.reset_stats()
    t0 = time.perf_counter()
    res = solver.fit(lam1=args.lam1, lam2=1e-4)
    fit_s = time.perf_counter() - t0
    nnz = int((np.abs(res.beta) > 1e-8).sum())
    # every rank's budget vectors, superstep by superstep, on process 0
    mine = np.asarray(budget_history, np.int64).reshape(1, -1)
    every = bootstrap.gather_to_host(mine) if ctx.coordinator else mine
    if ctx.is_coordinator:
        _emit(args, {
            "process_id": ctx.process_id,
            "num_processes": ctx.num_processes, "device": ctx.device,
            "backend": ctx.backend,
            "mesh": [int(s) for s in mesh.mesh.shape],
            "f": res.history["f"][-1], "nnz": nnz,
            "n_iter": res.n_iter, "converged": bool(res.converged),
            "alpha": res.history["alpha"],
            "budgets": None if solver._budgets_host is None
            else solver._budgets_host.tolist(),
            "budget_history": budget_history,
            "budgets_agree": bool((every == every[0]).all()),
            "speeds": None if tel is None or tel.speeds() is None
            else tel.speeds().tolist(),
            "fit_s": fit_s, "start_s": t0 - t_start,
            "collective_s": collectives.stats()["seconds"]})
    faults.guarded_barrier("dist-run-exit")
    bootstrap.shutdown()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nprocs", type=int, default=2,
                    help="local processes to spawn (parent mode)")
    ap.add_argument("--demo", action="store_true",
                    help="run the synthetic lasso demo fit (worker mode "
                    "runs it always; parent mode spawns workers that do)")
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--cols", type=int, default=256)
    ap.add_argument("--tile", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lam1", type=float, default=0.05)
    ap.add_argument("--data-shards", type=int, default=1,
                    dest="data_shards",
                    help="rows of the mesh (D); the rest is its model dim")
    ap.add_argument("--faults", default="",
                    help='fault spec, e.g. "1:4.0" or "0:2.0,1:4.0@10-20"')
    ap.add_argument("--tile-cost-s", type=float, default=0.0,
                    dest="tile_cost_s",
                    help="simulated seconds of local work per tile (>0 "
                    "activates fault injection sleeps)")
    ap.add_argument("--telemetry", action="store_true",
                    help="drive ALB budgets from measured node speeds")
    ap.add_argument("--phase-aware", action="store_true", dest="phase_aware",
                    help="budgets react to compute-phase speed only (a "
                    "network-slow node keeps its tile budget)")
    ap.add_argument("--trace", default="",
                    help="directory for repro_torch.obs traces: every "
                    "process writes its trace_<pid>.json shard (and "
                    "metrics and convergence streams); the parent merges "
                    "the shards into trace_merged.json")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds before the parent kills every worker")
    ap.add_argument("--data", default="",
                    help="libsvm(.gz)/Parquet file: multi-process "
                    "out-of-core training over per-process chunk ranges")
    ap.add_argument("--labels", default="",
                    help="a .npy of y, with a .npy --data")
    ap.add_argument("--chunk-rows", type=int, default=4096,
                    dest="chunk_rows")
    ap.add_argument("--hash-dim", type=int, default=0, dest="hash_dim")
    ap.add_argument("--lam2", type=float, default=0.0)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--prefetch", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--backend", default=None,
                    help="process-group backend (default "
                    "'cpu:gloo,cuda:nccl': a card per rank; 'gloo' to "
                    "share one card or run on the CPU)")
    ap.add_argument("--device", default=None,
                    help="None: card process_id %% device_count; 'cpu'")
    ap.add_argument("--out", default="",
                    help="the coordinator writes its result row here")
    args = ap.parse_args(argv)
    argv = sys.argv[1:] if argv is None else list(argv)

    if os.environ.get("REPRO_DIST_PROCID") is not None or args.nprocs <= 1:
        if args.trace:
            # workers spawned by the parent inherit REPRO_TRACE and are
            # enabled at import; a solo run enables here
            from repro_torch.obs import trace as obs_trace
            if not obs_trace.get_tracer().enabled:
                obs_trace.enable(args.trace)
        return _worker_stream(args) if args.data else _worker(args)

    from repro_torch.dist import launcher
    env = {"REPRO_TRACE": args.trace} if args.trace else None
    forwarded, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--nprocs":
            skip = True
        elif not a.startswith("--nprocs="):
            forwarded.append(a)
    result = launcher.run_local(args.nprocs, "repro_torch.launch.dist_run",
                                args=forwarded, timeout_s=args.timeout,
                                env=env)
    print(result.summary())
    if args.trace:
        from repro_torch.obs import trace as obs_trace
        merged = obs_trace.merge_dir(args.trace)
        if merged is not None:
            print(f"[dist_run] merged trace: {merged}")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
