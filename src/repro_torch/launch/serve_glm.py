"""GLM serving launcher: load an artifact, drive synthetic traffic
(mirrors ``repro.launch.serve_glm``).

    PYTHONPATH=src python -m repro_torch.launch.serve_glm --artifact DIR --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_glm --artifact DIR \\
        --requests 2000 --nnz 24 --max-batch 64 --max-delay-ms 2 \\
        --json out.json

Loads a ``repro_torch.serve`` artifact (``GLMSolver.save``, an estimator's
``save``, or the JAX package's: the format is shared) into the scoring
engine on ``--device`` (default: the CUDA card; ``cpu`` runs the plain
versions), wraps it in the micro-batching frontend and pushes a synthetic
open-loop stream of sparse feature-list requests through it (``--rate``
requests/s, Poisson arrivals; ``--rate 0``: closed loop, as fast as
submission allows).  Prints one JSON record with p50/p99 request latency,
rows/s, batch occupancy and the count of distinct scoring shapes, with its
bound.

``--batch1`` serves every request as its own engine call (the
no-coalescing baseline) instead of micro-batching.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from repro_torch.timing import percentiles


def synth_requests(rng, n_requests: int, n_features: int, nnz: int):
    """Sparse feature-list requests whose sizes span [nnz/2, 3 nnz/2], so
    traffic crosses nnz-bucket boundaries; values standard normal."""
    reqs = []
    lo, hi = max(1, nnz // 2), max(2, (3 * nnz) // 2 + 1)
    for _ in range(n_requests):
        k = min(int(rng.integers(lo, hi)), n_features)
        idx = rng.choice(n_features, size=k, replace=False)
        reqs.append((idx, rng.normal(size=k).astype(np.float32)))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", required=True, help="artifact directory "
                    "(repro_torch.serve.save_artifact / estimator.save)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny traffic run; still emits the full JSON")
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--nnz", type=int, default=24,
                    help="mean request nnz (uniform ±50%%)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop arrival rate (req/s); 0 = closed loop")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    ap.add_argument("--batch1", action="store_true",
                    help="no coalescing: one engine call per request "
                    "(the baseline)")
    ap.add_argument("--kind", choices=("response", "link"),
                    default="response")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None,
                    help="also write the JSON record to this path")
    ap.add_argument("--device", default=None,
                    help="where the engine runs (default: the CUDA card; "
                    "'cpu' for the plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.serve import MicroBatcher, ScoringEngine, load_artifact
    from repro_torch.serve.batcher import DEFAULT_NNZ_BUCKETS
    from repro_torch.timing import timed

    if args.smoke:
        args.requests = min(args.requests, 200)

    model = load_artifact(args.artifact)
    engine = ScoringEngine(model, device=args.device)
    print(f"[serve_glm] family={model.family} p={model.n_features} "
          f"outputs={model.n_outputs} active={engine.n_active} "
          f"dtype={'int8' if model.quant else 'float32'} "
          f"device={engine.device}", file=sys.stderr)

    rng = np.random.default_rng(args.seed)
    reqs = synth_requests(rng, args.requests, model.n_features, args.nnz)

    batch_buckets = tuple(b for b in (1, 4, 16, 64, 256)
                          if b <= args.max_batch) or (args.max_batch,)
    if batch_buckets[-1] != args.max_batch:
        batch_buckets = batch_buckets + (args.max_batch,)

    record = {
        "figure": "serve_glm",
        "artifact": args.artifact,
        "family": model.family,
        "n_features": model.n_features,
        "n_outputs": model.n_outputs,
        "n_active": engine.n_active,
        "dtype": "int8" if model.quant else "float32",
        "mode": "batch1" if args.batch1 else "coalesced",
        "kind": args.kind,
        "nnz": args.nnz,
        "rate": args.rate,
        "device": str(engine.device),
    }

    if args.batch1:
        batcher = MicroBatcher(engine, max_delay_ms=args.max_delay_ms,
                               batch_buckets=(1,), kind=args.kind)
        batcher.warmup()
        # one engine call per request
        lat = []
        _, t_total = timed(lambda: [lat.append(
            timed(batcher.score_one, i, v)[1]) for i, v in reqs])
        batcher.close()
        pct = percentiles([v * 1e3 for v in lat])
        record.update(
            n_requests=len(reqs), n_batches=len(reqs), mean_batch=1.0,
            p50_ms=pct["p50"], p99_ms=pct["p99"],
            rows_per_s=float(len(reqs) / t_total),
            compiled_shapes=engine.compile_count)
    else:
        with MicroBatcher(engine, max_delay_ms=args.max_delay_ms,
                          batch_buckets=batch_buckets,
                          kind=args.kind) as batcher:
            batcher.warmup()
            handles = []
            for idx, val in reqs:
                handles.append(batcher.submit(idx, val))
                if args.rate > 0:
                    time.sleep(rng.exponential(1.0 / args.rate))
            for h in handles:
                h.get(timeout=60.0)
            stats = batcher.stats()
        record.update({k: stats[k] for k in
                       ("n_requests", "n_batches", "mean_batch", "p50_ms",
                        "p99_ms", "rows_per_s", "compiled_shapes")})
        # one scoring shape per (batch, nnz) bucket and kind: a "response"
        # batcher also warms the "link" shapes for offset traffic
        # (outsized-nnz requests may exceed the bound; traffic inside the
        # buckets never does)
        kinds = 2 if args.kind == "response" else 1
        record["shape_bucket_bound"] = \
            len(batch_buckets) * len(DEFAULT_NNZ_BUCKETS) * kinds

    out = json.dumps(record, indent=1)
    print(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
