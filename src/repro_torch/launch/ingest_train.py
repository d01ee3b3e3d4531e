"""Out-of-core training from a file: ``python -m
repro_torch.launch.ingest_train`` (mirrors ``repro.launch.ingest_train``).

Fits an elastic-net GLM straight from libsvm text (optionally gzip) or
Parquet through ``repro_torch.io``: the file streams chunk by chunk into a
``StreamingDesign`` and is never held whole, with optional signed feature
hashing (``--hash-dim``) for unbounded vocabularies and a background
thread that parses the next chunks while the device works.  It runs on
``--device`` (default: the CUDA card; ``cpu`` for the plain versions) and
prints one JSON record (also written to ``--json``).

``--smoke`` writes a small libsvm.gz corpus to a temporary directory, fits
it out of core and in memory, and fails unless the two coefficient vectors
agree within 1e-5; it then prints ``INGEST_SMOKE_OK``.
"""
import argparse
import json
import os
import sys
import tempfile
import time


def _emit(record: dict, path) -> None:
    print(json.dumps(record))
    if path:
        with open(path, "w") as f:
            json.dump(record, f)


def _train(args) -> dict:
    import numpy as np

    from repro_torch import io as io_lib
    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.core.solver import GLMSolver

    cfg = DGLMNETConfig(tile_size=args.tile, max_outer=args.steps)
    reader = io_lib.open_reader(args.data, chunk_rows=args.chunk_rows)
    hasher = None
    if args.hash_dim:
        hasher = io_lib.FeatureHasher(args.hash_dim, tile_size=args.tile,
                                      seed=args.seed)
    design, labels, reader = io_lib.open_design(
        reader, tile_size=args.tile, hasher=hasher,
        interactions=args.interactions, prefetch=True,
        prefetch_chunks=args.prefetch_chunks if args.prefetch else 0,
        device=args.device)

    t0 = time.perf_counter()
    if args.family == "multinomial":
        from repro_torch.glm.estimators import MultinomialGLM
        est = MultinomialGLM(lam1=args.lam1, lam2=args.lam2,
                             fit_intercept=args.intercept,
                             standardize=False, config=cfg,
                             device=args.device)
        est.fit(design, labels)
        wall = time.perf_counter() - t0
        nnz = int((np.abs(est.coef_) > 1e-8).sum())
        out = {"family": "multinomial", "classes": len(est.classes_),
               "cycles": est.n_cycles_, "objective": est.objective_}
        device = est.solver_.device
    else:
        solver = GLMSolver(design, labels, family=args.family, config=cfg,
                           fit_intercept=args.intercept, device=args.device)
        res = solver.fit(lam1=args.lam1, lam2=args.lam2)
        wall = time.perf_counter() - t0
        nnz = int((np.abs(solver.beta_) > 1e-8).sum())
        out = {"family": args.family, "f": res.history["f"][-1],
               "f_history": res.history["f"],
               "superstep_s": res.history["step_s"],
               "n_iter": res.n_iter, "converged": bool(res.converged)}
        device = solver.device
    out.update({
        "data": str(args.data), "rows": reader.n_rows,
        "features": reader.n_features,
        "design_cols": design.shape[1], "chunks": reader.n_chunks,
        "chunk_rows": args.chunk_rows,
        "hash_dim": args.hash_dim or None,
        "prefetch": bool(args.prefetch), "nnz": nnz,
        "device": str(device), "wall_s": wall,
        "rows_per_s": reader.n_rows * max(out.get("n_iter", 1), 1)
        / max(wall, 1e-9),
    })
    return out


def _smoke(device, json_path) -> int:
    import numpy as np

    from repro_torch import io as io_lib
    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.core.solver import GLMSolver

    rng = np.random.default_rng(0)
    n, p = 600, 24
    X = rng.normal(size=(n, p)).astype(np.float32)
    X[rng.random(size=X.shape) < 0.5] = 0.0          # sparse, text-like
    beta = np.zeros((p,), np.float32)
    beta[:6] = rng.normal(size=6)
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-(X @ beta))),
                 1.0, -1.0).astype(np.float32)

    with tempfile.TemporaryDirectory() as td:
        path = io_lib.write_libsvm(os.path.join(td, "smoke.libsvm.gz"), X, y)
        cfg = DGLMNETConfig(tile_size=8, max_outer=60)
        s_file = GLMSolver(str(path), None, family="logistic", config=cfg,
                           fit_intercept=True, device=device)
        r_file = s_file.fit(lam1=0.02, lam2=0.0)
        s_mem = GLMSolver(X, y, family="logistic", config=cfg,
                          fit_intercept=True, device=device)
        s_mem.fit(lam1=0.02, lam2=0.0)
        err = float(np.max(np.abs(s_file.beta_ - s_mem.beta_)))
        err = max(err, abs(s_file.intercept_ - s_mem.intercept_))
        _emit({"rows": n, "features": p, "beta_max_err": err,
               "nnz": int((np.abs(s_file.beta_) > 1e-8).sum()),
               "converged": bool(r_file.converged),
               "n_iter": r_file.n_iter, "device": str(s_file.device)},
              json_path)
        if err > 1e-5:
            print(f"ingest_train --smoke: file-vs-memory parity broke: "
                  f"{err}", file=sys.stderr)
            return 1
    print("INGEST_SMOKE_OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", help="libsvm(.gz) or Parquet file")
    ap.add_argument("--family", default="logistic",
                    choices=["logistic", "squared", "probit", "poisson",
                             "multinomial"])
    ap.add_argument("--lam1", type=float, default=0.01)
    ap.add_argument("--lam2", type=float, default=0.0)
    ap.add_argument("--tile", type=int, default=64)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--chunk-rows", type=int, default=4096,
                    dest="chunk_rows")
    ap.add_argument("--hash-dim", type=int, default=0, dest="hash_dim",
                    help="signed feature hashing into this many columns "
                    "(0 = exact feature space)")
    ap.add_argument("--interactions", type=int, default=0,
                    help="hash pairwise feature crosses from the first K "
                    "keys of each row (requires --hash-dim)")
    ap.add_argument("--prefetch", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="background chunk production thread")
    ap.add_argument("--prefetch-chunks", type=int, default=2,
                    dest="prefetch_chunks")
    ap.add_argument("--intercept", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the fit runs (default: the CUDA card; "
                    "'cpu' for the plain versions)")
    ap.add_argument("--json", default=None,
                    help="also write the JSON record to this path")
    ap.add_argument("--smoke", action="store_true",
                    help="self-contained parity gate (writes its own small "
                    "corpus)")
    args = ap.parse_args(argv)

    if args.smoke:
        return _smoke(args.device, args.json)
    if not args.data:
        ap.error("--data is required (or use --smoke)")
    _emit(_train(args), args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
