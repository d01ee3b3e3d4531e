"""repro_torch's sharded fits on a (data x model) mesh of CPU processes
(gloo), held against JAX's sharded fits on the same mesh.

The module is also its own worker and reference script:

  * ``python tests/test_torch_sharded.py --worker W2|W2b|W4 --out DIR``
    runs as one rank of a port world (``repro_torch.dist.launcher``,
    ``backend="gloo"``, ``device="cpu"``); every rank writes
    ``DIR/rank<r>.json`` with its results and histories;
  * ``python tests/test_torch_sharded.py --jax-ref OUT`` (4 fake XLA
    devices) runs the same cases through the JAX package on a
    single-process mesh, and ``--jax-resume DIR OUT`` (2 fake devices)
    resumes JAX's (1, 2) fit from a checkpoint the port wrote.

The worlds: W2 (2 processes) holds the (1, 2) cases (dense and brick
parity with ``tests/progs/multiproc_glm.py --mode single``, run
unchanged; ALB speeds [1, 0.25]; bf16 and int8 margin merges;
``psum_compressed``; the checkpoints a restart resumes), W4 (4 processes)
the (2, 2) cases (Gauss-Seidel and Jacobi fits, ``fit_path`` and
``fit_cv`` with screening, ``standardize=True``, ``fit_sharded``, an
estimator, the layouts a mesh refuses), W2b (2 fresh processes) the
restarts: the port's checkpoint, JAX's 2-process checkpoint
(``multiproc_glm.py --mode ckpt-a`` under JAX's launcher) and the elastic
resume (1, 2) -> (2, 1).  Every world runs under ``run_local``'s timeout.

Bars: fits at a fixed superstep count (``tol=0``, under the float32
plateau; paths and CV at ``tol=1e-4``) give the same alpha at every
superstep and beta within 1e-5 of JAX's, padded coordinates exactly 0;
ALB budgets equal JAX's at every superstep; compressed merges within
``COMPRESS_F_REL`` of JAX's objective (the reference's own bar is 50 x
2e-3 |f*| against the optimum); ``psum_compressed`` exact for None,
int8 within M amax / 254 of the exact sum; restarts within 1e-5 with the
same ``n_iter``; the elastic resume within 2e-3 |f*| of FISTA's optimum;
every rank of a world reports the same (f, alpha, nnz, n_iter).
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
SRC = REPO / "src"
PROG = REPO / "tests" / "progs" / "multiproc_glm.py"
THIS = pathlib.Path(__file__).resolve()
WORLD_TIMEOUT_S = 180
COMPRESS_F_REL = 1e-5      # compressed merges, port against JAX, relative f
LAM1, LAM2 = 0.02, 1e-3
STEPS = 8                  # supersteps of the fixed-count fits
PATH_KW = dict(n_lambdas=5, lam_ratio=0.1, max_outer=60, tol=1e-4)
CV_KW = dict(n_folds=3, n_lambdas=4, lam_ratio=0.1, max_outer=60, tol=1e-4)
FIT22 = [(k, c) for k in ("dense", "block") for c in ("gs", "jacobi")]


# ---------------------------------------------------------------------------
# the problems (numpy only: both packages get the same bytes)
# ---------------------------------------------------------------------------

def multiproc_problem(design):
    """tests/progs/multiproc_glm.py's problem (n=192, p=96, seed 7)."""
    n, p = 192, 96
    rng = np.random.default_rng(7)
    if design == "dense":
        X = rng.normal(size=(n, p)).astype(np.float32)
    else:
        mask = rng.random((n, p)) < 0.15
        X = np.where(mask, rng.normal(size=(n, p)), 0.0).astype(np.float32)
    beta = np.zeros((p,), np.float32)
    beta[: p // 6] = rng.normal(size=p // 6).astype(np.float32)
    y = (X @ beta + 0.05 * rng.normal(size=n)).astype(np.float32)
    return X, y


def logistic_problem(kind, n=200, p=90, seed=3):
    """A logistic problem whose n and p pad on a (2, 2) mesh (rows to
    2 x 32, features to 2 x 16)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    if kind == "block":
        X = np.where(rng.random((n, p)) < 0.2, X, 0.0).astype(np.float32)
    X[:, 7] = 0.0                                  # a dead column
    beta = np.zeros((p,), np.float32)
    beta[: p // 6] = rng.normal(size=p // 6).astype(np.float32)
    m = X @ beta + 0.5 * rng.normal(size=n)
    y = np.where(m > 0, 1.0, -1.0).astype(np.float32)
    return X, y


def as_input(pkg_sparse, X, kind):
    if kind != "block":
        return X
    r, c = np.nonzero(X)
    return pkg_sparse.SparseCOO(rows=r.astype(np.int32),
                                cols=c.astype(np.int32),
                                vals=X[r, c].astype(np.float32),
                                shape=X.shape)


def run_record(solver, res):
    """What a fit reports, as JSON-able lists."""
    h = res.history
    return {"beta_user": np.asarray(res.beta, np.float64).tolist(),
            "f": [float(v) for v in h["f"]],
            "alpha": [float(v) for v in h["alpha"]],
            "nnz": [int(v) for v in h["nnz"]], "n_iter": int(res.n_iter)}


# ---------------------------------------------------------------------------
# the port's worlds (worker mode)
# ---------------------------------------------------------------------------

def _port_cases_w2(out_dir: pathlib.Path, rank: int):
    """(1, 2): parity, ALB, compression, psum_compressed, checkpoints."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.core.solver import GLMSolver
    from repro_torch.data import sparse, synthetic
    from repro_torch.dist import bootstrap
    from repro_torch.sharding.compress import psum_compressed

    mesh = bootstrap.make_dist_mesh(1, 2)
    R = {}
    for design in ("dense", "block"):
        X, y = multiproc_problem(design)
        cfg = DGLMNETConfig(tile_size=16, max_outer=12, tol=0.0)
        s = GLMSolver(as_input(sparse, X, design), y, config=cfg, mesh=mesh,
                      row_block=32, device="cpu")
        res = s.fit(lam1=0.02, lam2=1e-3)
        rec = run_record(s, res)
        rec["beta_packed"] = s._host_beta(s._state.beta).tolist()
        R[f"parity/{design}"] = rec
    X, y = multiproc_problem("dense")
    base = DGLMNETConfig(tile_size=16, max_outer=STEPS, tol=0.0)
    # ALB: speeds [1, 0.25], seed 0, budgets recorded every superstep
    import dataclasses
    s = GLMSolver(X, y, config=dataclasses.replace(base, alb=True),
                  mesh=mesh, speeds=[1.0, 0.25], seed=0, device="cpu")
    budgets, orig = [], s._budgets

    def recorded():
        b = orig()
        budgets.append(s._budgets_host.tolist())
        return b

    s._budgets = recorded
    rec = run_record(s, s.fit(lam1=LAM1, lam2=LAM2))
    rec["budgets"] = budgets
    R["alb"] = rec
    for mode in ("bf16", "int8"):
        s = GLMSolver(X, y, config=dataclasses.replace(
            base, compress_margin=mode, max_outer=12), mesh=mesh,
            device="cpu")
        R[f"compress/{mode}"] = run_record(s, s.fit(lam1=LAM1, lam2=LAM2))
    # psum_compressed over the model group: this rank's shard of xs
    xs = psum_inputs()
    g = mesh.get_group("model")
    for name, x in xs.items():
        mine = torch.from_numpy(x[rank].copy())
        for mode in (None, "bf16", "int8"):
            out = psum_compressed(mine, g, mode)
            R[f"psum/{name}/{mode}"] = out.numpy().astype(np.float64).tolist()
    # checkpoints: a dense fit cut at 4 supersteps (saves at 2 and 4), a
    # brick fit's checkpoint, and the elastic source (12 supersteps of
    # tests/progs/dist_ckpt.py's problem on (1, 2))
    s = GLMSolver(X, y, config=DGLMNETConfig(tile_size=16, max_outer=12,
                                             tol=0.0), mesh=mesh,
                  row_block=32, device="cpu")
    s.fit(lam1=0.02, lam2=1e-3, max_outer=4,
          ckpt_manager=CheckpointManager(out_dir / "ckpt_dense"),
          ckpt_every=2)
    Xb, yb = multiproc_problem("block")
    s = GLMSolver(as_input(sparse, Xb, "block"), yb,
                  config=DGLMNETConfig(tile_size=16, max_outer=4, tol=0.0),
                  mesh=mesh, row_block=32, device="cpu")
    s.fit(lam1=0.02, lam2=1e-3, ckpt_manager=CheckpointManager(
        out_dir / "ckpt_block"), ckpt_every=2)
    ds = synthetic.make_dense(n=400, p=64, seed=11)
    ecfg = DGLMNETConfig(lam1=0.5, lam2=0.5, tile_size=16, max_outer=12,
                         tol=1e-13)
    s = GLMSolver(ds.train.X, ds.train.y, config=ecfg, mesh=mesh,
                  device="cpu")
    res = s.fit(ckpt_manager=CheckpointManager(out_dir / "ckpt_elastic",
                                               keep_last=2), ckpt_every=4)
    R["elastic/partial_f"] = res.history["f"][-1]
    return R


def psum_inputs():
    """Per-shard inputs of psum_compressed (2 shards): random, one shard
    far below the other, and an all-zero pair."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(2, 257)).astype(np.float32)
    b = a.copy()
    b[1] *= 1e-3
    return {"random": a, "skewed": b,
            "zeros": np.zeros((2, 64), np.float32)}


def _port_cases_w4(out_dir: pathlib.Path, rank: int):
    """(2, 2): fits, paths, CV, standardize, fit_sharded, an estimator."""
    import dataclasses
    import warnings

    from repro_torch.core import dglmnet
    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.core.solver import GLMSolver
    from repro_torch.data import design as tdesign
    from repro_torch.data import sparse
    from repro_torch.dist import bootstrap
    from repro_torch.glm import LogisticRegressionCD

    mesh = bootstrap.make_dist_mesh(2, 2)
    R = {}
    for kind, coup in FIT22:
        X, y = logistic_problem(kind)
        cfg = DGLMNETConfig(tile_size=16, max_outer=STEPS, tol=0.0,
                            coupling="gauss-seidel" if coup == "gs"
                            else "jacobi")
        s = GLMSolver(as_input(sparse, X, kind), y, config=cfg, mesh=mesh,
                      row_block=32, device="cpu")
        rec = run_record(s, s.fit(lam1=LAM1, lam2=LAM2))
        rec["beta_packed"] = s._host_beta(s._state.beta).tolist()
        rec["launch_stats"] = dict(s.launch_stats)
        R[f"fit/{kind}/{coup}"] = rec
    for kind in ("dense", "block"):
        X, y = logistic_problem(kind)
        cfg = DGLMNETConfig(tile_size=16)
        s = GLMSolver(as_input(sparse, X, kind), y, config=cfg, mesh=mesh,
                      row_block=32, device="cpu")
        p = s.fit_path(**PATH_KW)
        R[f"path/{kind}"] = {
            "lambdas": p.lambdas.tolist(), "betas": p.betas.tolist(),
            "f": p.f.tolist(), "nnz": p.nnz.tolist(),
            "n_iters": p.n_iters.tolist(),
            "converged": p.converged.tolist(),
            "launch_stats": dict(s.launch_stats)}
        s = GLMSolver(as_input(sparse, X, kind), y, config=cfg, mesh=mesh,
                      row_block=32, device="cpu")
        cv = s.fit_cv(**CV_KW)
        R[f"cv/{kind}"] = {"dev_mean": cv.dev_mean.tolist(),
                           "best_index": int(cv.best_index),
                           "beta": cv.beta.tolist(),
                           "lambdas": cv.lambdas.tolist()}
    X, y = logistic_problem("dense")
    cfg = DGLMNETConfig(tile_size=16, max_outer=STEPS, tol=0.0)
    s = GLMSolver(X, y, config=cfg, mesh=mesh, standardize=True,
                  fit_intercept=True, device="cpu")
    rec = run_record(s, s.fit(lam1=LAM1, lam2=LAM2))
    rec["intercept"] = s.intercept_
    rec["margins"] = s.training_margins().tolist()
    R["std"] = rec
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res = dglmnet.fit_sharded(X, y, dataclasses.replace(
            cfg, lam1=LAM1, lam2=LAM2), mesh, device="cpu")
    R["fit_sharded"] = {"beta_user": res.beta.tolist(),
                        "alpha": res.history["alpha"]}
    est = LogisticRegressionCD(lam1=LAM1, mesh=mesh, tile_size=16,
                               max_outer=STEPS, tol=0.0, device="cpu")
    est.fit(X, y)
    R["estimator"] = {"coef": est.coef_.tolist(),
                      "intercept": float(est.intercept_)}
    # layouts a mesh refuses
    refused = {}
    sd = tdesign.streaming_design(X, 16, chunk_rows=64, device="cpu")[0]
    for name, bad in (("streaming", sd),
                      ("single_device_design",
                       tdesign.dense_design(X, 16, device="cpu")[0])):
        try:
            GLMSolver(bad, y, config=cfg, mesh=mesh, device="cpu",
                      design_info=tdesign.DesignInfo(shape=X.shape))
            refused[name] = None
        except ValueError as e:
            refused[name] = str(e)
    R["refused"] = refused
    return R


def _port_cases_w2b(out_dir: pathlib.Path, rank: int, src: pathlib.Path,
                    jax_ckpt: pathlib.Path):
    """Restarts in fresh processes: the port's and JAX's checkpoints, the
    elastic resume onto (2, 1), a brick checkpoint onto (2, 1)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.core.solver import GLMSolver
    from repro_torch.data import sparse, synthetic
    from repro_torch.dist import bootstrap

    mesh12 = bootstrap.make_dist_mesh(1, 2)
    mesh21 = bootstrap.make_dist_mesh(2, 1)
    R = {}
    X, y = multiproc_problem("dense")
    cfg = DGLMNETConfig(tile_size=16, max_outer=12, tol=0.0)
    for tag, d in (("port", src / "ckpt_dense"), ("jax", jax_ckpt)):
        s = GLMSolver(X, y, config=cfg, mesh=mesh12, row_block=32,
                      device="cpu")
        res = s.fit(lam1=0.02, lam2=1e-3, ckpt_manager=CheckpointManager(d),
                    ckpt_every=2)
        R[f"restart/{tag}"] = {
            "beta_packed": s._host_beta(s._state.beta).tolist(),
            "n_iter": int(res.n_iter), "f": res.history["f"]}
    ds = synthetic.make_dense(n=400, p=64, seed=11)
    ecfg = DGLMNETConfig(lam1=0.5, lam2=0.5, tile_size=16, max_outer=60,
                         tol=1e-13)
    s = GLMSolver(ds.train.X, ds.train.y, config=ecfg, mesh=mesh21,
                  device="cpu")
    res = s.fit(ckpt_manager=CheckpointManager(src / "ckpt_elastic",
                                               keep_last=2), ckpt_every=50)
    R["elastic"] = {"f": res.history["f"], "n_hist": len(res.history["f"])}
    Xb, yb = multiproc_problem("block")
    s = GLMSolver(as_input(sparse, Xb, "block"), yb,
                  config=DGLMNETConfig(tile_size=16, max_outer=8, tol=0.0),
                  mesh=mesh21, row_block=32, device="cpu")
    try:
        s.fit(lam1=0.02, lam2=1e-3,
              ckpt_manager=CheckpointManager(src / "ckpt_block"))
        R["brick_other_mesh"] = None
    except ValueError as e:
        R["brick_other_mesh"] = str(e)
    return R


def _worker_main(argv) -> int:
    import argparse

    import torch

    from repro_torch.dist import bootstrap, faults
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--src", default="")
    ap.add_argument("--jax-ckpt", default="")
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    ctx = bootstrap.initialize(backend="gloo", device="cpu")
    out = pathlib.Path(a.out)
    t0 = time.perf_counter()
    if a.worker == "W2":
        R = _port_cases_w2(out, ctx.process_id)
    elif a.worker == "W4":
        R = _port_cases_w4(out, ctx.process_id)
    else:
        R = _port_cases_w2b(out, ctx.process_id, pathlib.Path(a.src),
                            pathlib.Path(a.jax_ckpt))
    R["seconds"] = time.perf_counter() - t0
    (out / f"rank{ctx.process_id}.json").write_text(json.dumps(R))
    faults.guarded_barrier("sharded-test-exit")
    bootstrap.shutdown()
    return 0


# ---------------------------------------------------------------------------
# JAX's side (reference mode, fake devices)
# ---------------------------------------------------------------------------

def _jax_ref(out: str) -> int:
    import dataclasses
    import warnings

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.core import dglmnet, prox_ref
    from repro.core.dglmnet import DGLMNETConfig
    from repro.core.solver import GLMSolver
    from repro.data import sparse, synthetic
    from repro.glm import LogisticRegressionCD
    from repro.sharding import compat
    from repro.sharding.compress import psum_compressed

    devs = np.array(jax.devices())
    mesh22 = Mesh(devs[:4].reshape(2, 2), ("data", "model"))
    mesh12 = Mesh(devs[:2].reshape(1, 2), ("data", "model"))
    R = {}
    X, y = multiproc_problem("dense")
    base = DGLMNETConfig(tile_size=16, max_outer=STEPS, tol=0.0)
    s = GLMSolver(X, y, config=dataclasses.replace(base, alb=True),
                  mesh=mesh12, speeds=[1.0, 0.25], seed=0)
    budgets, orig = [], s._budgets

    def recorded():
        b = orig()
        budgets.append(s._budgets_host.tolist())
        return b

    s._budgets = recorded
    rec = run_record(s, s.fit(lam1=LAM1, lam2=LAM2))
    rec["budgets"] = budgets
    R["alb"] = rec
    for mode in ("bf16", "int8"):
        s = GLMSolver(X, y, config=dataclasses.replace(
            base, compress_margin=mode, max_outer=12), mesh=mesh12)
        R[f"compress/{mode}"] = run_record(s, s.fit(lam1=LAM1, lam2=LAM2))
    for name, x in psum_inputs().items():
        for mode in (None, "bf16", "int8"):
            fn = jax.jit(compat.shard_map(
                lambda v, _m=mode: psum_compressed(v[0], "model", _m)[None],
                mesh=mesh12, in_specs=P("model"), out_specs=P("model")))
            xs = jax.device_put(jnp.asarray(x),
                                NamedSharding(mesh12, P("model")))
            R[f"psum/{name}/{mode}"] = np.asarray(
                fn(xs), np.float64).tolist()
    for kind, coup in FIT22:
        Xk, yk = logistic_problem(kind)
        cfg = DGLMNETConfig(tile_size=16, max_outer=STEPS, tol=0.0,
                            coupling="gauss-seidel" if coup == "gs"
                            else "jacobi")
        s = GLMSolver(as_input(sparse, Xk, kind), yk, config=cfg,
                      mesh=mesh22, row_block=32)
        rec = run_record(s, s.fit(lam1=LAM1, lam2=LAM2))
        rec["beta_packed"] = np.asarray(s._host(s._state.beta),
                                        np.float64).tolist()
        rec["launch_stats"] = dict(s.launch_stats)
        R[f"fit/{kind}/{coup}"] = rec
    for kind in ("dense", "block"):
        Xk, yk = logistic_problem(kind)
        cfg = DGLMNETConfig(tile_size=16)
        s = GLMSolver(as_input(sparse, Xk, kind), yk, config=cfg,
                      mesh=mesh22, row_block=32)
        p = s.fit_path(**PATH_KW)
        R[f"path/{kind}"] = {
            "lambdas": p.lambdas.tolist(),
            "betas": np.asarray(p.betas, np.float64).tolist(),
            "f": p.f.tolist(), "nnz": p.nnz.tolist(),
            "n_iters": p.n_iters.tolist(),
            "converged": p.converged.tolist(),
            "launch_stats": dict(s.launch_stats)}
        s = GLMSolver(as_input(sparse, Xk, kind), yk, config=cfg,
                      mesh=mesh22, row_block=32)
        cv = s.fit_cv(**CV_KW)
        R[f"cv/{kind}"] = {"dev_mean": cv.dev_mean.tolist(),
                           "best_index": int(cv.best_index),
                           "beta": np.asarray(cv.beta, np.float64).tolist(),
                           "lambdas": cv.lambdas.tolist()}
    Xk, yk = logistic_problem("dense")
    cfg = DGLMNETConfig(tile_size=16, max_outer=STEPS, tol=0.0)
    s = GLMSolver(Xk, yk, config=cfg, mesh=mesh22, standardize=True,
                  fit_intercept=True)
    rec = run_record(s, s.fit(lam1=LAM1, lam2=LAM2))
    rec["intercept"] = s.intercept_
    rec["margins"] = np.asarray(s.training_margins(), np.float64).tolist()
    R["std"] = rec
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res = dglmnet.fit_sharded(Xk, yk, dataclasses.replace(
            cfg, lam1=LAM1, lam2=LAM2), mesh22)
    R["fit_sharded"] = {"beta_user": np.asarray(res.beta,
                                                np.float64).tolist(),
                        "alpha": [float(a) for a in res.history["alpha"]]}
    est = LogisticRegressionCD(lam1=LAM1, mesh=mesh22, tile_size=16,
                               max_outer=STEPS, tol=0.0)
    est.fit(Xk, yk)
    R["estimator"] = {"coef": np.asarray(est.coef_, np.float64).tolist(),
                      "intercept": float(est.intercept_)}
    ds = synthetic.make_dense(n=400, p=64, seed=11)
    _, hist = prox_ref.fit_fista(ds.train.X, ds.train.y, lam1=0.5, lam2=0.5,
                                 max_iter=4000)
    R["f_star"] = float(hist[-1])
    pathlib.Path(out).write_text(json.dumps(R))
    return 0


def _jax_resume(ckpt: str, out: str) -> int:
    """JAX resumes its (1, 2) dense fit from the port's checkpoint."""
    import jax
    from jax.sharding import Mesh

    from repro.checkpoint import CheckpointManager
    from repro.core.dglmnet import DGLMNETConfig
    from repro.core.solver import GLMSolver

    mesh12 = Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                  ("data", "model"))
    X, y = multiproc_problem("dense")
    s = GLMSolver(X, y, config=DGLMNETConfig(tile_size=16, max_outer=12,
                                             tol=0.0),
                  mesh=mesh12, row_block=32)
    res = s.fit(lam1=0.02, lam2=1e-3, ckpt_manager=CheckpointManager(ckpt),
                ckpt_every=100)
    pathlib.Path(out).write_text(json.dumps({
        "beta_packed": np.asarray(s._host(s._state.beta),
                                  np.float64).tolist(),
        "n_iter": int(res.n_iter), "n_hist": len(res.history["f"])}))
    return 0


# ---------------------------------------------------------------------------
# the session: every world and every JAX run, once
# ---------------------------------------------------------------------------

def _jax_env(devices: int) -> dict:
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = str(SRC)
    env.pop("REPRO_DIST_PROCID", None)
    return env


def _popen(args, devices: int, log: pathlib.Path):
    fh = open(log, "w")
    return subprocess.Popen([sys.executable, *map(str, args)], stdout=fh,
                            stderr=subprocess.STDOUT, env=_jax_env(devices)), \
        fh


def _wait(proc_fh, log, timeout=WORLD_TIMEOUT_S):
    proc, fh = proc_fh
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    fh.close()
    assert rc == 0, f"{log.name}: exit {rc}\n{log.read_text()[-4000:]}"


def _port_world(n, worker, out: pathlib.Path, *extra):
    from repro_torch.dist import launcher
    out.mkdir(parents=True, exist_ok=True)
    res = launcher.run_local(n, THIS, args=["--worker", worker, "--out",
                                            str(out), *extra],
                             timeout_s=WORLD_TIMEOUT_S, grace_s=5)
    assert res.ok, res.summary()
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(n)]
    return ranks, res.seconds


@pytest.fixture(scope="session")
def runs(tmp_path_factory):
    from repro.dist import launcher as jlauncher
    root = tmp_path_factory.mktemp("sharded")
    jobs = {
        "jax_ref": _popen([THIS, "--jax-ref", root / "jax_ref.json"], 4,
                          root / "jax_ref.log"),
        **{f"single_{d}": _popen(
            [PROG, "--mode", "single", "--design", d, "--steps", 12,
             "--out", root / f"single_{d}.json"], 2,
            root / f"single_{d}.log") for d in ("dense", "block")}}
    jres = jlauncher.run_local(2, PROG, args=[
        "--mode", "ckpt-a", "--design", "dense", "--steps", 12, "--out",
        root / "jax_ckpt_a.json", "--ckpt-dir", root / "jax_ckpt"],
        timeout_s=WORLD_TIMEOUT_S)
    assert jres.ok, jres.summary()
    w2, w2_s = _port_world(2, "W2", root / "w2")
    resume = _popen([THIS, "--jax-resume", root / "w2" / "ckpt_dense",
                     root / "jax_resume.json"], 2, root / "jax_resume.log")
    w4, w4_s = _port_world(4, "W4", root / "w4")
    w2b, w2b_s = _port_world(2, "W2b", root / "w2b", "--src", root / "w2",
                             "--jax-ckpt", root / "jax_ckpt")
    for name, job in {**jobs, "jax_resume": resume}.items():
        _wait(job, root / f"{name}.log")
    out = {"w2": w2, "w4": w4, "w2b": w2b,
           "seconds": {"w2": w2_s, "w4": w4_s, "w2b": w2b_s},
           "jax": json.loads((root / "jax_ref.json").read_text()),
           "jax_resume": json.loads((root / "jax_resume.json").read_text()),
           "root": root}
    for d in ("dense", "block"):
        out[f"single_{d}"] = json.loads(
            (root / f"single_{d}.json").read_text())
    return out


def _max_abs(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("design", ["dense", "block"])
def test_two_process_parity_with_single_process_jax(runs, design):
    """(1, 2): the port's 2-process fit against multiproc_glm.py --mode
    single (JAX, 2 fake devices), packed and user beta within 1e-5."""
    ref = runs[f"single_{design}"]
    got = runs["w2"][0][f"parity/{design}"]
    assert _max_abs(got["beta_packed"], ref["beta_packed"]) <= 1e-5
    assert _max_abs(got["beta_user"], ref["beta_user"]) <= 1e-5
    assert got["n_iter"] == ref["n_iter"] == 12
    assert abs(got["f"][-1] - ref["f"]) <= 1e-5 * abs(ref["f"])


@pytest.mark.parametrize("kind,coup", FIT22)
def test_mesh22_fit_matches_jax(runs, kind, coup):
    """(2, 2) Gauss-Seidel and Jacobi, dense and bricks: the same alpha at
    every superstep, beta within 1e-5, padded coordinates exactly 0."""
    got = runs["w4"][0][f"fit/{kind}/{coup}"]
    ref = runs["jax"][f"fit/{kind}/{coup}"]
    assert got["alpha"] == ref["alpha"]
    assert got["n_iter"] == ref["n_iter"] == STEPS
    assert _max_abs(got["beta_packed"], ref["beta_packed"]) <= 1e-5
    assert _max_abs(got["beta_user"], ref["beta_user"]) <= 1e-5
    np.testing.assert_allclose(got["f"], ref["f"], rtol=1e-5)
    assert got["nnz"] == ref["nnz"]
    packed = np.asarray(got["beta_packed"])
    assert np.count_nonzero(packed) == np.count_nonzero(got["beta_user"])
    assert np.asarray(got["beta_user"])[7] == 0.0          # dead column
    assert got["launch_stats"] == ref["launch_stats"]


def test_mesh22_padding_is_exactly_zero(runs):
    """Dense (2, 2): features pad from 90 to 96 (M T = 32); the six
    padding coordinates stay exactly 0 in every fit."""
    for coup in ("gs", "jacobi"):
        packed = np.asarray(runs["w4"][0][f"fit/dense/{coup}"]
                            ["beta_packed"])
        assert packed.shape == (96,)
        assert np.all(packed[90:] == 0.0)


def test_alb_budgets_match_jax(runs):
    """Speeds [1, 0.25] on (1, 2) with seed 0: the same budget vector at
    every superstep as JAX's (the same default_rng stream), the same
    alphas, beta within 1e-5."""
    got, ref = runs["w2"][0]["alb"], runs["jax"]["alb"]
    assert got["budgets"] == ref["budgets"]
    assert len(got["budgets"]) == STEPS
    assert any(b[0] != b[1] for b in got["budgets"])    # ALB was active
    assert got["alpha"] == ref["alpha"]
    assert _max_abs(got["beta_user"], ref["beta_user"]) <= 1e-5


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compressed_merge_matches_jax(runs, mode):
    """bf16 and int8 margin merges on (1, 2): the same alphas as JAX's, f
    within COMPRESS_F_REL (1e-5; measured 1.6e-7 bf16, 5.4e-7 int8) of
    JAX's at every superstep and beta within 1e-5 (the reference's own
    bar is 50 x 2e-3 |f*| against the optimum), and both descend."""
    got, ref = runs["w2"][0][f"compress/{mode}"], runs["jax"][
        f"compress/{mode}"]
    np.testing.assert_allclose(got["f"], ref["f"], rtol=COMPRESS_F_REL)
    assert got["alpha"] == ref["alpha"]
    assert all(b <= a + 1e-6 * abs(a) for a, b in zip(got["f"],
                                                      got["f"][1:]))
    assert _max_abs(got["beta_user"], ref["beta_user"]) <= 1e-5
    # lossy merges move the fit, but not far from the exact merge's
    exact = runs["w2"][0]["alb"]["f"][-1]
    assert abs(got["f"][STEPS - 1] - exact) <= 100 * 2e-3 * abs(exact)


@pytest.mark.parametrize("name", ["random", "skewed", "zeros"])
@pytest.mark.parametrize("mode", ["None", "bf16", "int8"])
def test_psum_compressed_matches_jax(runs, name, mode):
    """psum_compressed over 2 shards against JAX's under shard_map: None
    exact and equal, bf16 equal, int8 equal and within M amax / 254 of
    the exact sum; all-zero shards give 0."""
    x = psum_inputs()[name]
    exact = x.astype(np.float64).sum(axis=0)
    for r in range(2):
        got = np.asarray(runs["w2"][r][f"psum/{name}/{mode}"])
        ref = np.asarray(runs["jax"][f"psum/{name}/{mode}"]).reshape(2, -1)
        np.testing.assert_array_equal(got, ref[r])
        if mode == "None":
            np.testing.assert_array_equal(
                got, (x[0] + x[1]).astype(np.float32))
        if mode == "int8":
            amax = np.abs(x).max()
            assert np.max(np.abs(got - exact)) <= 2 * amax / 254 + 1e-7
        if name == "zeros":
            assert not got.any()


@pytest.mark.parametrize("kind", ["dense", "block"])
def test_mesh22_path_matches_jax(runs, kind):
    """fit_path with screening on (2, 2): the same grid, f and nnz per
    lambda, beta within 1e-5, the same supersteps."""
    got, ref = runs["w4"][0][f"path/{kind}"], runs["jax"][f"path/{kind}"]
    np.testing.assert_allclose(got["lambdas"], ref["lambdas"], rtol=1e-6)
    np.testing.assert_allclose(got["f"], ref["f"], rtol=1e-5)
    assert _max_abs(got["betas"], ref["betas"]) <= 1e-5
    assert got["nnz"] == ref["nnz"]
    assert got["n_iters"] == ref["n_iters"]
    assert all(got["converged"])
    assert got["launch_stats"] == ref["launch_stats"]


@pytest.mark.parametrize("kind", ["dense", "block"])
def test_mesh22_cv_matches_jax(runs, kind):
    """fit_cv on (2, 2): the fold deviances, the selection and its beta."""
    got, ref = runs["w4"][0][f"cv/{kind}"], runs["jax"][f"cv/{kind}"]
    np.testing.assert_allclose(got["lambdas"], ref["lambdas"], rtol=1e-6)
    np.testing.assert_allclose(got["dev_mean"], ref["dev_mean"], rtol=1e-5)
    assert got["best_index"] == ref["best_index"]
    assert _max_abs(got["beta"], ref["beta"]) <= 1e-5


def test_mesh22_standardize_matches_jax(runs):
    """standardize=True with an intercept on (2, 2) (the dense layout
    centers): beta on the original scale, the intercept and the training
    margins."""
    got, ref = runs["w4"][0]["std"], runs["jax"]["std"]
    assert got["alpha"] == ref["alpha"]
    assert _max_abs(got["beta_user"], ref["beta_user"]) <= 1e-5
    assert abs(got["intercept"] - ref["intercept"]) <= 1e-5
    assert _max_abs(got["margins"], ref["margins"]) <= 1e-4


def test_fit_sharded_and_estimator_match_jax(runs):
    """The deprecated dglmnet.fit_sharded and LogisticRegressionCD(mesh=)
    on (2, 2) against JAX's."""
    got, ref = runs["w4"][0], runs["jax"]
    assert got["fit_sharded"]["alpha"] == ref["fit_sharded"]["alpha"]
    assert _max_abs(got["fit_sharded"]["beta_user"],
                    ref["fit_sharded"]["beta_user"]) <= 1e-5
    assert _max_abs(got["estimator"]["coef"], ref["estimator"]["coef"]) \
        <= 1e-5
    assert abs(got["estimator"]["intercept"]
               - ref["estimator"]["intercept"]) <= 1e-5


@pytest.mark.parametrize("name", ["streaming", "single_device_design"])
def test_mesh_refuses_unshardable_layouts(runs, name):
    """A StreamingDesign (as the reference) and a single-device design
    raise ValueError on a mesh."""
    msg = runs["w4"][0]["refused"][name]
    assert msg is not None
    assert ("StreamingDesign" in msg) if name == "streaming" \
        else ("single-device" in msg)


@pytest.mark.parametrize("world", ["w2", "w4"])
def test_ranks_agree_at_every_superstep(runs, world):
    """Every rank reports the same (f, alpha, nnz, n_iter) at every
    superstep of every fit, bit for bit."""
    ranks = runs[world]
    keys = [k for k, v in ranks[0].items()
            if isinstance(v, dict) and "alpha" in v and "f" in v]
    assert keys
    for k in keys:
        for r in ranks[1:]:
            for field in ("f", "alpha", "nnz", "n_iter"):
                if field in ranks[0][k]:
                    assert r[k][field] == ranks[0][k][field], (k, field)


def test_two_process_checkpoint_restart(runs):
    """A fresh pair of processes resumes the dense (1, 2) fit cut at
    superstep 4: beta within 1e-5 of the uninterrupted run, the same
    n_iter, and only supersteps 5-12 run."""
    full = runs["w2"][0]["parity/dense"]
    got = runs["w2b"][0]["restart/port"]
    assert _max_abs(got["beta_packed"], full["beta_packed"]) <= 1e-5
    assert got["n_iter"] == full["n_iter"] == 12
    assert len(got["f"]) == 8


def test_jax_two_process_checkpoint_is_read_by_the_port(runs):
    """JAX's 2-process checkpoint (multiproc_glm.py --mode ckpt-a) resumed
    by the port's 2-process world: within 1e-5 of the full fit."""
    full = runs["single_dense"]
    got = runs["w2b"][0]["restart/jax"]
    assert _max_abs(got["beta_packed"], full["beta_packed"]) <= 1e-5
    assert got["n_iter"] == full["n_iter"]


def test_port_checkpoint_is_read_by_jax(runs):
    """JAX (1, 2) resumes from the port's 2-process checkpoint."""
    full = runs["single_dense"]
    got = runs["jax_resume"]
    assert got["n_hist"] == 8
    assert _max_abs(got["beta_packed"], full["beta_packed"]) <= 1e-5
    assert got["n_iter"] == full["n_iter"]


def test_checkpoint_files_are_the_coordinators(runs):
    """Only the coordinator wrote: one shard file a checkpoint, the
    keep_last (3) newest kept of the cut run's saves (2, 4) and the
    restart's (6 to 12)."""
    d = runs["root"] / "w2" / "ckpt_dense"
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("ckpt_*"))
    assert steps == [8, 10, 12]
    for st in steps:
        assert sorted(p.name for p in (d / f"ckpt_{st}").iterdir()) == \
            ["manifest.json", "shard_0.npz"]


def test_elastic_resume_onto_another_mesh(runs):
    """A dense fit saved on (1, 2) after 12 supersteps resumes on (2, 1)
    and reaches f <= f* + 2e-3 |f*| (FISTA's optimum, JAX)."""
    f_star = runs["jax"]["f_star"]
    e = runs["w2b"][0]["elastic"]
    partial = runs["w2"][0]["elastic/partial_f"]
    assert e["n_hist"] <= 60 - 12
    assert e["f"][0] <= partial + 1e-4 * abs(partial)
    assert e["f"][-1] <= f_star + 2e-3 * abs(f_star)


def test_brick_checkpoint_onto_another_mesh_raises(runs):
    msg = runs["w2b"][0]["brick_other_mesh"]
    assert msg is not None and "layout" in msg


def test_synthetic_data_is_the_references():
    """The elastic case's data comes from each package's synthetic
    module: the same bytes."""
    from repro.data import synthetic as js
    from repro_torch.data import synthetic as ts
    a, b = js.make_dense(n=400, p=64, seed=11), ts.make_dense(n=400, p=64,
                                                              seed=11)
    np.testing.assert_array_equal(np.asarray(a.train.X), b.train.X)
    np.testing.assert_array_equal(np.asarray(a.train.y), b.train.y)


def test_worlds_ran_under_their_timeout(runs):
    for name, s in runs["seconds"].items():
        assert s < WORLD_TIMEOUT_S, (name, s)


if __name__ == "__main__":
    if "--jax-ref" in sys.argv:
        sys.exit(_jax_ref(sys.argv[sys.argv.index("--jax-ref") + 1]))
    if "--jax-resume" in sys.argv:
        i = sys.argv.index("--jax-resume")
        sys.exit(_jax_resume(sys.argv[i + 1], sys.argv[i + 2]))
    sys.exit(_worker_main(sys.argv[1:]))
