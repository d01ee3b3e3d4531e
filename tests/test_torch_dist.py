"""repro_torch.dist against repro.dist: the numpy parts bit for bit, and
the multi-process runtime in worlds of CPU processes (gloo).

  * units against JAX's modules on the same inputs: ``core/alb``
    (budgets, sanitizing, both pivots, the speeds stream of a seed),
    ``FaultPlan`` (parse, factor, ``work_s``, ``work_phases``), the
    telemetry EMA (speeds, compute and effective speeds, phase breakdown,
    rejected keys), ``column_process_map`` and ``local_columns`` over the
    same rank grids, ``worker_env``;
  * the bootstrap's single-process contract, and NCCL refused where it
    cannot give each rank a card (the error names ``backend="gloo"``);
  * the launcher: a worker that hangs is killed at the job's timeout,
    one that fails takes its peers down after ``grace_s``;
  * a barrier world (this file as its worker): a tag mismatch raises
    ``BarrierTagMismatch``, the KV store round-trips, a dead peer raises
    ``DeadProcessError``;
  * ``python -m repro_torch.launch.dist_run`` in 2-process worlds: under
    ``--faults "1:4.0" --telemetry`` the same budgets as JAX's
    ``repro.launch.dist_run`` with the same arguments (process 1
    down-budgeted after warm-up, every superstep's vector the same on
    both ranks), a network-slow node under ``--phase-aware`` kept at full
    budget as in JAX, the trace shards of both processes merged into one
    file with two pid lanes; ``--data FILE --nprocs 2`` equal to
    ``--nprocs 1`` within 1e-6 on f and beta.
Every world runs under a timeout.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from repro.core import alb as jalb
from repro.dist import bootstrap as jboot
from repro.dist import faults as jfaults
from repro.dist.telemetry import SuperstepTelemetry as JTelemetry
from repro_torch.core import alb as talb
from repro_torch.dist import bootstrap as tboot
from repro_torch.dist import faults as tfaults
from repro_torch.dist import launcher as tlauncher
from repro_torch.dist.telemetry import SuperstepTelemetry as TTelemetry

REPO = pathlib.Path(__file__).resolve().parents[1]
SRC = REPO / "src"
THIS = pathlib.Path(__file__).resolve()
WORLD_TIMEOUT_S = 180
DEMO = ["--tile", "64", "--steps", "8", "--tile-cost-s", "0.002",
        "--telemetry"]


# ---------------------------------------------------------------- ALB units

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("rule", ["lower", "completion"])
def test_alb_budgets_bit_for_bit(seed, rule):
    """Sampled speeds from one seed, then the budgets of both rules: the
    same stream and the same vectors."""
    base = np.asarray([1.0, 0.25, 2.0, 1.0, 0.5], np.float32)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(6):
        sj, st = jalb.sample_speeds(rj, base), talb.sample_speeds(rt, base)
        np.testing.assert_array_equal(sj, st)
        for nt in (1, 4, 33):
            bj = jalb.alb_budgets(sj, nt, 0.75, jalb.max_budget(nt),
                                  pivot_rule=rule)
            bt = talb.alb_budgets(st, nt, 0.75, talb.max_budget(nt),
                                  pivot_rule=rule)
            assert bj.dtype == bt.dtype
            np.testing.assert_array_equal(bj, bt)


@pytest.mark.parametrize("speeds", [[np.nan, 0.0, -3.0, 2.0, 4.0],
                                    [np.nan, -1.0, 0.0], [1.0, np.inf],
                                    [4.0, 1.0]])
def test_alb_sanitize_bit_for_bit(speeds):
    s = np.asarray(speeds)
    np.testing.assert_array_equal(jalb.sanitize_speeds(s),
                                  talb.sanitize_speeds(s))
    np.testing.assert_array_equal(
        jalb.alb_budgets(s, 8, 0.5, sanitize=True, pivot_rule="completion"),
        talb.alb_budgets(s, 8, 0.5, sanitize=True, pivot_rule="completion"))


def test_alb_rejects_bad_speeds_without_sanitize():
    with pytest.raises(ValueError):
        talb.alb_budgets(np.array([1.0, np.nan]), 8, 0.5)
    np.testing.assert_array_equal(
        talb.alb_budgets(np.array([4.0, 1.0]), 8, 0.5,
                         pivot_rule="completion"), [8, 2])


# ------------------------------------------------------------ fault plans

SPECS = ["1:4.0", "0:2.0,1:4.0@10-20", "1:4.0/network", "0:3.0/io,1:2.0",
         "1:2.0@0-3,1:3.0@2-5", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_matches_jax(spec):
    pj = jfaults.FaultPlan.parse(spec, 2, tile_cost_s=0.01)
    pt = tfaults.FaultPlan.parse(spec, 2, tile_cost_s=0.01)
    assert pj.slowdown == pt.slowdown and pj.slow_phase == pt.slow_phase
    assert [dataclass_tuple(w) for w in pj.stutters] == \
        [dataclass_tuple(w) for w in pt.stutters]
    for pid in range(2):
        for step in (0, 2, 4, 12, 25):
            assert pj.factor(pid, step) == pt.factor(pid, step)
            assert pj.work_s(pid, step, 7) == pt.work_s(pid, step, 7)
            assert pj.work_phases(pid, step, 7) == \
                pt.work_phases(pid, step, 7)
    assert pj.max_factor(15) == pt.max_factor(15)


def dataclass_tuple(w):
    return (w.pid, w.start, w.stop, w.factor)


@pytest.mark.parametrize("bad", [dict(slowdown=(0.5, 1.0)),
                                 dict(slowdown=(2.0,)),
                                 dict(slow_phase=("sweep", "disk"))])
def test_fault_plan_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        jfaults.FaultPlan(num_processes=2, **bad)
    with pytest.raises(ValueError):
        tfaults.FaultPlan(num_processes=2, **bad)


def test_fault_parse_rejects_unknown_process():
    with pytest.raises(ValueError):
        tfaults.FaultPlan.parse("3:2.0", 2)


# -------------------------------------------------------------- telemetry

def _samples(seed):
    rng = np.random.default_rng(seed)
    out = []
    for step in range(7):
        tiles = rng.integers(0, 9, size=3).astype(np.float64)
        secs = rng.uniform(0.0, 2.0, size=3)
        if step == 2:
            secs[1] = 0.0                       # an invalid sample
        phases = [{"sweep": float(s) * 0.7, "line_search": float(s) * 0.3}
                  for s in secs]
        phases[2] = {"sweep": 0.1, "network": float(secs[2])}
        if step == 4:
            phases[0]["bogus_phase"] = 1.0      # rejected by both
        out.append((step, tiles, secs, phases))
    return out


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("phase_aware", [False, True])
def test_telemetry_ema_matches_jax(seed, phase_aware):
    tj = JTelemetry(3, ema=0.5, warmup=2, phase_aware=phase_aware)
    tt = TTelemetry(3, ema=0.5, warmup=2, phase_aware=phase_aware)
    for step, tiles, secs, phases in _samples(seed):
        tj.record_all(step, tiles, secs, phases=phases)
        tt.record_all(step, tiles, secs, phases=phases)
        for name in ("speeds", "compute_speeds", "effective_speeds"):
            a, b = getattr(tj, name)(), getattr(tt, name)()
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a, b)
    bj, bt = tj.phase_breakdown(), tt.phase_breakdown()
    assert sorted(bj) == sorted(bt)
    for k in bj:
        np.testing.assert_array_equal(bj[k], bt[k])
    assert tj.rejected_phase_keys == tt.rejected_phase_keys == 1


def test_telemetry_single_process_record_skips_exchange():
    tel = TTelemetry(1, warmup=1)
    tel.record(0, tiles=6, seconds=2.0)
    assert tel.speeds()[0] == pytest.approx(3.0)


# ---------------------------------------------------- bootstrap bookkeeping

class _JDev:
    def __init__(self, pid):
        self.process_index = pid


class _JMesh:
    """The attributes JAX's bookkeeping reads off a mesh."""

    def __init__(self, procs, names):
        self.axis_names = names
        self.devices = np.vectorize(_JDev, otypes=[object])(procs)


class _TMesh:
    """The attributes the port's bookkeeping reads off a DeviceMesh."""

    def __init__(self, procs, names):
        import torch
        self.mesh = torch.as_tensor(procs)
        self.mesh_dim_names = names


GRIDS = [np.arange(4).reshape(2, 2), np.arange(2).reshape(1, 2),
         np.arange(6).reshape(3, 2), np.array([[0, 0], [1, 1]]),
         np.array([[0, 1], [0, 1]])]


@pytest.mark.parametrize("grid", range(len(GRIDS)))
@pytest.mark.parametrize("names", [("data", "model"), ("model", "data")])
def test_column_bookkeeping_matches_jax(grid, names):
    procs = GRIDS[grid]
    jm, tm = _JMesh(procs, names), _TMesh(procs, names)
    np.testing.assert_array_equal(jboot.column_process_map(jm),
                                  tboot.column_process_map(tm))
    assert jboot.is_multiprocess_mesh(jm) == tboot.is_multiprocess_mesh(tm)
    # this process is process 0 in both (no world in the test process)
    assert tboot.context().process_id == 0
    assert jboot.local_columns(jm) == tboot.local_columns(tm)


def test_worker_env_round_trip():
    env = tlauncher.worker_env(1, 2, "127.0.0.1:1234")
    assert env["REPRO_DIST_PROCID"] == "1"
    assert env["REPRO_DIST_NPROCS"] == "2"
    assert env["REPRO_DIST_COORD"] == "127.0.0.1:1234"
    assert env["PYTHONPATH"].split(os.pathsep)[0] == str(SRC)


def test_single_process_context_and_barrier():
    ctx = tboot.context()
    assert ctx.process_id == 0 and ctx.num_processes == 1
    assert ctx.is_coordinator and not ctx.multiprocess
    tboot.barrier("unit")                   # a no-op without a world
    tfaults.guarded_barrier("unit")
    x = np.arange(5, dtype=np.float32)
    np.testing.assert_array_equal(tboot.gather_to_host(x), x)
    np.testing.assert_array_equal(tboot.broadcast_host(x), x)


def test_nccl_is_refused_without_a_card_per_rank(monkeypatch):
    """backend=None is NCCL for the card's tensors; a CPU rank (or a torch
    without NCCL) cannot have it, and the error names backend='gloo'.
    Nothing falls back to gloo on its own."""
    monkeypatch.delenv("REPRO_DIST_COORD", raising=False)
    with pytest.raises((RuntimeError, ValueError), match="backend='gloo'"):
        tboot.initialize(coordinator="127.0.0.1:1", num_processes=2,
                         process_id=0, device="cpu")
    assert tboot.context().coordinator is None


# ------------------------------------------------- sharded designs (units)

def _coo_pair(seed, n=300, p=70):
    from repro.data import sparse as js
    from repro_torch.data import sparse as ts
    rng = np.random.default_rng(seed)
    X = np.where(rng.random((n, p)) < 0.1, rng.normal(size=(n, p)),
                 0.0).astype(np.float32)
    X[:, 5] = 0.0
    r, c = np.nonzero(X)
    args = (r.astype(np.int32), c.astype(np.int32), X[r, c], X.shape)
    return js.SparseCOO(*args), ts.SparseCOO(*args)


@pytest.mark.parametrize("D,M", [(1, 1), (1, 2), (2, 2), (2, 1), (3, 2)])
@pytest.mark.parametrize("reorder", [True, False])
def test_sharded_bricks_bit_for_bit(D, M, reorder):
    """build_block_sparse_sharded: every shard's bricks, row and tile ids
    and CSR offsets (padded to the common B as the reference stacks them),
    K, the local shape and the DesignInfo equal JAX's; a rank that builds
    only its own shard gets the same one."""
    from repro.data import design as jd
    from repro_torch.data import design as td
    jcoo, tcoo = _coo_pair(D * 10 + M)
    kw = dict(D=D, M=M, tile_size=16, row_block=32, reorder=reorder)
    jdes, jinfo = jd.build_block_sparse_sharded(jcoo, **kw)
    tdes, tinfo = td.build_block_sparse_sharded(tcoo, **kw, device="cpu")
    st = tdes.stacked()
    for k in ("bricks", "brick_row", "brick_tile", "tile_ptr"):
        np.testing.assert_array_equal(np.asarray(getattr(jdes, k)), st[k])
    assert jdes.max_bricks_per_tile == tdes.max_bricks_per_tile
    assert tuple(jdes.shape) == tdes.shape
    np.testing.assert_array_equal(jinfo.col_of_feature, tinfo.col_of_feature)
    assert (jinfo.occupancy, jinfo.n_bricks, jinfo.shape) == \
        (tinfo.occupancy, tinfo.n_bricks, tinfo.shape)
    own, _ = td.build_block_sparse_sharded(tcoo, **kw, device="cpu",
                                           shards=[(D - 1, M - 1)])
    a, b = own.shard(D - 1, M - 1), tdes.shard(D - 1, M - 1)
    assert list(own.shards) == [(D - 1, M - 1)]
    assert (own.n_bricks, own.max_bricks_per_tile) == (tdes.n_bricks,
                                                       tdes.max_bricks_per_tile)
    assert bool((a.bricks == b.bricks).all())
    np.testing.assert_array_equal(a.tile_ptr, b.tile_ptr)
    assert jd.brick_occupancy(jcoo, 16, row_block=32, reorder=reorder) == \
        td.brick_occupancy(tcoo, 16, row_block=32, reorder=reorder)


@pytest.mark.parametrize("n_rows,chunk,nprocs", [(1000, 64, 2), (1000, 64, 3),
                                                 (130, 64, 2), (640, 64, 4)])
def test_process_slice_matches_jax(n_rows, chunk, nprocs):
    """StreamingDesign.process_slice: each process's chunk range, row
    slice and chunks equal the reference's."""
    from repro.data import design as jd
    from repro_torch.data import design as td
    X = np.random.default_rng(1).normal(size=(n_rows, 20)).astype(np.float32)
    jsd, _ = jd.streaming_design(X, 16, chunk_rows=chunk)
    tsd, _ = td.streaming_design(X, 16, chunk_rows=chunk, device="cpu")
    for pid in range(nprocs):
        jl, jrows = jsd.process_slice(pid, nprocs)
        tl, trows = tsd.process_slice(pid, nprocs)
        assert jrows == trows
        assert (jl.n_chunks, jl.n_rows_data) == (tl.n_chunks, tl.n_rows_data)
        jc = [np.asarray(c) for _, c in jl.iter_chunks()]
        tc = [c.numpy() for _, c in tl.iter_chunks()]
        for a, b in zip(jc, tc):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tsd.process_slice(0, tsd.n_chunks + 1)


# ------------------------------------------------------------- the launcher

def test_run_local_kills_a_hung_job(tmp_path):
    script = tmp_path / "hang.py"
    script.write_text("import time\ntime.sleep(60)\n")
    t0 = time.monotonic()
    res = tlauncher.run_local(2, script, timeout_s=2)
    assert time.monotonic() - t0 < 20
    assert res.timed_out and not res.ok


def test_run_local_fails_the_job_of_a_dead_worker(tmp_path):
    script = tmp_path / "one_dies.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['REPRO_DIST_PROCID'] == '1':\n"
        "    print('dying'); sys.exit(3)\n"
        "time.sleep(60)\n")
    res = tlauncher.run_local(2, script, timeout_s=60, grace_s=1)
    assert not res.ok and not res.timed_out
    assert res.returncodes[1] == 3 and res.returncodes[0] != 0
    assert "dying" in res.outputs[1] and res.seconds < 30


# --------------------------------------------------------- worlds: barriers

def _barrier_worker(out: pathlib.Path) -> int:
    """Process 0 and 1 reach one barrier slot with different tags; then the
    KV store; then process 1 leaves and process 0's guarded barrier must
    report a dead peer."""
    from repro_torch.dist import bootstrap, faults
    ctx = bootstrap.initialize(backend="gloo", device="cpu", timeout_s=30)
    pid = ctx.process_id
    R = {}
    try:
        bootstrap.barrier("a" if pid == 0 else "b", timeout_s=3)
        R["mismatch"] = None
    except bootstrap.BarrierTagMismatch as e:
        R["mismatch"] = "mismatch"
        R["mismatch_msg"] = str(e)
    except Exception as e:          # process 0 waits for its peer in vain
        R["mismatch"] = type(e).__name__
    bootstrap.kv_set(f"unit/{pid}", f"value-{pid}")
    R["kv"] = bootstrap.kv_get(f"unit/{1 - pid}", timeout_s=10)
    faults.guarded_barrier("after-kv", timeout_s=10)
    if pid == 1:
        (out / "rank1.json").write_text(json.dumps(R))
        return 0
    time.sleep(0.5)
    try:
        faults.guarded_barrier("peer-gone", timeout_s=3)
        R["dead"] = None
    except faults.DeadProcessError as e:
        R["dead"] = str(e)
    (out / "rank0.json").write_text(json.dumps(R))
    return 0


def test_barrier_world(tmp_path):
    res = tlauncher.run_local(2, THIS, args=["--barrier-worker",
                                             str(tmp_path)],
                              timeout_s=WORLD_TIMEOUT_S, grace_s=30)
    assert res.ok, res.summary()
    r0 = json.loads((tmp_path / "rank0.json").read_text())
    r1 = json.loads((tmp_path / "rank1.json").read_text())
    # process 1 compares with process 0's tag and raises at once
    assert r1["mismatch"] == "mismatch" and "'a'" in r1["mismatch_msg"]
    assert r0["mismatch"] is not None
    assert r0["kv"] == "value-1" and r1["kv"] == "value-0"
    assert r0["dead"] is not None and "peer-gone" in r0["dead"]


# -------------------------------------------------------- worlds: dist_run

def _dist_run(args, log: pathlib.Path, module="repro_torch.launch.dist_run",
              xla=False):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("REPRO_DIST_PROCID", None)
    env.pop("REPRO_TRACE", None)
    if xla:
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    fh = open(log, "w")
    return subprocess.Popen([sys.executable, "-m", module, *args],
                            stdout=fh, stderr=subprocess.STDOUT, env=env,
                            cwd=str(REPO)), fh, log


def _finish(job):
    proc, fh, log = job
    try:
        rc = proc.wait(timeout=WORLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    fh.close()
    text = log.read_text()
    assert rc == 0, f"{log.name}: exit {rc}\n{text[-4000:]}"
    rows = [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]
    assert rows, text[-4000:]
    return rows


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    """Every dist_run world of this module, started together."""
    from repro_torch.io import write_libsvm
    root = tmp_path_factory.mktemp("dist_run")
    port = ["--backend", "gloo", "--device", "cpu", "--timeout",
            str(WORLD_TIMEOUT_S)]
    rng = np.random.default_rng(2)
    X = np.where(rng.random((600, 40)) < 0.3, rng.normal(size=(600, 40)),
                 0.0).astype(np.float32)
    y = np.where(X[:, :5].sum(1) + 0.3 * rng.normal(size=600) > 0, 1.0,
                 -1.0).astype(np.float32)
    data = root / "train.svm"
    write_libsvm(data, X, y)
    stream = ["--data", str(data), "--chunk-rows", "64", "--tile", "16",
              "--steps", "6", "--lam1", "0.5", "--tol", "0"]
    np.save(root / "X.npy", X)
    np.save(root / "y.npy", y)
    npy = ["--data", str(root / "X.npy"), "--labels", str(root / "y.npy"),
           "--chunk-rows", "64", "--tile", "16", "--steps", "6", "--lam1",
           "0.5", "--tol", "0"]
    jobs = {
        "faults": _dist_run(["--nprocs", "2", *DEMO, "--faults", "1:4.0",
                             "--trace", str(root / "trace"), *port],
                            root / "faults.log"),
        "network": _dist_run(["--nprocs", "2", *DEMO, "--faults",
                              "1:4.0/network", "--phase-aware", *port],
                             root / "network.log"),
        "stream2": _dist_run(["--nprocs", "2", *stream, *port],
                             root / "stream2.log"),
        "stream1": _dist_run(["--nprocs", "1", *stream, *port],
                             root / "stream1.log"),
        "npy2": _dist_run(["--nprocs", "2", *npy, *port], root / "npy2.log"),
        "npy1": _dist_run(["--nprocs", "1", *npy, *port], root / "npy1.log"),
        "jax_faults": _dist_run(["--nprocs", "2", *DEMO, "--faults",
                                 "1:4.0"], root / "jax_faults.log",
                                module="repro.launch.dist_run", xla=True),
        "jax_network": _dist_run(["--nprocs", "2", *DEMO, "--faults",
                                  "1:4.0/network", "--phase-aware"],
                                 root / "jax_network.log",
                                 module="repro.launch.dist_run", xla=True),
    }
    out = {name: _finish(job) for name, job in jobs.items()}
    out["root"] = root
    return out


def test_fault_plan_budgets_match_jax_dist_run(dist_runs):
    """--faults "1:4.0" --telemetry: the seconds are the plan's, so the
    budgets are deterministic; JAX's dist_run prints the same vector, and
    process 1 is down-budgeted after the warm-up supersteps."""
    got = dist_runs["faults"][0]
    ref = dist_runs["jax_faults"][0]
    assert got["budgets"] == ref["budgets"]
    nt = 256 // 64 // 2
    assert got["budget_history"][:2] == [[nt, nt], [nt, nt]]  # warm-up
    assert got["budgets"][1] < got["budgets"][0]
    assert got["n_iter"] == ref["n_iter"] == 8
    assert abs(got["f"] - ref["f"]) <= 1e-5 * abs(ref["f"])
    assert got["speeds"][0] / got["speeds"][1] == pytest.approx(4.0)
    assert got["budgets_agree"]


def test_phase_aware_keeps_a_network_slow_node(dist_runs):
    """--faults "1:4.0/network" --phase-aware: the excess is network
    time, so process 1 keeps its full budget, as in JAX's dist_run."""
    got = dist_runs["network"][0]
    ref = dist_runs["jax_network"][0]
    assert got["budgets"] == ref["budgets"]
    assert got["budgets"][0] == got["budgets"][1]


def test_trace_shards_of_both_processes_merge(dist_runs):
    """Each process wrote its own trace shard and convergence stream;
    the parent merged the shards into one file with both pid lanes."""
    from repro_torch.obs import trace as obs_trace
    d = dist_runs["root"] / "trace"
    assert sorted(p.name for p in d.glob("trace_[0-9]*.json")) == \
        ["trace_0.json", "trace_1.json"]
    assert sorted(p.name for p in d.glob("convergence_*.jsonl")) == \
        ["convergence_0.jsonl", "convergence_1.jsonl"]
    merged = json.loads((d / "trace_merged.json").read_text())
    evs = merged["traceEvents"]
    assert {e["pid"] for e in evs if e.get("ph") == "M"} == {0, 1}
    for pid in (0, 1):
        names = [e["name"] for e in evs
                 if e["pid"] == pid and e.get("ph") == "B"]
        assert names.count("solver/superstep") == 8
        assert names.count("solver/fault_sleep") == 8
        assert "dist/all_reduce" in names
        lines = (d / f"convergence_{pid}.jsonl").read_text().splitlines()
        assert len(lines) == 8
    assert obs_trace.merge_dir(d) is not None


@pytest.mark.parametrize("source", ["stream", "npy"])
def test_streaming_two_processes_equal_one(dist_runs, source):
    """--data FILE (libsvm text, or a memory-mapped .npy): 2 processes
    over their chunk ranges, the statistics and candidate losses
    all-reduced, equal the 1-process fit within 1e-6 on f and beta."""
    two, one = dist_runs[f"{source}2"][0], dist_runs[f"{source}1"][0]
    assert two["num_processes"] == 2 and one["num_processes"] == 1
    assert two["supersteps"] == one["supersteps"] == 6
    np.testing.assert_allclose(two["f"], one["f"], rtol=1e-6)
    assert np.max(np.abs(np.asarray(two["beta"])
                         - np.asarray(one["beta"]))) <= 1e-6
    assert two["chunks_local"] == 5 and one["chunks_local"] == 10


if __name__ == "__main__":
    sys.exit(_barrier_worker(pathlib.Path(sys.argv[-1])))
