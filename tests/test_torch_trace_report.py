"""repro_torch.launch.trace_report: the reference's ``TestTraceReport``
cases (``tests/test_obs.py``) against the port's CLI, and the files read
across the packages.

A directory written by the port (its tracer's shards, its metrics
snapshot, its convergence stream) summarizes the same through the
reference's ``trace_report.summarize`` as through the port's, and a
directory the reference wrote reads the same through the port's.  The
report of a traced CPU fit counts its spans and events; ``--bench``
writes only where it is told; the module runs as ``python -m`` without
jax.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch import trace_report as jreport
from repro.obs import convergence as jconv
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.dglmnet import DGLMNETConfig
from repro_torch.core.solver import GLMSolver
from repro_torch.launch import trace_report
from repro_torch.obs import convergence as conv
from repro_torch.obs import metrics
from repro_torch.obs import trace

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracers_off():
    yield
    trace.disable()
    jtrace.disable()


PACKAGES = {"port": (trace.Tracer, conv.ConvergenceStream,
                     metrics.MetricsRegistry, {"profiler_annotations": False}),
            "jax": (jtrace.Tracer, jconv.ConvergenceStream,
                    jmetrics.MetricsRegistry, {"jax_annotations": False})}


def _populate(tmp_path, writer="port"):
    """Two pid lanes of one fabricated ``solver/superstep`` span each (1 ms
    and 4 ms), one convergence event with phase_us, one counter."""
    Tracer, Stream, Registry, kw = PACKAGES[writer]
    for pid, dur in ((0, 1_000), (1, 4_000)):
        tr = Tracer(tmp_path, pid=pid, **kw)
        tr.span("solver/superstep").__enter__()
        ph, ts, tid, name, _ = tr._events[0]
        tr._events.append(("E", ts + dur * 1000, tid, name, None))
        tr.save()
    with Stream(tmp_path / "convergence_0.jsonl") as s:
        s.emit(step=0, f=2.0, nnz=1, supersteps=1, step_us=900.0,
               phase_us={"sweep": 700.0, "line_search": 200.0})
    r = Registry()
    r.counter("io.chunk_cache.hit").inc(3)
    r.save(tmp_path / "metrics_0.json")


class TestTraceReport:
    def test_summarize_and_bench_row(self, tmp_path):
        _populate(tmp_path)
        s = trace_report.summarize(tmp_path)
        assert s["n_spans"] == 2
        [row] = s["spans"]
        assert row["span"] == "solver/superstep" and row["count"] == 2
        assert row["total_ms"] == pytest.approx(5.0, rel=0.01)
        attrib = s["phase_attribution"]
        assert attrib["0"]["compute"] == pytest.approx(1_000.0)
        assert attrib["1"]["compute"] == pytest.approx(4_000.0)
        assert attrib["0"]["solver.sweep"] == pytest.approx(700.0)
        assert s["metrics"]["counters"]["io.chunk_cache.hit"] == 3.0
        assert s["convergence"]["n_events"] == 1
        assert s["convergence"]["final_f"] == 2.0
        bench = trace_report.bench_row(s)
        assert bench["figure"] == "obs"
        [brow] = bench["rows"]
        assert brow["top_span"] == "solver/superstep"
        assert brow["conv_events"] == 1
        assert 0.0 <= brow["disabled_span_overhead_us"] < 5.0

    def test_cli_writes_outputs(self, tmp_path, capsys):
        _populate(tmp_path)
        out_json = tmp_path / "summary.json"
        out_bench = tmp_path / "obs.json"
        rc = trace_report.main([str(tmp_path), "--json", str(out_json),
                                "--bench", str(out_bench)])
        assert rc == 0
        assert "solver/superstep" in capsys.readouterr().out
        assert json.loads(out_json.read_text())["n_spans"] == 2
        assert json.loads(out_bench.read_text())["figure"] == "obs"

    def test_cli_rejects_a_missing_directory(self, tmp_path, capsys):
        assert trace_report.main([str(tmp_path / "nope")]) == 2
        assert "not a directory" in capsys.readouterr().err

    def test_empty_directory_summarizes_to_nothing(self, tmp_path):
        s = trace_report.summarize(tmp_path)
        assert s["n_spans"] == 0 and s["spans"] == []
        assert s["metrics"] is None and s["convergence"] is None

    def test_merged_shard_is_read_when_alone(self, tmp_path):
        _populate(tmp_path)
        trace.merge_dir(tmp_path)
        for p in tmp_path.glob("trace_[0-9]*.json"):
            p.unlink()
        assert trace_report.summarize(tmp_path)["n_spans"] == 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_directories_read_across_packages(tmp_path, writer):
    """Whichever package wrote the directory, both reports agree on it
    (the disabled-span figure aside, a measurement of each reader)."""
    _populate(tmp_path, writer)
    a = trace_report.summarize(tmp_path)
    b = jreport.summarize(tmp_path)
    assert a == b
    ra, rb = trace_report.bench_row(a), jreport.bench_row(b)
    for r in (ra, rb):
        r["rows"][0].pop("disabled_span_overhead_us")
    assert ra == rb


def test_report_of_a_traced_fit(tmp_path):
    """A traced CPU fit with checkpoints and a resume: the spans, the
    stream and the metrics shard, summarized by both packages."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 16)).astype(np.float32)
    y = np.where(rng.random(64) < 0.5, -1.0, 1.0).astype(np.float32)
    tr = trace.enable(tmp_path)
    s = GLMSolver(X, y, config=DGLMNETConfig(tile_size=8), device="cpu")
    mgr = CheckpointManager(tmp_path / "ckpt")
    s.fit(lam1=0.05, max_outer=4, tol=0.0, ckpt_manager=mgr, ckpt_every=2)
    s.fit(lam1=0.05, max_outer=6, tol=0.0,
          ckpt_manager=CheckpointManager(tmp_path / "ckpt"), ckpt_every=2)
    s._conv.close()
    tr.save()
    metrics.save_default(tmp_path)
    trace.disable()
    for summarize in (trace_report.summarize, jreport.summarize):
        rep = summarize(tmp_path)
        counts = {r["span"]: r["count"] for r in rep["spans"]}
        assert counts == {"solver/superstep": 6, "ckpt/save": 3,
                          "ckpt/commit": 3, "ckpt/restore": 1}
        assert rep["convergence"]["n_events"] == 6
        assert rep["convergence"]["supersteps"] == 6
        pid = str(tr.pid)
        assert rep["phase_attribution"][pid]["checkpoint"] > 0
        assert rep["phase_attribution"][pid]["compute"] > 0


def test_bench_writes_only_where_told(tmp_path):
    _populate(tmp_path)
    run = tmp_path / "cwd"
    run.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    code = ("import sys\n"
            "from repro_torch.launch import trace_report\n"
            f"rc = trace_report.main([{str(tmp_path)!r}])\n"
            "assert rc == 0\n"
            "assert not any(m == 'jax' or m.startswith('jax.') or "
            "m == 'repro' or m.startswith('repro.') for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=run, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "solver/superstep" in out.stdout
    assert list(run.iterdir()) == []
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["convergence_0.jsonl", "cwd", "metrics_0.json", "trace_0.json",
         "trace_1.json"]


def test_runs_as_a_module(tmp_path):
    _populate(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.trace_report",
         str(tmp_path), "--json", str(tmp_path / "s.json")],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "== trace report" in out.stdout
    assert json.loads((tmp_path / "s.json").read_text())["n_spans"] == 2
