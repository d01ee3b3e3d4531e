"""repro_torch.obs against the contracts of the reference's
``tests/test_obs.py`` and against the JAX package itself, on the CPU.

The tracer (Chrome round trip, balanced export, ``elapsed_us``, a tid lane
a thread, the disabled span under 5 µs a call by its median, ``merge_dir``,
enable and disable, the ``REPRO_TRACE`` environment contract), its
``record_function`` ranges in a ``torch.profiler`` trace, the metrics
registry (merge associative and commutative, gauge order, histogram grids,
quantiles) and the convergence schema, key for key the reference's.

Across the packages: a stream either writes reads back through the
other's ``read_events``; the reference's tiny fit (48 x 24, tile 8, 5
supersteps at ``tol=0``) gives equal counters in both streams and f, loss,
alpha and mu within 1e-5; a screened path gives equal ``lam_index``,
``screened`` and ``kkt_violations``.  The port's ``launch_trace`` holds the
logical launches of the reference's audit superstep (fused and unfused
Jacobi) and one event a dispatcher call on a Gauss-Seidel superstep.
Then the hooks: checkpoint spans, the chunk cache's counters against the
reference's on the same accesses, prefetch spans on the worker's lane,
the serving counters and flush spans.

Each test that enables a tracer does so on its own ``tmp_path`` and the
``_tracers_off`` fixture disables both packages' tracers after it, so no
shard is written at exit.
"""
import collections
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.analysis import audit as jaudit
from repro.core.dglmnet import DGLMNETConfig as JConfig
from repro.core.solver import GLMSolver as JSolver
from repro.io.libsvm import LibsvmReader as JReader
from repro.kernels import ops as jops
from repro.obs import convergence as jconv
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import dglmnet as tdglmnet
from repro_torch.core.dglmnet import DGLMNETConfig as TConfig
from repro_torch.core.solver import GLMSolver as TSolver
from repro_torch.data import design as tdesign
from repro_torch.data import sparse as tsparse
from repro_torch.data import synthetic as tsynth
from repro_torch.io.libsvm import LibsvmReader, write_libsvm
from repro_torch.io.prefetch import PrefetchingSource
from repro_torch.kernels import ops
from repro_torch.obs import convergence as conv
from repro_torch.obs import metrics
from repro_torch.obs import trace
from repro_torch.serve import MicroBatcher, ScoringEngine, ServableModel
from repro_torch.timing import percentiles

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small problems: torch's intra-op threads buy nothing here and,
    beside the other test workers, spin on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracers_off():
    yield
    trace.disable()
    jtrace.disable()


def _tiny(seed=0):
    """The reference's tiny fit data (``tests/test_obs.py``)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(48, 24)).astype(np.float32)
    y = (X @ (rng.normal(size=24) * (rng.random(24) < 0.3))
         + 0.05 * rng.normal(size=48)).astype(np.float32)
    return X, y


def _counter(snap, name):
    return snap["counters"].get(name, 0.0)


# -------------------------------------------------------------------- trace

class TestTrace:
    @pytest.mark.parametrize("annotations", [False, True])
    def test_round_trip_chrome_format(self, tmp_path, annotations):
        tr = trace.Tracer(tmp_path, pid=7, profiler_annotations=annotations)
        with tr.span("outer", args={"k": 1}):
            with tr.span("inner"):
                pass
        tr.instant("mark")
        path = tr.save()
        assert path == tmp_path / "trace_7.json"
        evs = json.loads(path.read_text())["traceEvents"]
        for e in evs:
            assert {"ph", "pid", "tid", "name"} <= set(e)
            if e["ph"] != "M":
                assert isinstance(e["ts"], float)
            assert e["pid"] == 7
        assert [e["name"] for e in evs if e["ph"] == "B"] == \
            ["outer", "inner"]
        assert sum(1 for e in evs if e["ph"] == "E") == 2
        assert sum(1 for e in evs if e["ph"] == "i") == 1
        body = [e for e in evs if e["ph"] in "BE"]
        assert [e["ph"] for e in body] == ["B", "B", "E", "E"]
        ts = [e["ts"] for e in body]
        assert ts == sorted(ts)
        b = next(e for e in evs if e["ph"] == "B" and e["name"] == "outer")
        assert b["args"] == {"k": 1}

    def test_export_balances_open_and_orphaned_spans(self):
        tr = trace.Tracer(pid=1, capacity=4, profiler_annotations=False)
        sp = tr.span("open")
        sp.__enter__()              # never exited
        per_tid = {}
        for e in tr.export()["traceEvents"]:
            if e["ph"] in "BE":
                per_tid.setdefault(e["tid"], []).append(e["ph"])
        for phs in per_tid.values():
            assert phs.count("B") == phs.count("E")
        tr2 = trace.Tracer(pid=1, capacity=2, profiler_annotations=False)
        for i in range(4):          # 4 B + 4 E through a 2-slot ring
            with tr2.span(f"s{i}"):
                pass
        evs2 = [e for e in tr2.export()["traceEvents"] if e["ph"] in "BE"]
        assert sum(e["ph"] == "B" for e in evs2) == \
            sum(e["ph"] == "E" for e in evs2)

    def test_span_elapsed_us(self):
        tr = trace.Tracer()
        with tr.span("t") as sp:
            time.sleep(0.01)
        assert 8_000 <= sp.elapsed_us <= 500_000

    def test_threads_get_distinct_tid_lanes(self):
        tr = trace.Tracer(pid=0)

        def work():
            with tr.span("worker"):
                pass

        t = threading.Thread(target=work, name="io-thread")
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with tr.span("main"):
            pass
        evs = tr.export()["traceEvents"]
        assert len({e["tid"] for e in evs if e["ph"] == "B"}) == 2
        names = {e["args"]["name"] for e in evs
                 if e["ph"] == "M" and e["name"] == "thread_name"}
        assert "io-thread" in names

    def test_disabled_span_overhead_under_5us(self):
        trace.disable()
        samples = []
        for _ in range(1000):
            t0 = time.perf_counter_ns()
            with trace.span("hot/loop"):
                pass
            samples.append((time.perf_counter_ns() - t0) / 1e3)
        p50 = percentiles(samples)["p50"]
        assert p50 < 5.0, f"disabled span p50 {p50:.2f}µs >= 5µs"
        assert trace.span("a") is trace.span("b")

    def test_disabled_span_reads_no_clock(self, monkeypatch):
        """The disabled path is the cached null span: no clock read, no
        profiler range, no NVTX call."""
        trace.disable()

        def boom(*a, **k):
            raise AssertionError("the disabled path touched it")

        monkeypatch.setattr(trace.time, "perf_counter_ns", boom)
        monkeypatch.setattr(torch.profiler, "record_function", boom)
        with trace.span("x") as sp:
            pass
        assert sp.elapsed_us == 0.0
        trace.instant("y")

    def test_merge_dir_keeps_all_pid_lanes(self, tmp_path):
        for pid in (0, 1):
            tr = trace.Tracer(tmp_path, pid=pid)
            with tr.span("step"):
                pass
            tr.save()
        merged_path = trace.merge_dir(tmp_path)
        assert merged_path == tmp_path / "trace_merged.json"
        evs = json.loads(merged_path.read_text())["traceEvents"]
        assert {e["pid"] for e in evs if e["ph"] == "M"} == {0, 1}
        assert evs[0]["ph"] == "M"
        again = json.loads(trace.merge_dir(tmp_path).read_text())
        assert len(again["traceEvents"]) == len(evs)
        assert trace.merge_dir(tmp_path / "empty") is None

    def test_enable_disable_module_tracer(self, tmp_path):
        tr = trace.enable(tmp_path)
        assert trace.get_tracer() is tr and tr.enabled
        assert trace.trace_dir() == tmp_path
        with trace.span("on"):
            pass
        assert tr.export()["traceEvents"]
        trace.disable()
        assert not trace.get_tracer().enabled
        assert trace.trace_dir() is None

    def test_traced_decorator_resolves_at_call_time(self):
        @trace.traced("ckpt/test")
        def f(a):
            return a + 1

        assert f(1) == 2 and f.__wrapped__(1) == 2
        tr = trace.enable()
        assert f(2) == 3
        assert [e["name"] for e in tr.export()["traceEvents"]
                if e["ph"] == "B"] == ["ckpt/test"]

    def test_nvtx_only_with_a_cuda_device(self):
        tr = trace.Tracer()
        assert (tr._nvtx is not None) == torch.cuda.is_available()
        assert tr._record_function is torch.profiler.record_function
        off = trace.Tracer(profiler_annotations=False)
        assert off._nvtx is None and off._record_function is None

    def test_spans_are_profiler_ranges(self):
        """Each enabled span is a ``record_function`` range: a
        ``torch.profiler`` trace shows it, nested as the spans are."""
        from torch.profiler import ProfilerActivity, profile

        tr = trace.enable()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("solver/superstep"):
                with trace.span("inner/part"):
                    torch.ones(8).sum()
        names = [e.name for e in prof.events()]
        assert names.count("solver/superstep") == 1
        assert names.count("inner/part") == 1
        outer = next(e for e in prof.events()
                     if e.name == "solver/superstep")
        inner = next(e for e in prof.events() if e.name == "inner/part")
        assert outer.time_range.start <= inner.time_range.start
        assert inner.time_range.end <= outer.time_range.end
        assert len([e for e in tr.export()["traceEvents"]
                    if e["ph"] == "B"]) == 2

    def test_env_contract_writes_shards_at_exit(self, tmp_path):
        """``REPRO_TRACE=dir`` enables at import, ``REPRO_DIST_PROCID``
        names the lane, and the atexit hook writes ``trace_<pid>.json``
        and ``metrics_<pid>.json``; jax stays out of the process."""
        code = ("import sys\n"
                "from repro_torch.obs import metrics, trace\n"
                "assert trace.get_tracer().enabled\n"
                "with trace.span('env/span'):\n"
                "    metrics.counter('env.count').inc()\n"
                "assert not any(m == 'jax' or m.startswith('jax.') or "
                "m == 'repro' or m.startswith('repro.') "
                "for m in sys.modules)\n")
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   REPRO_TRACE=str(tmp_path), REPRO_DIST_PROCID="3")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, env=env,
                             timeout=300)
        assert out.returncode == 0, out.stderr
        evs = json.loads((tmp_path / "trace_3.json").read_text())
        assert [e["name"] for e in evs["traceEvents"] if e["ph"] == "B"] \
            == ["env/span"]
        snap = json.loads((tmp_path / "metrics_3.json").read_text())
        assert snap["counters"]["env.count"] == 1.0


# ------------------------------------------------------------------ metrics

def _snap(counter_v, gauge_pairs, hist_obs):
    r = metrics.MetricsRegistry()
    r.counter("c").inc(counter_v)
    for v in gauge_pairs:
        r.gauge("g").set(v)
    h = r.histogram("h", buckets=(1.0, 10.0, 100.0))
    for v in hist_obs:
        h.observe(v)
    return r.snapshot()


class TestMetrics:
    def test_merge_is_associative_and_commutative(self):
        a = _snap(1, [3.0], [0.5, 20.0])
        b = _snap(2, [7.0], [5.0])
        c = _snap(4, [1.0], [200.0, 0.1])
        left = metrics.merge(metrics.merge(a, b), c)
        right = metrics.merge(a, metrics.merge(b, c))
        assert left == right
        assert metrics.merge(a, b) == metrics.merge(b, a)
        assert left["counters"]["c"] == 7.0
        assert left["histograms"]["h"]["n"] == 5
        assert left == metrics.merge_all([a, b, c])

    def test_gauge_merge_keeps_latest_seq(self):
        a = _snap(0, [5.0], [])
        b = _snap(0, [9.0], [])
        assert metrics.merge(a, b)["gauges"]["g"]["value"] == 9.0
        assert metrics.merge(b, a)["gauges"]["g"]["value"] == 9.0

    def test_histogram_bucket_mismatch_raises(self):
        r1 = metrics.MetricsRegistry()
        r1.histogram("h", buckets=(1.0, 2.0)).observe(0.5)
        r2 = metrics.MetricsRegistry()
        r2.histogram("h", buckets=(1.0, 3.0)).observe(0.5)
        with pytest.raises(ValueError):
            metrics.merge(r1.snapshot(), r2.snapshot())
        with pytest.raises(ValueError):
            r1.histogram("h", buckets=(1.0, 3.0))
        with pytest.raises(ValueError):
            metrics.Histogram(buckets=(2.0, 1.0))

    def test_histogram_quantile_and_snapshot_quantile_agree(self):
        h = metrics.Histogram(buckets=(1.0, 10.0, 100.0))
        for v in (0.5, 2.0, 3.0, 50.0):
            h.observe(v)
        snap = {"buckets": list(h.buckets), "counts": list(h.counts),
                "sum": h.sum, "n": h.n}
        for q in (50.0, 99.0):
            assert metrics.snapshot_quantile(snap, q) == h.quantile(q)
        assert h.quantile(50.0) <= 10.0
        assert metrics.Histogram().quantile(50.0) is None

    def test_default_registry_save(self, tmp_path):
        metrics.counter("obs_test.save").inc()
        path = metrics.save_default(tmp_path)
        assert path.name == f"metrics_{os.getpid()}.json"
        snap = json.loads(path.read_text())
        assert snap["counters"]["obs_test.save"] >= 1.0

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_snapshots_merge_across_packages(self, writer):
        """The same observations give the same snapshot in both packages,
        and either package merges the other's."""
        regs = (metrics.MetricsRegistry(), jmetrics.MetricsRegistry())
        for r in regs:
            r.counter("c").inc(2)
            h = r.histogram("h", buckets=(1.0, 10.0))
            for v in (0.5, 4.0, 40.0):
                h.observe(v)
        port, ref = (r.snapshot() for r in regs)
        assert port["counters"] == ref["counters"]
        assert port["histograms"] == ref["histograms"]
        merge = metrics.merge if writer == "port" else jmetrics.merge
        both = merge(port, ref)
        assert both["counters"]["c"] == 4.0
        assert both["histograms"]["h"]["counts"] == [2, 2, 2]


# -------------------------------------------------------------- convergence

class TestConvergence:
    GOLDEN_KEYS = (
        "schema", "step", "outer_it", "lam_index", "lam1", "lam2",
        "f", "loss", "deviance", "alpha", "mu", "nnz", "accepted_unit",
        "active_size", "screened", "kkt_violations",
        "supersteps", "sweep_tile_launches", "sweep_tiles_skipped",
        "step_us", "phase_us",
    )

    def test_schema_keys_are_golden_and_the_references(self):
        assert conv.SCHEMA_KEYS == self.GOLDEN_KEYS == jconv.SCHEMA_KEYS
        assert conv.SCHEMA_VERSION == jconv.SCHEMA_VERSION == 1

    def test_emit_round_trip_fills_missing_with_none(self, tmp_path):
        p = tmp_path / "conv.jsonl"
        with conv.ConvergenceStream(p) as s:
            s.emit(step=0, f=1.5, nnz=3)
            s.emit(step=1, f=1.2, nnz=4, phase_us={"sweep": 10.0})
        evs = conv.read_events(p)
        assert len(evs) == 2
        assert list(evs[0]) == list(self.GOLDEN_KEYS)
        assert evs[0]["schema"] == 1 and evs[0]["f"] == 1.5
        assert evs[0]["alpha"] is None
        assert evs[1]["phase_us"] == {"sweep": 10.0}

    def test_emit_rejects_unknown_field(self, tmp_path):
        with conv.ConvergenceStream(tmp_path / "c.jsonl") as s:
            with pytest.raises(ValueError, match="unknown convergence"):
                s.emit(step=0, objektive=1.0)

    def test_reader_rejects_schema_mismatch(self, tmp_path):
        p = tmp_path / "c.jsonl"
        p.write_text(json.dumps({"schema": 999, "step": 0}) + "\n")
        with pytest.raises(ValueError, match="schema 999"):
            conv.read_events(p)

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_streams_read_across_packages(self, tmp_path, writer):
        stream = conv.ConvergenceStream if writer == "port" \
            else jconv.ConvergenceStream
        p = tmp_path / "c.jsonl"
        with stream(p) as s:
            s.emit(step=1, f=2.5, nnz=7, lam_index=0,
                   phase_us={"stats": 1.0, "sweep": 2.0,
                             "line_search": 3.0})
        assert conv.read_events(p) == jconv.read_events(p)
        [ev] = conv.read_events(p)
        assert ev["f"] == 2.5 and ev["phase_us"]["sweep"] == 2.0


# ----------------------------------------------------- the solver's stream

def _stream_pair(tmp_path, fit):
    """(port events, reference events) of ``fit(solver_cls, config_cls)``
    with a stream attached to each session."""
    out = []
    for tag, S, C in (("t", TSolver, TConfig), ("j", JSolver, JConfig)):
        path = tmp_path / f"{tag}.jsonl"
        fit(S, C, path)
        out.append((conv.read_events if tag == "t"
                    else jconv.read_events)(path))
    return out


EQUAL_KEYS = ("step", "outer_it", "lam_index", "lam1", "lam2", "nnz",
              "active_size", "accepted_unit", "screened", "kkt_violations",
              "supersteps", "sweep_tile_launches", "sweep_tiles_skipped")


def test_solver_stream_matches_jax(tmp_path):
    """The reference's tiny fit in both packages: one event a superstep,
    the same counters, f, loss, alpha and mu within 1e-5; untraced, no
    step time in either."""
    X, y = _tiny()

    def fit(S, C, path):
        kw = {"device": CPU} if S is TSolver else {}
        s = S(X, y, config=C(tile_size=8, max_outer=5, tol=0.0), **kw)
        s.set_convergence_stream(path)
        s.fit(lam1=0.05, lam2=1e-3)

    tev, jev = _stream_pair(tmp_path, fit)
    assert len(tev) == len(jev) == 5
    assert [e["step"] for e in tev] == list(range(1, 6))
    assert all(e["outer_it"] == e["step"] for e in tev)
    for a, b in zip(tev, jev):
        assert {k: a[k] for k in EQUAL_KEYS} == {k: b[k] for k in EQUAL_KEYS}
        for k in ("f", "loss", "alpha", "mu"):
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), (k, a, b)
        assert a["step_us"] is None and b["step_us"] is None
        assert a["phase_us"] is None
    assert tev[-1]["active_size"] == 24 and tev[-1]["nnz"] >= 1


def test_traced_session_opens_its_stream(tmp_path):
    """A session made while tracing targets a directory writes
    ``convergence_<pid>.jsonl`` there, with the span's step µs."""
    X, y = _tiny()
    tr = trace.enable(tmp_path)
    s = TSolver(X, y, config=TConfig(tile_size=8, max_outer=3, tol=0.0),
                device=CPU)
    s.fit(lam1=0.05)
    s._conv.close()
    evs = conv.read_events(tmp_path / f"convergence_{tr.pid}.jsonl")
    assert [e["step"] for e in evs] == [1, 2, 3]
    assert all(e["step_us"] > 0 for e in evs)
    spans = [e for e in tr.export()["traceEvents"]
             if e["ph"] == "B" and e["name"] == "solver/superstep"]
    assert len(spans) == 3


def test_traced_fit_equals_untraced(tmp_path):
    """Spans, profiler ranges and the stream change no result: beta, f,
    alpha, n_iter and the launch events are the same bits."""
    X, y = _tiny(3)
    cfg = TConfig(tile_size=8, max_outer=4, tol=0.0)
    runs = []
    for traced in (False, True):
        if traced:
            trace.enable(tmp_path)
        s = TSolver(X, y, config=cfg, device=CPU)
        with ops.launch_trace() as ev:
            r = s.fit(lam1=0.05)
        runs.append((r, list(ev)))
        if traced:
            s._conv.close()
            trace.disable()
    (a, ea), (b, eb) = runs
    assert np.array_equal(a.beta, b.beta) and a.n_iter == b.n_iter
    assert a.history["f"] == b.history["f"]
    assert a.history["alpha"] == b.history["alpha"]
    assert ea == eb


def test_path_stream_matches_jax(tmp_path):
    """A screened dense path at tol=1e-4: the same lam_index, screened and
    kkt_violations event for event.  The grid starts at 0.2 lambda_max, so
    the strong rule at its first lambda misses coordinates and the KKT
    test re-admits them (a second round, whose events carry the count)."""
    ds = tsynth.make_dense(n=300, p=48, k_true=8, seed=4)
    X, y = ds.train.X, ds.train.y
    grid = [None]

    def fit(S, C, path):
        kw = {"device": CPU} if S is TSolver else {}
        s = S(X, y, config=C(tile_size=8), **kw)
        if grid[0] is None:
            lmax = s.lambda_max()
            grid[0] = np.logspace(np.log10(0.2 * lmax),
                                  np.log10(0.05 * lmax), 4)
        s.set_convergence_stream(path)
        s.fit_path(lambdas=grid[0], max_outer=60, tol=1e-4)
        assert s._conv_ctx == {}

    tev, jev = _stream_pair(tmp_path, fit)
    assert len(tev) == len(jev)
    key = lambda e: (e["lam_index"], e["screened"], e["kkt_violations"])
    assert [key(e) for e in tev] == [key(e) for e in jev]
    assert {e["lam_index"] for e in tev} == set(range(4))
    assert all(e["screened"] is not None for e in tev)
    assert any(e["kkt_violations"] for e in tev)
    for a, b in zip(tev, jev):
        assert {k: a[k] for k in EQUAL_KEYS} == {k: b[k] for k in EQUAL_KEYS}


@pytest.mark.parametrize("traced", [False, True])
def test_streaming_stream_phase_us(tmp_path, traced):
    """A streaming superstep's three pass spans give ``phase_us`` and their
    sum ``step_us`` when traced, None when not."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(100, 12)).astype(np.float32)
    y = np.where(rng.random(100) < 0.5, -1.0, 1.0).astype(np.float32)
    sd, _ = tdesign.streaming_design(X, 8, chunk_rows=32, device=CPU)
    if traced:
        tr = trace.enable()
    s = TSolver(sd, y, config=TConfig(tile_size=8), device=CPU)
    s.set_convergence_stream(tmp_path / "c.jsonl")
    s.fit(lam1=0.1, max_outer=2, tol=0.0)
    evs = conv.read_events(tmp_path / "c.jsonl")
    assert len(evs) == 2
    for e in evs:
        if not traced:
            assert e["step_us"] is None and e["phase_us"] is None
            continue
        assert set(e["phase_us"]) == {"stats", "sweep", "line_search"}
        assert e["step_us"] == pytest.approx(sum(e["phase_us"].values()))
    if traced:
        names = collections.Counter(
            e["name"] for e in tr.export()["traceEvents"] if e["ph"] == "B")
        assert names == {"solver/stream_stats": 2, "solver/stream_sweep": 2,
                         "solver/stream_line_search": 2}


def test_phase_fractions_are_kept_and_validated():
    X, y = _tiny()
    s = TSolver(X, y, config=TConfig(tile_size=8), device=CPU)
    s.set_phase_fractions({"sweep": 0.75, "stats": np.float32(0.25)})
    assert s._phase_fractions == {"sweep": 0.75, "stats": 0.25}
    with pytest.raises((TypeError, ValueError)):
        s.set_phase_fractions({"sweep": "most"})
    s.set_phase_fractions(None)
    assert s._phase_fractions is None


# --------------------------------------------------------------- launches

def _toy_superstep(fused, layout, n=8, p=16, T=8):
    """The port's superstep at the reference audit's toy size, on a dense
    or a brick design."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, p)).astype(np.float32)
    cfg = TConfig(lam1=0.1, lam2=0.01, tile_size=T, coupling="jacobi",
                  fuse_superstep=fused)
    if layout == "bricks":
        X = tsparse.SparseCOO(*np.nonzero(X), X[np.nonzero(X)], (n, p))
    design, _ = tdesign.as_design(X, T, row_block=8, device=CPU)
    step = tdglmnet.make_superstep(cfg, n_tiles=design.n_tiles, device=CPU)
    z = lambda k: torch.zeros(k)
    state = tdglmnet.FitState(beta=z(p), xb=z(n), mu=torch.tensor(1.0),
                              cursor=0, step=0)
    y = torch.from_numpy(np.where(rng.random(n) < 0.5, -1.0, 1.0)
                         .astype(np.float32))
    return lambda: step(design, y, torch.ones(n), z(n), (0.1, 0.01),
                        torch.ones(p), state, active=torch.ones(p))


@pytest.mark.parametrize("layout", ["dense", "bricks"])
@pytest.mark.parametrize("fused", [True, False])
def test_launch_trace_matches_the_reference_audit(fused, layout):
    """Fused: 2 logical launches (on bricks too: the dispatchers the fused
    entries compose there record nothing); unfused: glm_stats, the
    batched solve, the merge matvec and the two-pass line search, as the
    reference's kernel route records them.  The brick sweep's per-tile
    Grams coalesce with the solve into the audit's one gram_solve unit."""
    step, args = jaudit._build_superstep(fused=fused)
    import jax
    with jops.launch_trace() as jev:
        jax.make_jaxpr(step)(*args)
    run = _toy_superstep(fused, layout)
    with ops.launch_trace() as tev:
        run()
    if layout == "dense" or fused:
        assert tev == jev
    else:
        assert tev == ["glm_stats", "tile_gram", "tile_gram",
                       "cd_tile_solve", "matvec", "alpha_search",
                       "alpha_search"]
    assert jaudit.coalesce_launch_events(tev) == \
        jaudit.trace_superstep(fused=fused)[0]


def test_launch_trace_gauss_seidel_one_event_a_call(monkeypatch):
    """On a brick Gauss-Seidel superstep every dispatcher call is one
    event (counted through wrappers of the dispatchers): K1, then K3 and
    K2 for each tile, then K4 twice.  An inner trace takes the events
    from the outer one, and outside a trace nothing is recorded."""
    ds = tsynth.make_sparse(n=200, p=40, avg_nnz=6, k_true=5, seed=2)
    s = TSolver(ds.train.X, ds.train.y, config=TConfig(tile_size=8),
                device=CPU)
    lam1 = 0.05 * s.lambda_max()
    nt = s.design.n_tiles
    calls = collections.Counter()
    for name in ("glm_stats", "tile_gram", "cd_tile_solve", "alpha_search"):
        def counting(*a, _fn=getattr(ops, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counting)
    with ops.launch_trace() as outer:
        with ops.launch_trace() as ev:
            s.fit(lam1=lam1, max_outer=1, tol=0.0)
    assert outer == []
    assert ev == ["glm_stats"] + ["tile_gram", "cd_tile_solve"] * nt \
        + ["alpha_search"] * 2
    assert collections.Counter(ev) == calls
    ops.record_launch("outside")          # no trace: a no-op
    assert ops._LAUNCH_EVENTS is None


# -------------------------------------------------------------------- hooks

def test_checkpoint_spans(tmp_path):
    tr = trace.enable()
    mgr = CheckpointManager(tmp_path / "ck", async_save=True)
    tree = {"beta": torch.arange(4.0), "mu": torch.tensor(1.0)}
    mgr.save(3, tree)
    mgr.save(4, tree)
    mgr.wait()
    back, _ = mgr.restore(tree)
    assert torch.equal(back["beta"], tree["beta"])
    evs = tr.export()["traceEvents"]
    b = [e for e in evs if e["ph"] == "B"]
    by = collections.Counter(e["name"] for e in b)
    assert by == {"ckpt/save": 2, "ckpt/commit": 2, "ckpt/restore": 1}
    assert [e["args"]["step"] for e in b if e["name"] == "ckpt/commit"] \
        == [3, 4]
    assert next(e for e in b if e["name"] == "ckpt/restore")["args"] == \
        {"step": 4}
    main = threading.get_ident()
    assert all(e["tid"] != main for e in b if e["name"] == "ckpt/commit")
    assert all(e["tid"] == main for e in b if e["name"] == "ckpt/save")


def test_chunk_cache_counters_match_jax(tmp_path):
    """The same access sequence gives the same hit and miss counts in
    both packages, and one ``io/parse_chunk`` span a miss."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(80, 6)).astype(np.float32)
    y = np.where(rng.random(80) < 0.5, -1.0, 1.0).astype(np.float32)
    path = write_libsvm(tmp_path / "c.libsvm", X, y)
    seq = [0, 1, 0, 2, 3, 1, 4, 0, 4]
    deltas = []
    tr = trace.enable()
    for R, M in ((LibsvmReader, metrics), (JReader, jmetrics)):
        r = R(path, chunk_rows=16, cache_chunks=2)
        before = M.registry().snapshot()
        for i in seq:
            r.chunk(i)
        after = M.registry().snapshot()
        deltas.append({k: _counter(after, k) - _counter(before, k)
                       for k in ("io.chunk_cache.hit",
                                 "io.chunk_cache.miss")})
    assert deltas[0] == deltas[1]
    assert deltas[0]["io.chunk_cache.hit"] > 0
    parsed = [e for e in tr.export()["traceEvents"]
              if e["ph"] == "B" and e["name"] == "io/parse_chunk"]
    assert len(parsed) == deltas[0]["io.chunk_cache.miss"]


def test_prefetch_spans_on_the_worker_lane():
    tr = trace.enable()
    with PrefetchingSource(lambda i: np.full(3, i), 4, depth=2) as src:
        got = [int(src(i)[0]) for i in range(4)]
    assert got == [0, 1, 2, 3]
    evs = tr.export()["traceEvents"]
    b = [e for e in evs if e["ph"] == "B" and e["name"] ==
         "io/prefetch_produce"]
    assert [e["args"]["chunk"] for e in b] == [0, 1, 2, 3]
    assert {e["tid"] for e in b} != {threading.get_ident()}
    lanes = {e["tid"]: e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {lanes[e["tid"]] for e in b} == {"repro-torch-io-prefetch"}
    assert metrics.registry().snapshot()["gauges"][
        "io.prefetch.queue_depth"]["value"] >= 0


def test_serve_counters_and_flush_spans():
    """``serve.compiled_shapes`` counts the engine's new keys, one
    ``serve/flush`` span a batch, and the flush counters and latency
    histogram count every batch and request."""
    rng = np.random.default_rng(2)
    p = 30
    beta = np.where(rng.random(p) < 0.5, rng.normal(size=p), 0.0)
    model = ServableModel(betas=beta[None, :].astype(np.float32),
                          intercepts=np.asarray([0.1], np.float32),
                          family="logistic")
    tr = trace.enable()
    before = metrics.registry().snapshot()
    eng = ScoringEngine(model, device=CPU)
    reqs = [(rng.choice(p, 4, replace=False), rng.normal(size=4))
            for _ in range(40)]
    with MicroBatcher(eng, max_delay_ms=1.0, batch_buckets=(1, 4, 16),
                      nnz_buckets=(8,)) as b:
        b.warmup()
        hs = [b.submit(i, v) for i, v in reqs]
        outs = [h.get(timeout=60) for h in hs]
    st = b.stats()
    after = metrics.registry().snapshot()
    d = lambda k: _counter(after, k) - _counter(before, k)
    assert len(outs) == 40 and st["n_requests"] == 40
    assert d("serve.compiled_shapes") == eng.compile_count == 6
    evs = tr.export()["traceEvents"]
    flushes = [e for e in evs if e["ph"] == "B" and e["name"] == "serve/flush"]
    assert len(flushes) == st["n_batches"]
    assert sum(e["args"]["batch"] for e in flushes) == 40
    assert sum(1 for e in evs if e["ph"] == "i" and
               e["name"] == "serve/compile") == eng.compile_count
    assert sum(d(f"serve.flush.{r}") for r in ("full", "deadline", "close")) \
        == st["n_batches"]
    h0 = before["histograms"].get("serve.latency_ms", {"n": 0})
    assert after["histograms"]["serve.latency_ms"]["n"] - h0["n"] == 40
    assert "serve.queue_depth" in after["gauges"]
