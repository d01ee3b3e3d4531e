"""repro_torch.analysis: the port's lint rules, baseline and audits, on the
CPU, against the JAX package's ``repro.analysis`` on the same inputs.

  * each rule's true-positive fixture (code that must be flagged) and its
    false-positive guard (the closest sanctioned idiom), in the torch form
    of the hazard, in the shape of ``tests/test_analysis.py``;
  * parity with JAX: ``reconcile``, ``load_baseline`` and
    ``write_baseline``; ``FileContext.qualname``/``waived``; the rules
    whose semantics are unchanged (HASH001, DIST002 on the reference's
    names, OBS001 with ``src/repro/`` mapped to ``src/repro_torch/``,
    SYNC001's ``time.time`` half, JIT001's lambda-in-builder half) give the
    same (code, line, col, scope) lists on the reference's fixtures;
    ``superstep_launch_targets`` equal on a grid; the audit's launch units
    equal to ``repro.analysis.audit.trace_superstep``'s;
  * the steady-state contract of the reference's tests (one superstep
    build a key: a second session, a lambda path, a CV, a streaming path
    add none);
  * the collective audit in a world of 2 CPU processes (this file is its
    worker, ``--collective-worker``);
  * ``main()``'s exit codes and ``--json`` keys, the repo's own lint gate.
Card-only checks (kernel_smem, profiler records) are in
``tests/test_torch_gpu.py``.
"""
import ast
import importlib.util
import json
import pathlib
import re
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

from repro.analysis import astutil as jastutil
from repro.analysis import audit as jaudit
from repro.analysis import lint as jlint
from repro.analysis.rules import RULES_BY_CODE as JRULES
from repro.roofline import hlo as jhlo
from repro_torch.analysis import astutil as tastutil
from repro_torch.analysis import audit
from repro_torch.analysis import lint as tlint
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_CODE
from repro_torch.core import dglmnet as tdglmnet
from repro_torch.core import solver as tsolver
from repro_torch.core.dglmnet import DGLMNETConfig
from repro_torch.core.solver import GLMSolver
from repro_torch.data import synthetic
from repro_torch.data.design import streaming_design
from repro_torch.dist import bootstrap
from repro_torch.dist import launcher
from repro_torch.kernels import build, ops
from repro_torch.roofline import hlo as thlo
from repro_torch.sharding import collectives

REPO = pathlib.Path(__file__).resolve().parents[1]
THIS = pathlib.Path(__file__).resolve()
CSRC = REPO / "src" / "repro_torch" / "kernels" / "csrc"
WORLD_TIMEOUT_S = 120


def _reference_fixtures():
    """The JAX package's own test module (its fixture sources)."""
    spec = importlib.util.spec_from_file_location(
        "_reference_test_analysis", REPO / "tests" / "test_analysis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_fixtures()
REF_SOURCES = {k: v for k, v in vars(REF).items()
               if re.match(r"^[A-Z0-9]+_(TP|FP)", k) and isinstance(v, str)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small problems: torch's intra-op threads buy nothing here and,
    beside the other test workers, spin on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_rule(code, src, relpath="src/repro_torch/core/example.py"):
    return tlint.lint_text(textwrap.dedent(src), relpath,
                           rules=[RULES_BY_CODE[code]])


def codes(violations):
    return [v.code for v in violations]


def _sites(violations):
    return [(v.code, v.line, v.col, v.scope) for v in violations]


# ----------------------------------------------------- parity with JAX

# (code, fixture, relpath in the reference, relpath in the port)
_IO = ("src/repro/io/example.py", "src/repro_torch/io/example.py")
_CORE = ("src/repro/core/example.py", "src/repro_torch/core/example.py")
_OBS_TP = """
    import time

    def step(fn, x):
        t0 = time.perf_counter()
        out = fn(x)
        return out, time.perf_counter() - t0
"""
_OBS_LONE = """
    import time

    def stamp():
        return {"at": time.monotonic()}
"""
_DIST002_UNIFORM = """
    from repro.dist.bootstrap import barrier

    def sync(ctx):
        if ctx.multiprocess:      # uniform across the job: sanctioned
            barrier("sync")
"""
PARITY = [
    ("HASH001", "HASH001_TP", *_IO), ("HASH001", "HASH001_FP", *_IO),
    ("HASH001", "HASH001_TP", *_CORE),
    ("DIST002", "DIST002_TP_BRANCH", *_CORE),
    ("DIST002", "DIST002_TP_EARLY_EXIT", *_CORE),
    ("DIST002", "DIST002_FP", *_CORE),
    ("DIST002", _DIST002_UNIFORM, *_CORE),
    ("OBS001", _OBS_TP, *_CORE), ("OBS001", _OBS_LONE, *_CORE),
    ("OBS001", _OBS_TP, "src/repro/obs/trace.py",
     "src/repro_torch/obs/trace.py"),
    ("OBS001", _OBS_TP, "src/repro/timing.py", "src/repro_torch/timing.py"),
    ("OBS001", _OBS_TP, "benchmarks/run.py", "chip_smoke.py"),
    ("SYNC001", "SYNC001_TP_TIME", *_CORE),
    ("SYNC001", "SYNC001_FP_SINGLE", *_CORE),
    ("SYNC001", "SYNC001_FP_STRINGS", *_CORE),
    ("JIT001", "JIT001_TP_BUILDER", *_CORE),
    ("JIT001", "JIT001_FP", *_CORE),
]


@pytest.mark.parametrize("code,fixture,jpath,tpath", PARITY,
                         ids=[f"{i}-{c}" for i, (c, *_) in
                              enumerate(PARITY)])
def test_rule_sites_match_jax(code, fixture, jpath, tpath):
    src = textwrap.dedent(REF_SOURCES.get(fixture, fixture))
    want = jlint.lint_text(src, jpath, rules=[JRULES[code]])
    got = tlint.lint_text(src, tpath, rules=[RULES_BY_CODE[code]])
    assert _sites(got) == _sites(want)


def test_waiver_parity_with_jax():
    src = textwrap.dedent("""
        import time

        def manifest():
            # lint: allow SYNC001 — wall-clock timestamp, not a span
            a = {"time": time.time()}
            # noqa: SYNC001
            b = time.time()
            # lint: allow DIST001 — wrong code: must not suppress SYNC001
            return a, b, {"time": time.time()}
    """)
    for path in ("src/repro/x.py", "src/repro_torch/x.py"):
        want = jlint.lint_text(src, path, rules=[JRULES["SYNC001"]])
        got = tlint.lint_text(src, path, rules=[RULES_BY_CODE["SYNC001"]])
        assert _sites(got) == _sites(want) and len(got) == 1


@pytest.mark.parametrize("fixture", sorted(REF_SOURCES))
def test_file_context_matches_jax(fixture):
    """qualname of every node and waived(code, line) of every line agree
    on the reference's fixture sources."""
    src = textwrap.dedent(REF_SOURCES[fixture])
    jc = jastutil.FileContext("src/x.py", src)
    tc = tastutil.FileContext("src/x.py", src)
    jn = [n for n in ast.walk(jc.tree) if hasattr(n, "lineno")]
    tn = [n for n in ast.walk(tc.tree) if hasattr(n, "lineno")]
    assert [jc.qualname(n) for n in jn] == [tc.qualname(n) for n in tn]
    for code in sorted(JRULES):
        for line in range(len(jc.lines) + 2):
            assert jc.waived(code, line) == tc.waived(code, line)
    for prefix in ("repro", "repro.dist", "jax", "torch"):
        assert jc.imports(prefix) == tc.imports(prefix)


def _both(code="SYNC001", path="src/x.py", scope="f", line=1):
    return (jastutil.Violation(code, path, line, 0, scope, "m"),
            tastutil.Violation(code, path, line, 0, scope, "m"))


def test_reconcile_matches_jax():
    pairs = [_both(), _both(line=2), _both("OBS001", scope="g"),
             _both("JIT001", path="src/y.py")]
    baseline = {"version": 1, "entries": [
        {"code": "SYNC001", "path": "src/x.py", "scope": "f", "count": 1,
         "reason": "legacy"},
        {"code": "OBS001", "path": "src/x.py", "scope": "g",
         "reason": "default count"},
        {"code": "HASH001", "path": "src/z.py", "scope": "h", "count": 2,
         "reason": "fixed since"}]}
    for k in range(len(pairs) + 1):
        jv = [p[0] for p in pairs[:k]]
        tv = [p[1] for p in pairs[:k]]
        jn, jo, js = jlint.reconcile(jv, baseline)
        tn, to, ts = tlint.reconcile(tv, baseline)
        assert [v.fingerprint() + (v.line,) for v in tn] == \
            [v.fingerprint() + (v.line,) for v in jn]
        assert [v.fingerprint() + (v.line,) for v in to] == \
            [v.fingerprint() + (v.line,) for v in jo]
        assert ts == js


def test_write_and_load_baseline_match_jax(tmp_path):
    pairs = [_both(), _both(line=5), _both("PREC001", scope="k.m")]
    jlint.write_baseline(tmp_path / "j.json", [p[0] for p in pairs])
    tlint.write_baseline(tmp_path / "t.json", [p[1] for p in pairs])
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    # every entry needs a reason: the written TODO reason loads in both
    assert tlint.load_baseline(tmp_path / "t.json") == \
        jlint.load_baseline(tmp_path / "j.json")
    assert tlint.load_baseline(tmp_path / "none.json") == \
        jlint.load_baseline(tmp_path / "none.json")
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 1, "entries": [
        {"code": "SYNC001", "path": "x.py", "scope": "f", "count": 1}]}))
    with pytest.raises(SystemExit):
        jlint.load_baseline(bad)
    with pytest.raises(SystemExit):
        tlint.load_baseline(bad)


def test_summary_keys_match_jax():
    v = [_both()[1]]
    got = tlint.summary_dict(v, v, [], 3)
    want = jlint.summary_dict([_both()[0]], [_both()[0]], [], 3)
    assert set(got) == set(want)
    assert got["rules"] == [r.CODE for r in ALL_RULES] == want["rules"]


@pytest.mark.parametrize("fused", [True, False])
def test_launch_targets_match_jax(fused):
    for n in (8, 1000, 131_072, 400_000):
        for p in (16, 512, 2_048, 16_640):
            for T in (8, 64, 256):
                for K in (14, 294):
                    assert thlo.superstep_launch_targets(
                        n, p, T, n_candidates=K, fused=fused) == \
                        jhlo.superstep_launch_targets(
                            n, p, T, n_candidates=K, fused=fused)


@pytest.mark.parametrize("fused", [True, False])
def test_audit_launch_units_match_jax(fused):
    want, _ = jaudit.trace_superstep(fused=fused)
    got, launches = audit.trace_superstep(fused=fused, device="cpu")
    assert got == want
    assert launches == {}          # no kernel runs on the CPU
    assert len(got) == thlo.superstep_launch_targets(
        8, 16, 8, fused=fused)["n_launches"]


def test_coalesce_matches_jax():
    events = ["glm_stats", "tile_gram", "cd_tile_solve", "tile_gram",
              "cd_tile_solve", "alpha_search", "all_tile_grams", "matvec",
              "cd_tile_solve"]
    assert audit.coalesce_launch_events(events) == \
        jaudit.coalesce_launch_events(events)


# ---------------------------------------------------------------- DIST001

DIST001_TP = """
    import torch
    from repro_torch.dist import bootstrap

    def place(x):
        return x.cuda()
"""

DIST001_FP = """
    import torch

    def place(x):
        # no repro_torch.dist import, not under dist/: a local module
        return x.cuda()
"""


def test_dist001_flags_cuda_call_in_dist_module():
    got = run_rule("DIST001", DIST001_TP)
    assert codes(got) == ["DIST001"]
    assert "put_global" in got[0].message


@pytest.mark.parametrize("expr", [
    'torch.zeros(4, device="cuda")', 'torch.zeros(4, device="cuda:1")',
    'x.to("cuda")', 'x.to("cuda:0")', 'torch.device("cuda:0")'])
def test_dist001_flags_named_cards(expr):
    src = f"""
        import torch

        def place(x):
            return {expr}
    """
    got = run_rule("DIST001", src, relpath="src/repro_torch/dist/example.py")
    assert codes(got) == ["DIST001"]       # a literal is reported once


def test_dist001_ignores_non_dist_modules():
    assert run_rule("DIST001", DIST001_FP) == []


def test_dist001_allows_resolved_placement():
    src = """
        import torch
        from repro_torch.device import resolve_device
        from repro_torch.dist import bootstrap

        def place(x, device=None):
            dev = resolve_device(device)
            return x.to(dev), torch.zeros(4, device=dev), x.to("cpu")
    """
    assert run_rule("DIST001", src) == []


def test_dist001_waiver():
    src = """
        from repro_torch.dist import bootstrap

        def place(x):
            return x.cuda()    # lint: allow DIST001 — the rank's own card
    """
    assert run_rule("DIST001", src) == []


# ---------------------------------------------------------------- DIST002

DIST002_TP_RANK = """
    import torch.distributed as dist

    def merge(x):
        if dist.get_rank() == 0:
            dist.all_reduce(x)        # the other ranks never reach it
        return x
"""

DIST002_TP_NEW_GROUP = """
    import torch.distributed as dist

    def groups(mesh):
        if mesh.get_local_rank("model") == 0:
            return dist.new_group([0, 1])   # every rank must call new_group
"""

DIST002_TP_EARLY = """
    from repro_torch.dist import bootstrap

    def save(ctx, arr):
        if ctx.process_id != 0:
            return None
        write(arr)
        return bootstrap.broadcast_host(arr)
"""

DIST002_FP_WORLD = """
    import torch.distributed as dist

    def merge(x):
        if dist.get_world_size() > 1:   # the same on every rank
            dist.all_reduce(x)
        return x
"""


def test_dist002_flags_torch_collective_under_rank_branch():
    got = run_rule("DIST002", DIST002_TP_RANK)
    assert codes(got) == ["DIST002"] and "all_reduce" in got[0].message


def test_dist002_flags_new_group_under_local_rank():
    got = run_rule("DIST002", DIST002_TP_NEW_GROUP)
    assert codes(got) == ["DIST002"] and "new_group" in got[0].message


def test_dist002_flags_early_exit_before_broadcast():
    got = run_rule("DIST002", DIST002_TP_EARLY)
    assert codes(got) == ["DIST002"] and "early exit" in got[0].message


def test_dist002_allows_world_size_gate():
    assert run_rule("DIST002", DIST002_FP_WORLD) == []


# ---------------------------------------------------------------- SYNC001

SYNC001_TP_ITEMS = """
    def run(step, state, history):
        for it in range(100):
            state, metrics = step(state)
            history["f"].append(metrics["f"].item())
            history["nnz"].append(int(metrics["nnz"]))
"""

SYNC001_TP_CPU = """
    def run(step, state, out):
        for it in range(100):
            state, beta = step(state)
            out.append((beta.cpu(), state.mu.tolist()))
"""

SYNC001_FP_BATCHED = """
    import torch

    def run(step, state, history):
        for it in range(100):
            state, metrics = step(state)
            f, nnz = torch.stack([metrics["f"], metrics["nnz"]]).tolist()
            history["f"].append(f)
            history["nnz"].append(int(nnz))
"""

SYNC001_FP_CHAINED = """
    def run(step, state, out):
        for it in range(100):
            state, beta = step(state)
            out.append(beta.cpu().numpy())   # one readback, not two
"""


def test_sync001_flags_per_iteration_item_reads():
    got = run_rule("SYNC001", SYNC001_TP_ITEMS)
    assert codes(got) == ["SYNC001"]
    assert "tolist" in got[0].message and "2 blocking" in got[0].message


def test_sync001_flags_cpu_and_tolist_reads():
    got = run_rule("SYNC001", SYNC001_TP_CPU)
    assert codes(got) == ["SYNC001"]


def test_sync001_allows_one_batched_read():
    assert run_rule("SYNC001", SYNC001_FP_BATCHED) == []


def test_sync001_counts_a_chained_read_once():
    assert run_rule("SYNC001", SYNC001_FP_CHAINED) == []


def test_sync001_allows_single_convergence_check():
    assert run_rule("SYNC001", REF.SYNC001_FP_SINGLE) == []


def test_sync001_flags_time_time_span():
    got = run_rule("SYNC001", REF.SYNC001_TP_TIME)
    assert codes(got) == ["SYNC001", "SYNC001"]
    assert "perf_counter" in got[0].message


# ----------------------------------------------------------------- JIT001

JIT001_TP_COMPILED = """
    import torch

    @torch.compile
    def step(beta, g, config):
        return beta - config.lam1 * g
"""

JIT001_TP_COMPILE_IN_LOOP = """
    import torch

    def sweep(fns, xs):
        return [torch.compile(f)(xs) for f in fns] + [
            torch.jit.script(f) for f in fns]
"""

JIT001_TP_LOAD_IN_LOOP = """
    from torch.utils import cpp_extension

    def build_all(names):
        out = []
        for n in names:
            out.append(cpp_extension.load(name=n, sources=[n + ".cu"]))
        return out
"""

JIT001_FP_HOISTED = """
    import torch

    def sweep(f, xs):
        g = torch.compile(f)
        out = []
        for x in xs:
            out.append(g(x))
        return out
"""


def test_jit001_flags_lam_read_in_superstep_builder():
    got = run_rule("JIT001", REF.JIT001_TP_BUILDER)
    assert codes(got) == ["JIT001"] and "lams" in got[0].message


def test_jit001_flags_lam_read_in_compiled_fn():
    assert codes(run_rule("JIT001", JIT001_TP_COMPILED)) == ["JIT001"]


def test_jit001_flags_builds_in_loops_and_comprehensions():
    assert codes(run_rule("JIT001", JIT001_TP_COMPILE_IN_LOOP)) == \
        ["JIT001", "JIT001"]
    src = """
        import torch

        def sweep(fns, xs):
            out = []
            for f in fns:
                out.append(torch.compile(f)(xs))
                out.append(torch.jit.trace(f, xs))
            return out
    """
    assert codes(run_rule("JIT001", src)) == ["JIT001", "JIT001"]


def test_jit001_flags_extension_load_in_loop():
    got = run_rule("JIT001", JIT001_TP_LOAD_IN_LOOP)
    assert codes(got) == ["JIT001"] and "loop" in got[0].message


def test_jit001_allows_hoisted_compile_and_runtime_lams():
    assert run_rule("JIT001", JIT001_FP_HOISTED) == []
    assert run_rule("JIT001", REF.JIT001_FP) == []


# ---------------------------------------------------------------- PREC001

PREC001_TP = """
    import torch

    def gram(X, w):
        Xb = X.to(torch.bfloat16)
        return torch.mm(Xb.T, Xb)
"""

PREC001_TP_MATMUL_OP = """
    import torch

    def gram(X):
        Xb = X.bfloat16()
        return Xb.T @ Xb
"""

PREC001_TP_HALF_EINSUM = """
    import torch

    def gram(A, B):
        return torch.einsum("ki,kj->ij", A.half(), B)
"""

PREC001_TP_METHOD = """
    import torch

    def margins(X, d):
        Xb = torch.zeros(X.shape, dtype=torch.bfloat16)
        return Xb.mv(d)
"""

PREC001_FP = """
    import torch

    def gram(X, w):
        Xb = X.to(torch.bfloat16).float()     # rounded, then widened
        return torch.mm(Xb.T, Xb), torch.mm(X.T, X)
"""


@pytest.mark.parametrize("src", [PREC001_TP, PREC001_TP_MATMUL_OP,
                                 PREC001_TP_HALF_EINSUM, PREC001_TP_METHOD])
def test_prec001_flags_bf16_products(src):
    got = run_rule("PREC001", src)
    assert codes(got) == ["PREC001"] and "bf16" in got[0].message


def test_prec001_allows_widened_and_fp32_products():
    assert run_rule("PREC001", PREC001_FP) == []


@pytest.mark.parametrize("line,flagged", [
    ("torch.backends.cuda.matmul.allow_tf32 = True", True),
    ("torch.backends.cudnn.allow_tf32 = True", True),
    ('torch.set_float32_matmul_precision("high")', True),
    ('torch.set_float32_matmul_precision("medium")', True),
    ("torch.backends.cuda.matmul.allow_tf32 = False", False),
    ('torch.set_float32_matmul_precision("highest")', False)])
def test_prec001_tf32(line, flagged):
    got = run_rule("PREC001", f"import torch\n{line}\n")
    assert codes(got) == (["PREC001"] if flagged else [])


# ----------------------------------------------------------------- OBS001


def test_obs001_flags_span_in_the_port_only():
    assert codes(run_rule("OBS001", _OBS_TP)) == ["OBS001"]
    for path in ("src/repro_torch/obs/x.py", "src/repro_torch/timing.py",
                 "chip_smoke.py", "src/repro/core/x.py"):
        assert run_rule("OBS001", _OBS_TP, relpath=path) == []


def test_obs001_nested_def_owns_its_reads():
    src = """
        import time

        def outer():
            t0 = time.perf_counter()

            def inner():
                return time.perf_counter()
            return inner, t0
    """
    assert run_rule("OBS001", src) == []


# --------------------------------------------------- waivers & baseline

def test_inline_waiver_suppresses_finding():
    src = """
        import time

        def manifest():
            # lint: allow SYNC001 — wall-clock timestamp, not a span
            return {"time": time.time()}
    """
    assert run_rule("SYNC001", src) == []


def test_waiver_is_code_specific():
    src = """
        import time

        def manifest():
            # lint: allow DIST001 — wrong code: must not suppress SYNC001
            return {"time": time.time()}
    """
    assert codes(run_rule("SYNC001", src)) == ["SYNC001"]


def test_baseline_reconcile_budget_and_ratchet():
    v = lambda: tastutil.Violation("SYNC001", "src/x.py", 1, 0, "f", "m")
    baseline = {"version": 1, "entries": [
        {"code": "SYNC001", "path": "src/x.py", "scope": "f", "count": 1,
         "reason": "legacy"}]}
    new, old, stale = tlint.reconcile([v(), v()], baseline)
    assert len(old) == 1 and len(new) == 1 and stale == []
    new, old, stale = tlint.reconcile([], baseline)
    assert new == [] and old == [] and len(stale) == 1


def test_repo_baseline_is_justified():
    data = tlint.load_baseline(tlint.DEFAULT_BASELINE)
    assert data["entries"]
    for entry in data["entries"]:
        assert entry["reason"].strip() and "TODO" not in entry["reason"]
        assert entry["code"] in RULES_BY_CODE


def test_repo_lint_is_clean():
    """The committed tree has 0 new findings and 0 stale entries — the
    gate's exact check."""
    violations, n_files = tlint.lint_paths(
        [tlint.REPO_ROOT / t for t in tlint.DEFAULT_TARGETS])
    new, _, stale = tlint.reconcile(violations,
                                    tlint.load_baseline(tlint.DEFAULT_BASELINE))
    assert n_files > 60
    assert [v.render() for v in new] == []
    assert stale == []


def test_rules_are_pure_stdlib():
    """The rules, their plumbing and the engine import nothing beyond the
    standard library and each other (no torch, no jax)."""
    base = REPO / "src" / "repro_torch" / "analysis"
    files = [base / "astutil.py", base / "lint.py",
             *sorted((base / "rules").glob("*.py"))]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert name.startswith("repro_torch.analysis") or \
                    top in sys.stdlib_module_names, f"{path}: {name}"


# ------------------------------------------------------------------ main


def test_main_check_exit_codes(tmp_path, capsys):
    assert tlint.main(["--check"]) == 0
    bad = tmp_path / "bad.py"
    bad.write_text("import time\n\ndef f():\n    return time.time()\n")
    assert tlint.main(["--check", str(bad)]) == 1
    assert tlint.main([str(bad)]) == 0             # report only
    # a stale entry fails the gate too
    base = tmp_path / "b.json"
    base.write_text(json.dumps({"version": 1, "entries": [
        {"code": "OBS001", "path": "gone.py", "scope": "f", "count": 1,
         "reason": "fixed since"}]}))
    assert tlint.main(["--check", "--baseline", str(base),
                       str(tmp_path / "none")]) == 1
    assert "stale-baseline" in capsys.readouterr().out


def test_main_explain(capsys):
    for code in RULES_BY_CODE:
        assert tlint.main(["--explain", code.lower()]) == 0
        assert code in capsys.readouterr().out
    assert tlint.main(["--explain", "NOPE001"]) == 2


def test_main_write_baseline(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import time\n\ndef f():\n    return time.time()\n")
    base = tmp_path / "b.json"
    assert tlint.main(["--write-baseline", "--baseline", str(base),
                       str(bad)]) == 0
    entries = json.loads(base.read_text())["entries"]
    assert [(e["code"], e["scope"], e["count"]) for e in entries] == \
        [("SYNC001", "f", 1)]
    assert tlint.main(["--check", "--baseline", str(base), str(bad)]) == 0


def test_main_json_and_audit_on_the_cpu(tmp_path):
    out = tmp_path / "s.json"
    assert tlint.main(["--check", "--audit", "--device", "cpu", "--json",
                       str(out)]) == 0
    s = json.loads(out.read_text())
    want = jlint.summary_dict([], [], [], 0)
    assert set(s) == set(want) | {"audit"}
    assert s["violations_new"] == 0
    status = {k: v["status"] for k, v in s["audit"].items()}
    assert status == {
        "launches_fused": "ok", "launches_unfused": "ok",
        "kernel_smem": "skip", "collective_sequence": "ok",
        "predict_tile_single_launch": "ok", "tile_gram_single_launch": "ok",
        "streaming_finish_launch_free": "ok",
        "steady_state_recompiles": "ok"}


def test_audit_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlint.main(["--audit"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        audit.run_audit()


# ---------------------------------------------------------------- audits


def test_audits_on_the_cpu():
    res = {r.name: r for r in audit.run_audit(device="cpu")}
    assert audit.passed(list(res.values()))
    assert res["launches_fused"].details["units"] == ["fused_stats_sweep",
                                                      "fused_ls"]
    assert res["launches_unfused"].details["units"] == [
        "glm_stats", "gram_solve", "matvec", "alpha_search", "alpha_search"]
    assert res["kernel_smem"].status == "skip"
    d = res["steady_state_recompiles"].details
    assert d["steady_state_recompiles"] == d["nvcc_builds"] == \
        d["library_loads"] == 0 and d["lambdas"] == 3
    c = res["collective_sequence"].details
    assert c["n_collectives"] > 0 and c["deterministic"]
    assert not torch.distributed.is_initialized()    # the world was shut


def test_passed_rejects_fail_and_foreign_skip():
    R = audit.AuditResult
    assert audit.passed([R("a", "ok", {}), R("kernel_smem", "skip", {})])
    assert not audit.passed([R("a", "fail", {})])
    assert not audit.passed([R("launches_fused", "skip", {})])


def test_launch_audit_fails_a_wrong_unit_count(monkeypatch):
    monkeypatch.setattr(audit, "coalesce_launch_events",
                        lambda ev: list(ev) + ["extra"])
    res = audit.audit_superstep_launches("cpu")
    assert [r.status for r in res] == ["fail", "fail"]


def test_launch_audit_on_a_session_design():
    """The full-size form chip_smoke.py runs: the launch units of a
    session's own brick design and observation model."""
    ds = synthetic.make_sparse(n=400, p=300, avg_nnz=12, k_true=10, seed=3)
    s = GLMSolver(ds.train.X, ds.train.y, fit_intercept=True,
                  config=DGLMNETConfig(tile_size=64), row_block=64,
                  device="cpu")
    res = audit.audit_superstep_launches(prob=audit.solver_problem(s))
    assert [r.status for r in res] == ["ok", "ok"]
    assert res[1].details["units"] == ["glm_stats", "gram_solve", "matvec",
                                       "alpha_search", "alpha_search"]


def test_ptxas_report_and_disagreements():
    log = textwrap.dedent("""\
        == glm_stats.cu (rc 0)
        ptxas info    : 0 bytes gmem
        ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116glm_stats_kernelILi0EEEvPKf' for 'sm_90a'
        ptxas info    : Function properties for _ZN12_GLOBAL__N_116glm_stats_kernelILi0EEEvPKf
            0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
        ptxas info    : Used 32 registers, used 0 barriers, 400 bytes cmem[0]
        ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116glm_stats_kernelILi1EEEvPKf' for 'sm_90a'
        ptxas info    : Function properties for _ZN12_GLOBAL__N_116glm_stats_kernelILi1EEEvPKf
            8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
        ptxas info    : Used 40 registers, used 1 barriers, 64 bytes smem, 400 bytes cmem[0]
        == link (rc 0)
        """)
    rep = audit.ptxas_report(log)
    assert [(e["regs"], e["smem"], e["spill_stores"])
            for e in rep["glm_stats"]] == [(32, 0, 0), (40, 64, 4)]
    res = {"glm_stats": [{"name": "glm_stats_kernel<0>", "regs": 32,
                          "static_smem": 0, "local_bytes": 0},
                         {"name": "glm_stats_kernel<1>", "regs": 40,
                          "static_smem": 64, "local_bytes": 8}]}
    assert audit.ptxas_disagreements(res, rep) == []
    assert audit.spill_bytes(res, rep) == {"glm_stats_kernel<1>": {
        "local_bytes": 8, "spill_stores": 4, "spill_loads": 4}}
    res["glm_stats"][1]["regs"] = 41
    assert audit.ptxas_disagreements(res, rep) == ["glm_stats:glm_stats_kernel"]


GLOBAL = re.compile(r"__global__\s+void(?:\s+__launch_bounds__\("
                    r"(?:[^()]|\([^()]*\))*\))?\s+(\w+)\(")


@pytest.mark.parametrize("src", build.SOURCES)
def test_every_kernel_is_in_its_resources_table(src):
    """Each ``__global__`` function of a source appears in its kSlots
    table, the source exports its resources entry, and ops names it in
    CUDA_FUNCTIONS (what the profile and kernel_smem read)."""
    text = (CSRC / src).read_text()
    stem = src.removesuffix(".cu")
    assert "const repro::KernelSlot kSlots[]" in text
    for name in GLOBAL.findall(text):
        # a slot's name string starts with its kernel's name
        assert f'"{name}' in text, f"{src}: {name} missing from kSlots"
        assert name in ops.CUDA_FUNCTIONS[stem]
    assert f"REPRO_RESOURCES_ENTRY({stem})" in text
    assert "repro::note_launch" in text or "launch_chain" in text


def test_resources_struct_matches_ctypes():
    src = (CSRC / "resources.cuh").read_text()
    body = src[src.index("struct KernelResources {"):]
    body = body[:body.index("};")]
    fields = re.findall(r"^\s+(?:char|int) (\w+)", body, re.M)
    assert fields == [f for f, _ in build.KernelResources._fields_]
    assert "resources.cuh" in build.HEADERS


def test_kernel_smem_skips_on_the_cpu():
    assert audit.kernel_smem_audit("cpu").status == "skip"
    assert audit.audit_kernel_smem("cpu").status == "skip"


# ------------------------------------------------- collective_trace units


def test_collective_trace_records_logically():
    x = torch.ones(3)
    with collectives.collective_trace() as ev:
        collectives.all_reduce(x, None)           # no group: no collective
        collectives.all_reduce(x, collectives.MeshGroup(None, "data"))
        collectives.all_reduce_many((x, x), collectives.MeshGroup(None,
                                                                  "model"))
        bootstrap.broadcast_host(np.zeros(4, np.float32))
        bootstrap.gather_to_host(x)
        bootstrap.barrier("t")
    assert ev == [("all_reduce", "data", 1, 3, "float32"),
                  ("all_reduce_many", "model", 1, 6, "float32"),
                  ("broadcast_host", "world", 1, 4, "float32"),
                  ("gather_to_host", "world", 1, 3, "float32"),
                  ("barrier", "world", 1, 0, "none")]
    collectives.all_reduce(x, collectives.MeshGroup(None, "data"))
    assert len(ev) == 5                           # nothing outside a trace


# ------------------------------------------ the steady-state contract


def test_superstep_builds_once_across_fits_and_path():
    """tests/test_solver.py::test_superstep_compiles_once_across_fits_and_path
    on the port."""
    ds = synthetic.make_dense(n=200, p=32, seed=5)
    cfg = DGLMNETConfig(tile_size=16, max_outer=40, tol=1e-10)
    s = GLMSolver(ds.train.X, ds.train.y, config=cfg, device="cpu")
    c0 = s.compile_count
    assert c0 >= 1                   # the port builds at construction
    s.fit(lam1=1.0, lam2=0.0)
    s.fit(lam1=0.2, lam2=0.5)
    s.fit_path(n_lambdas=20, lam_ratio=1e-2)
    assert s.compile_count == c0
    # a SECOND session on the same layout hits the module-level cache
    s2 = GLMSolver(ds.train.X, ds.train.y, config=cfg, device="cpu")
    assert s2._key == s._key and s2._superstep is s._superstep
    c2 = s2.compile_count
    s2.fit(lam1=0.7)
    assert s2.compile_count == c2


def test_oneshot_wrappers_do_not_rebuild():
    ds = synthetic.make_dense(n=150, p=32, seed=6)
    cfg = DGLMNETConfig(lam1=0.5, tile_size=16, max_outer=20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        tdglmnet.fit(ds.train.X, ds.train.y, cfg, device="cpu")
        key = GLMSolver(ds.train.X, ds.train.y, config=cfg,
                        device="cpu")._key
        before = tsolver._TRACE_COUNTS[key]
        assert before >= 1
        # different lambda, same geometry: the cached superstep
        tdglmnet.fit(ds.train.X, ds.train.y,
                     DGLMNETConfig(lam1=2.0, lam2=0.1, tile_size=16,
                                   max_outer=20), device="cpu")
    assert tsolver._TRACE_COUNTS[key] == before


def test_the_key_follows_what_the_superstep_reads():
    ds = synthetic.make_dense(n=120, p=32, seed=7)
    base = GLMSolver(ds.train.X, ds.train.y, device="cpu",
                     config=DGLMNETConfig(tile_size=16))._key
    same = [DGLMNETConfig(tile_size=16, lam1=3.0, lam2=1.0, mu_init=2.0,
                          max_outer=7, tol=1e-3, alb_kappa=0.5)]
    other = [DGLMNETConfig(tile_size=32), DGLMNETConfig(tile_size=16,
                                                        family="squared"),
             DGLMNETConfig(tile_size=16, coupling="jacobi"),
             DGLMNETConfig(tile_size=16, ls_grid_size=7)]
    for cfg in same:
        assert GLMSolver(ds.train.X, ds.train.y, device="cpu",
                         config=cfg)._key == base
    for cfg in other:
        assert GLMSolver(ds.train.X, ds.train.y, device="cpu",
                         config=cfg)._key != base


def test_runtime_active_changes_do_not_rebuild():
    """tests/test_fused.py::test_runtime_active_changes_do_not_recompile on
    the port's fused Jacobi superstep."""
    ds = synthetic.make_dense(n=300, p=64, k_true=6, seed=11)
    s = GLMSolver(ds.train.X, ds.train.y, device="cpu",
                  config=DGLMNETConfig(tile_size=16, coupling="jacobi",
                                       max_outer=30))
    s.fit_path(n_lambdas=6, lam_ratio=1e-2)
    first = s.compile_count
    s.fit(lam1=0.05 * s.lambda_max())
    assert s.compile_count == first


def test_fit_cv_one_build():
    ds = synthetic.make_dense(n=200, p=32, k_true=6, seed=17)
    s = GLMSolver(ds.train.X, ds.train.y, device="cpu", fit_intercept=True,
                  standardize=True,
                  config=DGLMNETConfig(tile_size=16, coupling="jacobi",
                                       max_outer=30, tol=1e-8))
    c0 = s.compile_count
    s.fit_cv(n_folds=3, n_lambdas=5, lam_ratio=1e-2)
    assert s.compile_count == c0


def test_streaming_path_builds_once():
    """tests/test_streaming.py::test_fit_path_parity_and_compile_once's
    build count on the port."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(200, 48)).astype(np.float32)
    y = np.where(X[:, :4].sum(1) + rng.normal(size=200) > 0, 1.0,
                 -1.0).astype(np.float32)
    sd, _ = streaming_design(X, 16, chunk_rows=64, device="cpu")
    s = GLMSolver(sd, y, device="cpu",
                  config=DGLMNETConfig(tile_size=16, max_outer=10, tol=1e-9))
    c0 = s.compile_count
    s.fit_path(n_lambdas=4, lam_ratio=1e-2)
    assert c0 >= 1 and s.compile_count == c0


def test_warm_path_adds_no_builds_or_loads():
    ds = synthetic.make_sparse(n=300, p=200, avg_nnz=10, k_true=10, seed=2)
    s = GLMSolver(ds.train.X, ds.train.y, device="cpu", row_block=64,
                  config=DGLMNETConfig(tile_size=64))
    lmax = s.lambda_max()
    res = audit.steady_state(s, [0.5 * lmax, 0.25 * lmax, 0.1 * lmax],
                             lam2=0.0)
    assert res.status == "ok", res.details
    assert build.counts() == {"builds": 0, "loads": 0}


# ------------------------------------------ the collective audit, 2 ranks


def _collective_worker(out: pathlib.Path) -> int:
    ctx = bootstrap.initialize(device="cpu", backend="gloo", timeout_s=60)
    mesh = bootstrap.make_dist_mesh(1, 2)
    res = audit.audit_collective_sequence("cpu", mesh=mesh)
    (out / f"rank{ctx.process_id}.json").write_text(json.dumps(
        {"status": res.status, "details": res.details}))
    bootstrap.shutdown()
    return 0


def test_collective_sequence_on_two_ranks(tmp_path):
    res = launcher.run_local(2, THIS, args=["--collective-worker",
                                            str(tmp_path)],
                             timeout_s=WORLD_TIMEOUT_S, grace_s=20)
    assert res.ok, res.summary()
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]
    for r in ranks:
        assert r["status"] == "ok", r
        assert r["details"]["ranks"] == 2 and \
            r["details"]["same_on_every_rank"]
    assert ranks[0]["details"]["_records"] == ranks[1]["details"]["_records"]
    # the model group spans both ranks, the data group one (recorded all
    # the same: the record is taken before the group-of-one shortcut)
    dims = {tuple(e[1:3]) for e in ranks[0]["details"]["_records"]}
    assert dims == {("data", 1), ("model", 2)}


if __name__ == "__main__":
    sys.exit(_collective_worker(pathlib.Path(sys.argv[-1])))
