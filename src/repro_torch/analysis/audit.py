"""The port's auditor: checks the invariants the AST can't see (mirrors
``repro.analysis.audit``).

Where the lint rules (``repro_torch.analysis.rules``) read source, this
module runs the entry points and reads what they did.  The JAX package
traces its supersteps and reads jaxprs; the port runs eagerly, so every
audit here executes its superstep once, on the card by default:

  * **launch structure** — the fused superstep stays at exactly 2 logical
    launches (``fused_stats_sweep`` + ``fused_ls``), the unfused one at 5
    (4 kernels + the xdb merge matvec), matching
    ``roofline.hlo.superstep_launch_targets``.  Counted from
    ``ops.launch_trace`` (coalesced as the reference coalesces its launch
    events); on the card also by the kernels' own launch counts (the
    counterpart of the jaxpr's ``pallas_call`` count: 2 fused, 4 unfused
    on a dense design) and under ``torch.profiler``: each CUDA function of
    ``ops.CUDA_FUNCTIONS`` has one device record a logical launch, and the
    device has one kernel record a host launch call (the rule of
    ``profile_superstep.py``; the host idles ``PROFILE_EDGE_S`` at both
    edges of the window, or the profiler drops the records launched there).
  * **collective sequence** — the sharded superstep's ordered collectives
    (``collectives.collective_trace``, taken before the group-of-one
    shortcut) are non-empty, the same in two supersteps, and the same on
    every rank: the runtime form of "no collective under a branch" (lint
    rule DIST002).
  * **kernel shared memory** (the counterpart of the VMEM budget) — after
    the superstep's kernels launched at production shapes (T = 256), each
    ``__global__`` function's static + largest requested dynamic shared
    memory is within the card's opt-in limit and its registers times its
    block's threads fit one SM; registers and static shared memory agree
    with ptxas's report in ``build.log``; spills are listed, not gated.
    Card only: ``skip`` under ``device="cpu"``, the only skip there is.
  * **zero steady-state rebuilds** — a warm lambda path on a ``GLMSolver``
    session adds 0 to ``compile_count``, 0 nvcc builds and 0 library loads.
  * **scoring entry points** — ``predict_tile`` and ``tile_gram`` are one
    launch each; the streaming finish stage launches nothing.

No audit catches a kernel's build or launch error: those raise.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import re
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import dglmnet
from repro_torch.core.dglmnet import DGLMNETConfig, FitState
from repro_torch.data import design as design_lib
from repro_torch.device import resolve_device
from repro_torch.kernels import build, ops
from repro_torch.roofline import hlo as hlo_lib
from repro_torch.sharding import collectives

# host idle time at each edge of a profiled window: the device's times,
# moved onto the host's clock, run early, and the profiler keeps only the
# records inside its window (tools/profile_records.py)
PROFILE_EDGE_S = 0.1

# ops-level events that are one fused pass in the launch model: the
# per-tile Gram accumulation feeds the tile solve without a round-trip.
_GRAM_SOLVE_EVENTS = {"tile_gram", "all_tile_grams", "cd_tile_solve"}

# the superstep's production tile (the reference's kernel_vmem shapes)
_PRODUCTION = dict(n=1024, p=512, T=256)


@dataclasses.dataclass
class AuditResult:
    name: str
    status: str          # "ok" | "fail" | "skip"
    details: dict

    def render(self) -> str:
        kv = ", ".join(f"{k}={v}" for k, v in self.details.items())
        return f"audit[{self.name}]: {self.status.upper()} ({kv})"


def coalesce_launch_events(events: List[str]) -> List[str]:
    """Map ops-level events onto the launch-model units: adjacent Gram/
    solve events are one fused pass (``gram_solve``)."""
    units: List[str] = []
    for ev in events:
        if ev in _GRAM_SOLVE_EVENTS:
            if units and units[-1] == "gram_solve":
                continue
            units.append("gram_solve")
        else:
            units.append(ev)
    return units


def _kernel_launches(before: dict, after: dict) -> dict:
    """{kernel: CUDA kernel launches between two ``launch_counts()``}, the
    plain routes left out."""
    return {k: after[k] - before[k] for k in ops.KERNELS
            if after[k] != before[k]}


# --- the profiler's records ------------------------------------------------


def short_name(key: str) -> str:
    """A kernel's name without its template and argument lists."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    for cut in ("(", "<"):
        key = key.split(cut)[0]
    return key[:60]


def launch_records(prof):
    """(the host's kernel launch calls, the device's kernel records) of a
    profile, each a time-sorted list of (start us, short name); copies,
    fills and the schedule's step ranges are not kernels."""
    from torch.autograd import DeviceType

    host, dev = [], []
    for e in prof.events():
        name = short_name(e.name)
        if e.device_type == DeviceType.CUDA:
            if not name.startswith(("Memcpy", "Memset", "ProfilerStep")):
                dev.append((e.time_range.start, name))
        elif name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            host.append((e.time_range.start, name))
    return sorted(host), sorted(dev)


def record_check(prof, logical: dict) -> dict:
    """{CUDA function: [device records, logical launches]} for the
    functions of ``ops.CUDA_FUNCTIONS`` whose two counts differ, and under
    "all kernels" [device kernel records, host launch calls] if those
    differ (empty: all agree).  ``logical``: the kernels' launch counts
    over the profiled window (both modes of a kernel run its functions)."""
    host, dev = launch_records(prof)
    found: dict = {}
    for _, name in dev:
        found[name] = found.get(name, 0) + 1
    bad = {} if len(dev) == len(host) else {"all kernels":
                                             [len(dev), len(host)]}
    for kernel, fns in ops.CUDA_FUNCTIONS.items():
        want = logical.get(kernel, 0) + logical.get(kernel + "_bf16", 0)
        for fn in fns:
            got = found.get(fn, 0)
            if got != want:
                bad[fn] = [got, want]
    return bad


def profiled(run):
    """(the profile, the kernels' launch counts) of one call of ``run``
    on the card: a first call is the profiler's warm-up cycle, thrown
    away; the host idles ``PROFILE_EDGE_S`` at both edges of the measured
    call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_EDGE_S)
        before = ops.launch_counts()
        run()
        torch.cuda.synchronize()
        after = ops.launch_counts()
        time.sleep(PROFILE_EDGE_S)
    return prof, {k: after[k] - before[k] for k in after}


# --- the problems a superstep runs on --------------------------------------


def _toy_shape(dev) -> tuple:
    """(n, p, T) of the reference's toy Jacobi problem (8, 16, 8); on the
    card T = 64, the least tile K5 takes (a multiple of 64)."""
    return (8, 16, 8) if dev.type == "cpu" else (8, 128, 64)


def _toy_problem(n: int, p: int, T: int, dev) -> dict:
    """The reference's toy arguments: X = 0, y = 0, unit weights, no
    offset, unit penalty factors, beta = 0, mu = 1."""
    z = lambda k: torch.zeros((k,), dtype=torch.float32, device=dev)
    return {"design": design_lib.DenseDesign(
                torch.zeros((n, p), dtype=torch.float32, device=dev), T),
            "y": z(n), "weights": z(n) + 1.0, "offset": z(n),
            "penf": z(p) + 1.0, "lams": (0.1, 0.01), "device": dev,
            "state": FitState(beta=z(p), xb=z(n),
                              mu=torch.ones((), device=dev), cursor=0,
                              step=0),
            "config": DGLMNETConfig(lam1=0.1, lam2=0.01, tile_size=T),
            "groups": None, "budget": None}


def solver_problem(solver, lams=(0.1, 0.01)) -> dict:
    """A session's own design and observation model at beta = 0, for the
    audits of a full-size fit (its config sets the family and tile)."""
    return {"design": solver.design, "y": solver._ys,
            "weights": solver._wobs, "offset": solver._offsets,
            "penf": solver._penf, "lams": tuple(lams),
            "device": solver.device, "state": solver._init_state(),
            "config": solver.config, "groups": solver._groups,
            "budget": solver._budgets() if solver.mesh is not None
            else None}


def _superstep(prob: dict, **config):
    """``run(state=None)``: one call, on ``prob``'s design and
    observation model, of a superstep built from ``prob``'s config with
    ``config`` replaced; it returns (state, metrics)."""
    cfg = dataclasses.replace(prob["config"], **config)
    design = prob["design"]
    step = dglmnet.make_superstep(cfg, n_tiles=design.n_tiles,
                                  device=prob["device"],
                                  groups=prob["groups"])

    def run(state=None):
        return step(design, prob["y"], prob["weights"], prob["offset"],
                    prob["lams"], prob["penf"],
                    prob["state"] if state is None else state,
                    budget=prob["budget"])
    return run


def trace_superstep(*, fused: bool, device="cpu"):
    """(launch-model units, CUDA kernel launches) of one superstep of the
    toy Jacobi problem; the launches are {} on the CPU."""
    dev = resolve_device(device)
    return superstep_units(_toy_problem(*_toy_shape(dev), dev), fused=fused)


def superstep_units(prob: dict, *, fused: bool):
    """(launch-model units, CUDA kernel launches) of one Jacobi superstep
    of ``prob``, fused or unfused."""
    run = _superstep(prob, coupling="jacobi", fuse_superstep=fused)
    before = ops.launch_counts()
    with ops.launch_trace() as events:
        run()
    return coalesce_launch_events(events), _kernel_launches(
        before, ops.launch_counts())


# --- individual audits -----------------------------------------------------


def audit_superstep_launches(device=None, prob: Optional[dict] = None
                             ) -> List[AuditResult]:
    """Pin the launch contract: fused = 2, unfused = 5 logical units, on
    the toy problem or ``prob`` (``solver_problem``).  On the card also the
    kernels' launches (a dense design: 2 fused, 4 unfused) and the
    profiler's records of one superstep."""
    dev = resolve_device(device if prob is None else prob["device"])
    if prob is None:
        prob = _toy_problem(*_toy_shape(dev), dev)
    on_card = dev.type == "cuda"
    n, p = prob["design"].shape
    T = prob["design"].tile_size
    dense = isinstance(prob["design"], design_lib.DenseDesign)
    out = []
    for fused in (True, False):
        target = hlo_lib.superstep_launch_targets(
            n, p, T, fused=fused)["n_launches"]
        units, launches = superstep_units(prob, fused=fused)
        # fused: every launch is a kernel; unfused: 4 kernels + the xdb
        # merge matvec, a plain product between them.  On bricks the fused
        # entries compose K1, K3, K2 and K4, as the reference's do.
        kernel_target = (target if fused else target - 1) \
            if on_card and dense else None
        n_kernels = sum(launches.values())
        ok = len(units) == target and (kernel_target is None
                                       or n_kernels == kernel_target)
        details = {"units": units, "n_units": len(units), "target": target,
                   "kernel_launches": n_kernels,
                   "kernel_target": kernel_target, "_launches": launches}
        if on_card:
            run = _superstep(prob, coupling="jacobi", fuse_superstep=fused)
            prof, logical = profiled(run)
            bad = record_check(prof, logical)
            details["records_off"] = bad
            details["device_records"] = len(launch_records(prof)[1])
            ok = ok and not bad
        out.append(AuditResult(
            name=f"launches_{'fused' if fused else 'unfused'}",
            status="ok" if ok else "fail", details=details))
    return out


def ptxas_report(text: str) -> dict:
    """{source stem: [{symbol, regs, smem, stack, spill_stores,
    spill_loads}]} from a ``build.log`` (``nvcc -Xptxas -v``)."""
    out: dict = {}
    entries: dict = {}
    stem = cur = props = None
    for line in text.splitlines():
        m = re.match(r"^== (\S+)\.cu \(rc \d+\)$", line)
        if m:
            stem, cur, props = m.group(1), None, None
            entries = {}
            out[stem] = []
            continue
        if stem is None:
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"symbol": m.group(1), "regs": None, "smem": 0,
                   "stack": 0, "spill_stores": 0, "spill_loads": 0}
            entries[cur["symbol"]] = cur
            out[stem].append(cur)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = entries.get(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props is not None:
            props.update(stack=int(m.group(1)),
                         spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["regs"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return out


def _base(name: str) -> str:
    return name.split("<")[0]


def _ptxas_entries(report: dict, stem: str, name: str) -> list:
    """ptxas's entries of the kernel ``name`` (any template instance) in
    ``stem``'s section: a mangled symbol holds the name as
    <length><name>."""
    tag = f"{len(_base(name))}{_base(name)}"
    return [e for e in report.get(stem, ()) if tag in e["symbol"]]


def _triple(r: dict) -> tuple:
    return r["regs"], r["static_smem"], r["local_bytes"]


def ptxas_disagreements(resources: dict, report: dict) -> list:
    """The (source, kernel) pairs whose (registers, static shared bytes,
    local bytes a thread) from ``cudaFuncGetAttributes`` differ from
    ptxas's (registers, smem, stack frame), per kernel name over its
    template instances."""
    bad = []
    for stem, recs in resources.items():
        for base in sorted({_base(r["name"]) for r in recs}):
            got = sorted(_triple(r) for r in recs
                         if _base(r["name"]) == base)
            want = sorted((e["regs"], e["smem"], e["stack"])
                          for e in _ptxas_entries(report, stem, base))
            if got != want:
                bad.append(f"{stem}:{base}")
    return bad


def spill_bytes(resources: dict, report: dict) -> dict:
    """{instance: {local_bytes, spill_stores, spill_loads}} of every
    kernel instance with local memory, its spills from ptxas's entry of
    the same registers, shared and stack bytes."""
    out = {}
    for stem, recs in resources.items():
        for r in recs:
            if not r["local_bytes"]:
                continue        # a spill needs a stack frame
            same = [e for e in _ptxas_entries(report, stem, r["name"])
                    if (e["regs"], e["smem"], e["stack"]) == _triple(r)]
            out[r["name"]] = {
                "local_bytes": r["local_bytes"],
                "spill_stores": max((e["spill_stores"] for e in same),
                                    default=0),
                "spill_loads": max((e["spill_loads"] for e in same),
                                   default=0)}
    return out


def kernel_smem_audit(device=None, *, all_sources: bool = False
                      ) -> AuditResult:
    """Every kernel's shared memory and registers against the card's
    limits, from ``ops.kernel_resources()`` (what has launched so far),
    held to ptxas's report.  ``all_sources``: fail unless each source has
    launched at least one of its kernels."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return AuditResult("kernel_smem", "skip",
                           {"reason": "no kernels run on the CPU"})
    budget = hlo_lib.shared_memory_budget(dev)
    regs_sm = hlo_lib.registers_per_sm(dev)
    res = ops.kernel_resources()
    report = ptxas_report((build.library_path().parent / "build.log")
                          .read_text())
    kernels, over, regs_over, unlaunched = {}, [], [], []
    for stem, recs in res.items():
        if not any(r["launches"] for r in recs):
            unlaunched.append(stem)
        for r in recs:
            smem = r["static_smem"] + r["requested_dynamic_smem"]
            threads = r["requested_threads"]
            kernels[r["name"]] = {
                "regs": r["regs"], "static_smem": r["static_smem"],
                "dynamic_smem": r["requested_dynamic_smem"],
                "threads": threads, "local_bytes": r["local_bytes"],
                "launches": r["launches"]}
            if smem > budget:
                over.append(r["name"])
            if threads > r["max_threads"] or r["regs"] * threads > regs_sm:
                regs_over.append(r["name"])
    spills = spill_bytes(res, report)
    mismatch = ptxas_disagreements(res, report)
    ok = not over and not regs_over and not mismatch and \
        not (all_sources and unlaunched) and len(unlaunched) < len(res)
    return AuditResult(
        name="kernel_smem", status="ok" if ok else "fail",
        details={"budget_kib": budget / 1024, "regs_per_sm": regs_sm,
                 "n_kernels": len(kernels), "over_budget": over,
                 "regs_over": regs_over, "ptxas_mismatch": mismatch,
                 "spilling": sorted(k for k, v in spills.items()
                                    if v["spill_stores"]),
                 "unlaunched": unlaunched,
                 "_spills": spills, "_kernels": kernels})


def audit_kernel_smem(device=None) -> AuditResult:
    """The superstep's kernels at production shapes (T = 256: fused and
    unfused Jacobi on a dense design, K3 on bricks), then
    ``kernel_smem_audit``.  Card only."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return kernel_smem_audit(dev)
    for fused in (True, False):
        superstep_units(_toy_problem(**_PRODUCTION, dev=dev), fused=fused)
    _tile_gram_call(dev, T=_PRODUCTION["T"], rb=256)
    torch.cuda.synchronize(dev)
    return kernel_smem_audit(dev)


def collective_signatures(prob: dict) -> list:
    """The collectives of two sharded unfused Jacobi supersteps (the
    reference's choice) of ``prob``, one list of (op, dim, size, numel,
    dtype) a superstep."""
    run = _superstep(prob, coupling="jacobi", fuse_superstep=False)
    state, sigs = None, []
    for _ in range(2):
        with collectives.collective_trace() as events:
            state, _ = run(state)
        sigs.append([list(e) for e in events])
    return sigs


def audit_collective_sequence(device=None, mesh=None,
                              solver=None) -> AuditResult:
    """The sharded superstep's collective signature is non-empty, the same
    in two supersteps and on every rank of the mesh: ``solver``'s (a
    session on a mesh, its design and observation model), else a toy
    problem on ``mesh``, else on a (1, 1) mesh in a world of one, started
    (and shut down) here when the process has no world.  On a mesh of
    several ranks every rank calls it (it gathers the signatures'
    digests)."""
    import torch.distributed as dist

    from repro_torch.core.solver import GLMSolver
    from repro_torch.dist import bootstrap

    dev = resolve_device(device if solver is None else solver.device)
    started = mesh is None and solver is None and not dist.is_initialized()
    if started:
        bootstrap.initialize(device=dev.type)
    try:
        if solver is None:
            n, p, T = _toy_shape(dev)
            rng = np.random.default_rng(0)
            X = rng.normal(size=(n, p)).astype(np.float32)
            y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
            solver = GLMSolver(X, y, config=DGLMNETConfig(tile_size=T),
                               mesh=mesh or bootstrap.make_dist_mesh(1, 1),
                               device=dev)
        sigs = collective_signatures(solver_problem(solver))
        digest = int.from_bytes(hashlib.sha256(json.dumps(
            sigs[0]).encode()).digest()[:7], "little")
        ranks = bootstrap.gather_to_host(np.asarray([digest], np.int64))
    finally:
        if started:
            bootstrap.shutdown()
    same = len(set(ranks.tolist())) == 1
    ok = bool(sigs[0]) and sigs[0] == sigs[1] and same
    return AuditResult(
        name="collective_sequence", status="ok" if ok else "fail",
        details={"signature": [e[0] + "/" + e[1] for e in sigs[0]],
                 "n_collectives": len(sigs[0]),
                 "deterministic": sigs[0] == sigs[1],
                 "ranks": len(ranks), "same_on_every_rank": same,
                 "_records": sigs[0]})


def steady_state(solver, lambdas, *, lam2: float = 0.01) -> AuditResult:
    """After a first fit at ``lambdas[0]``, a warm unscreened path over
    ``lambdas`` (4 supersteps each, as the reference's audit) adds 0 to
    ``compile_count``, 0 nvcc builds and 0 library loads."""
    max_outer = 4
    solver.fit(lam1=lambdas[0], lam2=lam2, max_outer=max_outer, tol=0.0)
    warm = solver.compile_count          # builds paid by the first fit
    b0 = build.counts()
    solver.fit_path(lambdas=list(lambdas), lam2=lam2, screen=False,
                    max_outer=max_outer, tol=0.0)
    steady = solver.compile_count - warm
    b1 = build.counts()
    builds, loads = b1["builds"] - b0["builds"], b1["loads"] - b0["loads"]
    return AuditResult(
        name="steady_state_recompiles",
        status="ok" if steady == builds == loads == 0 else "fail",
        details={"warm_compiles": warm, "steady_state_recompiles": steady,
                 "nvcc_builds": builds, "library_loads": loads,
                 "lambdas": len(lambdas)})


def audit_steady_state_recompiles(device=None) -> AuditResult:
    """The reference's 3-lambda warm path (n 48, p 16, T 8, squared)."""
    from repro_torch.core.solver import GLMSolver

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n, p, T = 48, 16, 8
    X = rng.normal(size=(n, p)).astype(np.float32)
    beta_true = np.zeros(p, np.float32)
    beta_true[:3] = 1.0
    y = (X @ beta_true + 0.1 * rng.normal(size=n)).astype(np.float32)
    cfg = DGLMNETConfig(family="squared", tile_size=T, max_outer=4,
                        tol=0.0)
    solver = GLMSolver(X, y, config=cfg, standardize=False,
                       fit_intercept=False, device=dev)
    return steady_state(solver, [0.5, 0.25, 0.1])


def _tile_gram_call(dev, *, T: int, rb: int, K: int = 4, nrb: int = 2):
    """One ``ops.tile_gram`` call on zero bricks; its logical events and
    CUDA launches."""
    f = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    rows = torch.arange(K, dtype=torch.int32, device=dev) % nrb
    before = ops.launch_counts()
    with ops.launch_trace() as events:
        ops.tile_gram(f(K, rb, T), rows, K, f(nrb * rb) + 1.0,
                      f(nrb * rb) + 1.0)
    return list(events), _kernel_launches(before, ops.launch_counts())


def audit_scoring_entry_points(device=None) -> List[AuditResult]:
    """predict_tile and tile_gram stay single-launch; the streaming finish
    stage stays launch-free (selection only — no data pass)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    out = []

    def single(name, events, launches):
        # on the card one launch of the kernel (its CUDA functions, one
        # record each: CUDA_FUNCTIONS), none on the CPU
        want = {name: 1} if on_card else {}
        ok = events == [name] and launches == want
        return AuditResult(f"{name}_single_launch", "ok" if ok else "fail",
                           {"events": events, "kernel_launches": launches})

    before = ops.launch_counts()
    with ops.launch_trace() as events:
        ops.predict_tile(torch.zeros((8, 128), dtype=torch.int32,
                                     device=dev),
                         torch.zeros((8, 128), device=dev),
                         torch.zeros((9, 128), device=dev),
                         torch.zeros((128,), device=dev), "logistic")
    out.append(single("predict_tile", list(events),
                      _kernel_launches(before, ops.launch_counts())))
    # K3 takes T a multiple of 64 on the card
    out.append(single("tile_gram", *_tile_gram_call(
        dev, T=8 if not on_card else 64, rb=8 if not on_card else 64)))

    # streaming finish: Algorithm-3 selection over accumulated candidate
    # losses — feature-sized math only, no kernels, no design pass.
    n, p, T = _toy_shape(dev)
    prob = _toy_problem(n, p, T, dev)
    stream = dglmnet.make_streaming_superstep(prob["config"], n_tiles=p // T,
                                              device=dev)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    prep = {"dbeta": z(p), "loss": z(), "f_cur": z(), "grad_dot_dir": z(),
            "quad_form": z(), "tiles_done": p // T}
    before = ops.launch_counts()
    with ops.launch_trace() as events:
        stream.finish(z(stream.n_candidates), prep, prob["state"],
                      prob["lams"], prob["penf"])
    launches = _kernel_launches(before, ops.launch_counts())
    out.append(AuditResult(
        "streaming_finish_launch_free",
        "ok" if not events and not launches else "fail",
        {"events": list(events), "kernel_launches": launches}))
    return out


# --- driver ----------------------------------------------------------------


def run_audit(device=None) -> List[AuditResult]:
    """Every audit on ``device`` (None: the card, and it raises without
    one; "cpu": the plain versions, where kernel_smem is ``skip``)."""
    dev = resolve_device(device)
    results: List[AuditResult] = []
    results.extend(audit_superstep_launches(dev))
    results.append(audit_kernel_smem(dev))
    results.append(audit_collective_sequence(dev))
    results.extend(audit_scoring_entry_points(dev))
    results.append(audit_steady_state_recompiles(dev))
    return results


def passed(results: List[AuditResult]) -> bool:
    """No ``fail``, and no ``skip`` but kernel_smem's (on the CPU)."""
    return not any(r.status == "fail" or (
        r.status == "skip" and r.name != "kernel_smem") for r in results)


def summary(results: List[AuditResult]) -> dict:
    return {r.name: {"status": r.status, **{
        k: v for k, v in r.details.items() if not k.startswith("_")
        and not isinstance(v, dict)}} for r in results}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.audit",
                                 description="the port's audits")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the plain "
                         "versions")
    results = run_audit(ap.parse_args(argv).device)
    for r in results:
        print(r.render())
    return 0 if passed(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
