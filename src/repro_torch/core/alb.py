"""Asynchronous Load Balancing (paper Section 7) — deterministic simulation.

A numpy copy of ``repro.core.alb`` (the same ``default_rng`` stream, so a
seed gives the reference's budgets bit for bit).

The paper's mechanism: a watcher thread ends the superstep once a κ-fraction
of nodes finished one full cycle over their block; fast nodes keep cycling,
slow nodes park their cursor and resume next superstep.

Inside an SPMD superstep there are no wall clocks or threads, so we model
node speed explicitly: node m with relative speed v_m completes

    budget_m = round(n_tiles · v_m / v_(κ-quantile))

tiles in the time the κ-quantile node completes exactly one cycle — which is
precisely when the paper's watcher fires.  Budgets are recomputed every
superstep from (optionally resampled) speeds, modelling transient stragglers;
cursors guarantee every coordinate is still updated every
⌈n_tiles/min_budget⌉ supersteps, preserving the Tseng–Yun global-convergence
schedule requirement (the paper's own caveat — no linear rate — carries
over).

On a real cluster the speeds vector is fed from runtime telemetry
(``repro_torch.dist.telemetry`` aggregates per-superstep wall-clock into an EMA
speed vector and feeds it back here); in the single-process harness the
benchmark/test harness supplies it, which keeps the whole algorithm
replayable bit-for-bit.  Telemetry input is NOISY — ``sanitize=True``
clamps NaN / zero / negative measured speeds to the median of the valid
entries (uniform when nothing is valid) instead of raising, so one bad
measurement can never take the budget computation down mid-run.
"""
from __future__ import annotations

import numpy as np

_MAX_CYCLES = 4  # cap fast nodes at 4 cycles per superstep (static loop bound)


def max_budget(n_tiles: int) -> int:
    return _MAX_CYCLES * n_tiles


def sanitize_speeds(speeds: np.ndarray) -> np.ndarray:
    """Clamp telemetry-measured node speeds into a usable positive vector.

    NaN, ±inf, zero and negative entries (a node that produced no sample
    this superstep, a clock hiccup, a division by a zero-length window) are
    replaced by the MEDIAN of the valid entries — a bad measurement makes
    that node look average rather than infinitely fast/slow.  When no entry
    is valid (the warm-up supersteps before the telemetry EMA has samples)
    the fallback is the uniform all-ones vector, i.e. BSP budgets.
    """
    speeds = np.asarray(speeds, np.float64).copy()
    valid = np.isfinite(speeds) & (speeds > 0)
    if not valid.any():
        return np.ones_like(speeds)
    speeds[~valid] = np.median(speeds[valid])
    return speeds


def _pivot(speeds: np.ndarray, kappa: float, rule: str) -> float:
    """The node speed whose full cycle ends the superstep.

    ``"lower"`` (default, the historical behaviour pinned by
    the reference's tests/test_sharding_utils.py): the (1-κ)-quantile snapped DOWN to an
    actual node speed.  ``"completion"``: the exact watcher semantics — the
    superstep ends when ⌈κM⌉ nodes finished one cycle, so the pivot is the
    ⌈κM⌉-th FASTEST node.  The two agree at large M but diverge at small M
    (M = 2, κ = 0.5: "lower" pivots on the slow node and only up-budgets
    the fast one; "completion" pivots on the fast node and parks the
    straggler's cursor early — the behaviour the telemetry-driven runtime
    wants, see repro_torch.dist.telemetry).  Both rules pick an ACTUAL node
    speed, preserving the pivot-budget-is-exactly-n_tiles invariant.
    """
    if rule == "completion":
        order = np.sort(speeds)
        M = speeds.shape[0]
        k = int(np.ceil(kappa * M))
        return float(order[np.clip(M - k, 0, M - 1)])
    try:
        return np.quantile(speeds, 1.0 - kappa, method="lower")
    except TypeError:  # numpy < 1.22 spells the kwarg "interpolation"
        return np.quantile(speeds, 1.0 - kappa, interpolation="lower")


def alb_budgets(speeds: np.ndarray, n_tiles: int, kappa: float,
                budget_cap: int | None = None, *,
                sanitize: bool = False,
                pivot_rule: str = "lower") -> np.ndarray:
    """Per-node tile budgets for one superstep (paper's κ-completion rule).

    ``sanitize=True`` routes ``speeds`` through ``sanitize_speeds`` first
    (runtime-telemetry callers MUST set it — a NaN from a failed
    measurement would otherwise poison every budget); the default keeps
    the historical fail-loud contract for harness-supplied speeds.
    """
    speeds = np.asarray(speeds, np.float64)
    if sanitize:
        speeds = sanitize_speeds(speeds)
    elif np.any(~np.isfinite(speeds) | (speeds <= 0)):
        raise ValueError("node speeds must be positive (pass sanitize=True "
                         "for telemetry-measured speeds)")
    # The pivot must be an ACTUAL node speed — linear quantile interpolation
    # lands between nodes and hands the pivot node budget n_tiles ± 1,
    # breaking the "pivot completes exactly one cycle" invariant
    # (the reference's tests/test_sharding_utils.py pins it).
    pivot = _pivot(speeds, kappa, pivot_rule)
    budgets = np.round(n_tiles * speeds / max(pivot, 1e-12)).astype(np.int64)
    cap = budget_cap if budget_cap is not None else max_budget(n_tiles)
    return np.clip(budgets, 1, cap).astype(np.int32)


def sample_speeds(rng: np.random.Generator, base_speeds: np.ndarray,
                  jitter: float = 0.15, straggler_prob: float = 0.05,
                  straggler_slowdown: float = 4.0) -> np.ndarray:
    """Transient node-speed model: lognormal jitter + rare deep stragglers."""
    M = base_speeds.shape[0]
    speeds = base_speeds * rng.lognormal(0.0, jitter, size=M)
    stragglers = rng.random(M) < straggler_prob
    speeds = np.where(stragglers, speeds / straggler_slowdown, speeds)
    return np.maximum(speeds, 1e-3)
