"""Deterministic fault injection: slow nodes, stutter windows, dead peers
(mirrors ``repro.dist.faults``).

  * ``FaultPlan`` — an immutable per-process schedule of slowdown factors:
    a constant factor a process (``slowdown``) and transient
    ``StutterWindow``s (a factor between two supersteps), composed by
    multiplication.  ``factor(pid, step)`` is a pure function, so every
    process can evaluate the whole plan.
  * **work model** — a tile costs ``tile_cost_s`` seconds of local work,
    f times that on a node with factor f; ``work_s(pid, step, tiles)`` is
    the node's local seconds of a superstep.  The solver sleeps that long
    before the superstep (real wall-clock) and gives the same value to
    telemetry as the node's local-work measurement.
  * ``guarded_barrier`` — a barrier that raises ``DeadProcessError``
    naming the barrier when a peer never arrives.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.dist import bootstrap


class DeadProcessError(RuntimeError):
    """A peer process failed to reach a rendezvous within the timeout."""


@dataclasses.dataclass(frozen=True)
class StutterWindow:
    """Transient slowdown: ``factor`` x between supersteps [start, stop)."""
    pid: int
    start: int
    stop: int
    factor: float


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Per-process deterministic slowness schedule.

    ``slowdown[p]`` >= 1 multiplies process p's per-tile cost for the whole
    run; ``stutters`` add transient windows on top.  ``tile_cost_s = 0``
    disables injection (the plan still answers ``factor``).
    ``slow_phase[p]`` names the superstep phase the constant slowdown
    models (``telemetry.VALID_PHASES``; default ``"sweep"``): a
    ``"network"`` or ``"io"`` fault sleeps the same, but ``work_phases``
    puts only the baseline per-tile cost on compute and the excess on that
    phase, so a phase-aware telemetry leaves the node's budget alone.
    """
    num_processes: int
    tile_cost_s: float = 0.0
    slowdown: Tuple[float, ...] = ()
    stutters: Tuple[StutterWindow, ...] = ()
    slow_phase: Tuple[str, ...] = ()
    barrier_timeout_s: float = 60.0

    def __post_init__(self):
        if self.slowdown and len(self.slowdown) != self.num_processes:
            raise ValueError(
                f"slowdown must have {self.num_processes} entries; got "
                f"{len(self.slowdown)}")
        if any(f < 1.0 for f in self.slowdown):
            raise ValueError("slowdown factors must be >= 1")
        if self.slow_phase:
            from repro_torch.dist.telemetry import VALID_PHASES
            if len(self.slow_phase) != self.num_processes:
                raise ValueError(
                    f"slow_phase must have {self.num_processes} entries; "
                    f"got {len(self.slow_phase)}")
            bad = set(self.slow_phase) - VALID_PHASES
            if bad:
                raise ValueError(
                    f"unknown fault phase(s) {sorted(bad)}; valid: "
                    f"{sorted(VALID_PHASES)}")

    # ------------------------------------------------------------ queries

    def factor(self, pid: int, step: int) -> float:
        f = self.slowdown[pid] if self.slowdown else 1.0
        for w in self.stutters:
            if w.pid == pid and w.start <= step < w.stop:
                f *= w.factor
        return f

    def work_s(self, pid: int, step: int, tiles: int) -> float:
        """Simulated local-work seconds of one superstep on node pid."""
        return self.factor(pid, step) * self.tile_cost_s * int(tiles)

    def phase_of(self, pid: int) -> str:
        """Phase the constant slowdown on ``pid`` models."""
        return self.slow_phase[pid] if self.slow_phase else "sweep"

    def work_phases(self, pid: int, step: int, tiles: int) -> dict:
        """``work_s`` split by phase: a compute-phase fault charges all of
        it to that phase; a "network"/"io" fault keeps the baseline
        (factor 1, stutters included) per-tile cost on "sweep" and puts
        the excess on the wait phase.  The parts sum to ``work_s``."""
        total = self.work_s(pid, step, tiles)
        phase = self.phase_of(pid)
        if phase not in ("network", "io"):
            return {phase: total}
        stutter_f = 1.0
        for w in self.stutters:
            if w.pid == pid and w.start <= step < w.stop:
                stutter_f *= w.factor
        base = stutter_f * self.tile_cost_s * int(tiles)
        return {"sweep": base, phase: max(total - base, 0.0)}

    def max_factor(self, step: int) -> float:
        return max(self.factor(p, step) for p in range(self.num_processes))

    # -------------------------------------------------------- construction

    @classmethod
    def parse(cls, spec: str, num_processes: int, *,
              tile_cost_s: float = 0.0) -> "FaultPlan":
        """CLI spec -> plan.  ``"1:4.0"``: process 1 runs 4x slow;
        ``"0:2.0,1:4.0@10-20"``: process 0 2x slow throughout, process 1
        4x during supersteps [10, 20); ``"1:4.0/network"``: process 1 4x
        slow with the excess on the network phase."""
        slowdown = [1.0] * num_processes
        phases = ["sweep"] * num_processes
        stutters = []
        any_phase = False
        for part in filter(None, (p.strip() for p in spec.split(","))):
            pid_s, _, rest = part.partition(":")
            pid = int(pid_s)
            if not 0 <= pid < num_processes:
                raise ValueError(f"fault spec names process {pid} but the "
                                 f"job has {num_processes}")
            factor_s, _, window = rest.partition("@")
            factor_s, _, phase = factor_s.partition("/")
            factor = float(factor_s)
            if window:
                lo, _, hi = window.partition("-")
                stutters.append(StutterWindow(pid, int(lo), int(hi), factor))
            else:
                slowdown[pid] = factor
            if phase:
                phases[pid] = phase
                any_phase = True
        return cls(num_processes=num_processes, tile_cost_s=tile_cost_s,
                   slowdown=tuple(slowdown), stutters=tuple(stutters),
                   slow_phase=tuple(phases) if any_phase else ())


def guarded_barrier(tag: str, *, timeout_s: float = 60.0):
    """A barrier that raises ``DeadProcessError`` instead of hanging when
    a peer never arrives (crashed, killed, wedged).  A tag mismatch is
    not a dead peer and passes through as ``BarrierTagMismatch``."""
    try:
        bootstrap.barrier(tag, timeout_s=timeout_s)
    except bootstrap.BarrierTagMismatch:
        raise
    except Exception as e:   # the store's timeout or a closed connection
        raise DeadProcessError(
            f"barrier {tag!r} timed out after {timeout_s:.0f}s; a peer "
            f"process is unreachable (crashed or wedged). Root error: "
            f"{e}") from e
