"""Runtime node-speed telemetry: the measured half of adaptive load
balancing (mirrors ``repro.dist.telemetry``; its numpy parts are copied,
and the samples go through ``torch.distributed``'s store).

``repro_torch.core.alb`` turns a node-speed vector into per-node tile budgets; its
docstring has always said that on a real cluster the speeds come from
runtime telemetry.  This module IS that telemetry:

  * every superstep, each process records how long its LOCAL work took
    (``record``), in tiles processed and wall-clock seconds after the
    superstep's one device-to-host read;
  * the (tiles, seconds) samples are exchanged through the process
    group's key-value store (``bootstrap.kv_set``/``kv_get``), so every process sees every node's sample
    for the superstep (a missing peer surfaces as a KV timeout → the
    fault layer's dead-process guard);
  * each process folds the samples into the SAME exponential-moving-
    average speed vector (speed = tiles/second) — deterministic given the
    samples, so the resulting ``alb_budgets`` are bit-identical across
    processes, which SPMD requires;
  * before ``warmup`` supersteps have been recorded, ``speeds()`` returns
    None and the caller falls back to uniform speeds (BSP budgets) —
    sanitization of the measured values themselves happens in
    ``alb.alb_budgets(..., sanitize=True)``.

Measurement source: in a real deployment the recorded seconds are the
measured local-phase wall-clock.  On the one-machine simulation harness
the superstep is globally synchronized by its collectives, so each
process's raw wall-clock includes time spent waiting for stragglers at
collectives; there the deterministic ``repro_torch.dist.faults`` plan supplies
the per-process local-work seconds instead (and injects the matching real
sleeps), keeping the telemetry → EMA → budgets → rebalance loop fully
real and the run replayable.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np

from repro_torch.dist import bootstrap

_NS_COUNTER = [0]

# The closed phase vocabulary.  Compute phases are the superstep's local
# work (what ALB can rebalance by moving tiles); "network" and "io" are
# wait states a tile budget cannot fix — a node slow THERE must not be
# down-budgeted.
VALID_PHASES = frozenset(
    {"stats", "sweep", "merge", "line_search", "network", "io"})
COMPUTE_PHASES = frozenset({"stats", "sweep", "merge", "line_search"})


class SuperstepTelemetry:
    """Per-superstep node-speed estimator shared by all processes.

    Args:
      num_nodes: processes in the job (defaults to the bootstrap context).
      ema: smoothing factor for the speed EMA — speed_new = (1-ema)·old +
        ema·sample.  High values react to transient stragglers within a
        few supersteps; low values smooth measurement noise.
      warmup: supersteps before ``speeds()`` yields a vector (the EMA
        needs a few samples before budgets should leave uniform).
      exchange_timeout_s: KV-store wait for peers' samples; a peer that
        never posts within the window raises (likely dead — the caller's
        fault guard reports which).
      phase_aware: budgets react to COMPUTE-phase speed only.  When per-
        phase attributions are flowing, ``effective_speeds`` (what
        ``column_speeds`` → ALB consumes) becomes tiles / Σ(compute-phase
        seconds): a node whose slowness is attributed to "network"/"io"
        keeps its full tile budget, while a compute-slow node is parked
        exactly as before.  Off (default), the aggregate tiles/seconds
        speed drives budgets — the historical behavior.
    """

    def __init__(self, num_nodes: Optional[int] = None, *, ema: float = 0.5,
                 warmup: int = 2, exchange_timeout_s: float = 60.0,
                 phase_aware: bool = False):
        ctx = bootstrap.context()
        self.num_nodes = ctx.num_processes if num_nodes is None \
            else int(num_nodes)
        self.node_id = ctx.process_id
        self.ema = float(ema)
        self.warmup = int(warmup)
        self.exchange_timeout_s = float(exchange_timeout_s)
        self.phase_aware = bool(phase_aware)
        self._speeds: Optional[np.ndarray] = None
        self._tiles_ema: Optional[np.ndarray] = None
        self._phase_ema: dict = {}     # phase name -> (num_nodes,) seconds
        self.rejected_phase_keys = 0   # unknown-phase samples dropped
        self._n_samples = 0
        # KV keys must be unique per (telemetry instance, superstep):
        # several solver sessions in one process each get their own space
        self._ns = f"repro/telemetry/{_NS_COUNTER[0]}"
        _NS_COUNTER[0] += 1
        self.history: list = []       # (step, speeds) after each update

    # ------------------------------------------------------------ record

    def record(self, step: int, tiles: int, seconds: float, phases=None):
        """Record THIS node's local work for superstep ``step`` and fold
        everyone's samples into the shared EMA.

        ``phases`` optionally attributes the seconds to named superstep
        phases (``{"stats": s1, "sweep": s2, "line_search": s3}`` —
        ``VALID_PHASES`` is the closed vocabulary) — the attribution
        rides the same KV exchange and feeds ``phase_breakdown()``;
        nodes may omit it (older callers send 2-element samples, which
        still parse).  A sample carrying an UNKNOWN phase key is
        rejected like any invalid sample: the key does not fold into the
        EMA (it would silently poison ``phase_breakdown`` and the
        phase-aware budgets on every node), and
        ``rejected_phase_keys`` counts the drops.

        Collective: every process must call it once per superstep, in
        step order.  Single-process jobs skip the exchange.
        """
        if phases is not None:
            phases = {str(k): float(v) for k, v in phases.items()}
        sample = json.dumps([int(tiles), float(seconds), phases])
        if self.num_nodes > 1 and bootstrap.context().multiprocess:
            bootstrap.kv_set(f"{self._ns}/{step}/{self.node_id}", sample)
            samples = []
            for p in range(self.num_nodes):
                raw = sample if p == self.node_id else bootstrap.kv_get(
                    f"{self._ns}/{step}/{p}", self.exchange_timeout_s)
                samples.append(json.loads(raw))
        else:
            samples = [json.loads(sample)] * self.num_nodes
        self.record_all(
            step,
            np.asarray([s[0] for s in samples], np.float64),
            np.asarray([s[1] for s in samples], np.float64),
            phases=[s[2] if len(s) > 2 else None for s in samples])

    def record_all(self, step: int, tiles: np.ndarray, seconds: np.ndarray,
                   phases=None):
        """Fold a full per-node (tiles, seconds) sample into the EMA —
        the exchange-free entry point (single-process simulations, unit
        tests, and the tail of ``record``).  ``phases`` is an optional
        per-node list of phase→seconds dicts (None entries allowed)."""
        if phases is not None:
            self._fold_phases(phases)
        tiles_arr = np.asarray(tiles, np.float64)
        if self._tiles_ema is None:
            self._tiles_ema = np.where(tiles_arr > 0, tiles_arr, np.nan)
        else:
            told = self._tiles_ema
            tblend = np.where(np.isnan(told), tiles_arr,
                              (1.0 - self.ema) * told + self.ema * tiles_arr)
            self._tiles_ema = np.where(tiles_arr > 0, tblend, told)
        with np.errstate(divide="ignore", invalid="ignore"):
            sample = tiles_arr / np.asarray(seconds, np.float64)
        # invalid samples (zero-length window, no tiles) don't update that
        # node's EMA — alb's sanitize catches whatever is left
        if self._speeds is None:
            self._speeds = np.where(np.isfinite(sample) & (sample > 0),
                                    sample, np.nan)
        else:
            upd = np.isfinite(sample) & (sample > 0)
            old = self._speeds
            blend = np.where(np.isnan(old), sample,
                             (1.0 - self.ema) * old + self.ema * sample)
            self._speeds = np.where(upd, blend, old)
        self._n_samples += 1
        self.history.append((int(step), None if self._speeds is None
                             else self._speeds.copy()))

    def _fold_phases(self, phases):
        """Blend per-node phase attributions into per-phase EMA seconds.

        Same EMA constant and NaN-until-seen semantics as the speed
        vector; a node that omits a phase (or the whole dict) leaves its
        slot untouched.  Unknown phase names are REJECTED (dropped +
        counted), exactly like invalid speed samples: every process runs
        this same fold over the same exchanged samples, so the rejection
        is deterministic and the EMA stays bit-identical across nodes."""
        for node, attrib in enumerate(phases):
            if not attrib or node >= self.num_nodes:
                continue
            for name, sec in attrib.items():
                if name not in VALID_PHASES:
                    self.rejected_phase_keys += 1
                    continue
                arr = self._phase_ema.setdefault(
                    name, np.full((self.num_nodes,), np.nan))
                old = arr[node]
                arr[node] = sec if np.isnan(old) else \
                    (1.0 - self.ema) * old + self.ema * float(sec)

    def phase_breakdown(self) -> Optional[dict]:
        """Per-phase EMA local-work seconds, keyed by phase name, one
        entry per node (NaN = that node never attributed that phase).
        None before any phase attribution arrived — phases are optional
        on top of the speed telemetry, never required by it."""
        if not self._phase_ema:
            return None
        return {k: v.copy() for k, v in self._phase_ema.items()}

    # ------------------------------------------------------------- query

    @property
    def ready(self) -> bool:
        return self._n_samples >= self.warmup and self._speeds is not None

    def speeds(self) -> Optional[np.ndarray]:
        """EMA node-speed vector (tiles/s), or None during warm-up —
        callers fall back to uniform speeds (BSP budgets) until then.
        May still contain NaN for nodes without a valid sample yet; pass
        through ``alb_budgets(..., sanitize=True)``."""
        if not self.ready:
            return None
        return self._speeds.copy()

    def compute_speeds(self) -> Optional[np.ndarray]:
        """COMPUTE-phase node speeds (tiles/s): EMA tiles over the sum of
        the compute-phase EMA seconds, per node.  A node with no compute-
        phase attribution yet gets NaN (callers fall back to the
        aggregate speed for that node).  None during warm-up or before
        any phase attribution arrived."""
        if not self.ready or not self._phase_ema:
            return None
        compute = np.zeros((self.num_nodes,), np.float64)
        seen = np.zeros((self.num_nodes,), bool)
        for name in sorted(COMPUTE_PHASES & set(self._phase_ema)):
            arr = self._phase_ema[name]
            ok = ~np.isnan(arr)
            compute[ok] += arr[ok]
            seen |= ok
        with np.errstate(divide="ignore", invalid="ignore"):
            sp = self._tiles_ema / compute
        return np.where(seen & np.isfinite(sp) & (sp > 0), sp, np.nan)

    def effective_speeds(self) -> Optional[np.ndarray]:
        """The speed vector budgets should consume: aggregate speeds by
        default, compute-phase speeds (per node, falling back to the
        aggregate where no attribution exists) in ``phase_aware`` mode.
        Deterministic across processes — both inputs are."""
        sp = self.speeds()
        if sp is None or not self.phase_aware:
            return sp
        csp = self.compute_speeds()
        if csp is None:
            return sp
        return np.where(np.isnan(csp), sp, csp)

    def column_speeds(self, mesh, axis_model: str = "model") \
            -> Optional[np.ndarray]:
        """Per-model-column speeds: node speeds mapped through the
        column → owning-process bookkeeping.  None during warm-up.
        Respects ``phase_aware`` (compute-phase speeds when available)."""
        sp = self.effective_speeds()
        if sp is None:
            return None
        owners = bootstrap.column_process_map(mesh, axis_model)
        if owners.max(initial=-1) >= self.num_nodes:
            raise ValueError(
                f"mesh columns are owned by process "
                f"{int(owners.max())} but telemetry tracks only "
                f"{self.num_nodes} nodes")
        return sp[owners]
