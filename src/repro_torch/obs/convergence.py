"""Per-superstep convergence event stream (JSONL).

A copy of ``repro.obs.convergence``: the same schema, key for key and at
the same version, so a stream either package writes reads back through
the other's ``read_events``.

Training-dynamics debugging needs the solver's scalar story at superstep
granularity — objective, deviance, accepted α, active-set size, screening
and KKT state along the λ path — as a STREAM, not a post-hoc summary:
a diverging run should be diagnosable from the events it already wrote.

``GLMSolver._run`` emits one event per outer iteration (in memory or
streaming) through a ``ConvergenceStream``; the schema is versioned and
golden-key-pinned (``tests/test_torch_obs.py``), so downstream tooling
(``launch/trace_report.py``, notebooks) can rely on the keys:

  schema            schema version (int, bump on any key change)
  step              global superstep counter within the solver session
  outer_it          outer iteration within the current (λ1, λ2) fit
  lam_index         position on the λ grid (None for single fits)
  lam1, lam2        the active regularization pair
  f                 penalized objective after the step
  loss              unpenalized loss part
  deviance          the family deviance D at the accepted iterate
  alpha             accepted line-search step size
  mu                trust-region parameter after the μ update
  nnz               nonzero coordinates of β
  accepted_unit     1 when the unit Newton step passed Armijo
  active_size       coordinates in the current active set (p when
                    unscreened)
  screened          coordinates the strong rule screened OUT (None when
                    screening is off / single fit)
  kkt_violations    violations found by the last full-gradient KKT check
                    (None before the first check)
  supersteps, sweep_tile_launches, sweep_tiles_skipped
                    cumulative launch bookkeeping
                    (``GLMSolver.launch_stats``)
  step_us           host µs of this superstep's dispatch (the
                    ``solver/superstep`` span, or the sum of a streaming
                    superstep's three pass spans); None when tracing is off
  phase_us          per-phase µs: a streaming superstep's
                    {stats, sweep, line_search} pass spans; else None

Events append to a ``.jsonl`` file; a line is written (and flushed) per
event so a crashed run keeps everything it emitted.
"""
from __future__ import annotations

import json
import pathlib

SCHEMA_VERSION = 1

SCHEMA_KEYS = (
    "schema", "step", "outer_it", "lam_index", "lam1", "lam2",
    "f", "loss", "deviance", "alpha", "mu", "nnz", "accepted_unit",
    "active_size", "screened", "kkt_violations",
    "supersteps", "sweep_tile_launches", "sweep_tiles_skipped",
    "step_us", "phase_us",
)


class ConvergenceStream:
    """Append-only JSONL writer with the pinned event schema.

    ``emit(**fields)`` fills missing keys with None and REJECTS unknown
    ones — a typo'd field name must fail the emitting code, not silently
    fork the schema."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")
        self.n_events = 0

    def emit(self, **fields):
        unknown = set(fields) - set(SCHEMA_KEYS)
        if unknown:
            raise ValueError(
                f"unknown convergence fields {sorted(unknown)}; the schema "
                f"(v{SCHEMA_VERSION}) has {SCHEMA_KEYS}")
        event = {"schema": SCHEMA_VERSION}
        for k in SCHEMA_KEYS[1:]:
            event[k] = fields.get(k)
        self._fh.write(json.dumps(event) + "\n")
        self._fh.flush()
        self.n_events += 1

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(path) -> list:
    """Parse one stream back into a list of event dicts (reporting and
    tests); raises on schema-version mismatch so stale tooling fails
    loudly instead of misreading fields."""
    out = []
    for line in pathlib.Path(path).read_text().splitlines():
        if not line.strip():
            continue
        ev = json.loads(line)
        if ev.get("schema") != SCHEMA_VERSION:
            raise ValueError(
                f"convergence event schema {ev.get('schema')} != reader "
                f"schema {SCHEMA_VERSION} in {path}")
        out.append(ev)
    return out
