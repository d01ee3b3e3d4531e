"""OBS001 — hand-rolled timing spans outside the observability layer.

The port has exactly two sanctioned ways to time things:

* ``repro_torch.timing`` (``timed``/``percentiles``) for
  blocking wall-clock measurement of work queued on the card, and
* ``repro_torch.obs.trace`` spans for structural tracing (free when
  disabled, Perfetto-exportable when enabled).

A function that pairs bare ``time.perf_counter()`` / ``time.monotonic()``
calls is re-rolling one of those: the duration it computes is invisible
to the trace, uses its own clock conventions, and (for card work) usually
forgets to synchronize.  OBS001 flags any function under
``src/repro_torch`` with two or more such calls — the classic ``t0 = ...;
dt = ... - t0`` span — EXCEPT ``repro_torch/timing.py`` and
``repro_torch/obs/`` themselves, which are the implementations.

Legitimate remaining sites carry an inline ``# lint: allow OBS001 —
reason`` waiver or a baseline entry.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.astutil import FileContext, dotted_name

_CLOCKS = {"time.perf_counter", "time.perf_counter_ns",
           "time.monotonic", "time.monotonic_ns"}

_SCOPE = "src/repro_torch/"
_EXEMPT_PREFIXES = ("src/repro_torch/obs/",)
_EXEMPT_FILES = ("src/repro_torch/timing.py",)


class Obs001:
    CODE = "OBS001"
    TITLE = ("hand-rolled timing span (use repro_torch.timing or "
             "repro_torch.obs.trace)")
    DOC = (
        "Two or more bare time.perf_counter()/time.monotonic() calls in "
        "one function are a hand-rolled timing span: the duration is "
        "invisible to the obs trace and skips repro_torch.timing's "
        "synchronizing convention.  Use repro_torch.timing.timed "
        "for measurements and repro_torch.obs.trace.span for structural "
        "tracing; waive genuinely low-level sites with "
        "`# lint: allow OBS001 — reason`."
    )

    def check(self, ctx: FileContext):
        path = ctx.relpath
        if not path.startswith(_SCOPE):
            return
        if path in _EXEMPT_FILES or \
                any(path.startswith(p) for p in _EXEMPT_PREFIXES):
            return
        # innermost-function ownership: a nested def's clock reads count
        # against the nested def, not its parent
        calls: dict = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) \
                    and dotted_name(node.func) in _CLOCKS:
                fns = ctx.enclosing_functions(node)
                owner = fns[0] if fns else None
                calls.setdefault(owner, []).append(node)
        for owner, sites in calls.items():
            if len(sites) < 2:
                continue          # a lone timestamp is not a span
            first = min(sites, key=lambda n: (n.lineno, n.col_offset))
            yield ctx.violation(
                self.CODE, first,
                f"{len(sites)} bare clock reads form a hand-rolled timing "
                "span — use repro_torch.timing.timed (synchronizing "
                "measurement) or repro_torch.obs.trace.span (traced span) "
                "instead")
