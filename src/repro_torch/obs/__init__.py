"""repro_torch.obs: tracing, metrics and convergence streams.

The port's copy of ``repro.obs``: always importable, near-free when
disabled, wired through the solver, io, serve and checkpoint modules.

  * ``obs.trace``: span tracer with Chrome trace-event (Perfetto)
    export, each span also a ``torch.profiler.record_function`` range and,
    on a CUDA machine, an NVTX range; enable with ``REPRO_TRACE=dir`` or
    ``trace.enable(dir)``.
  * ``obs.metrics``: counters, gauges and histograms with a multi-process
    snapshot merge.
  * ``obs.convergence``: the per-superstep event stream (JSONL, versioned
    schema) that ``GLMSolver`` writes.

Summarize a run's trace, metrics and convergence directory with
``python -m repro_torch.launch.trace_report <dir>``.
"""
from repro_torch.obs import convergence, metrics, trace  # noqa: F401
