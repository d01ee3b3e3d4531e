"""``repro_torch.dist`` — the multi-process runtime on ``torch.distributed``
(mirrors ``repro.dist``).

Four layers, each usable alone:

  * ``bootstrap``  — process-group bring-up (env or arguments; a
    single-process context without a coordinator), the (data x model)
    ``DeviceMesh``, host gathers, the kept store's KV and barriers;
  * ``telemetry``  — per-superstep node speeds folded into the EMA speed
    vector that drives ``core/alb.py``'s budgets at run time;
  * ``faults``     — deterministic fault injection (per-process slowdown,
    stutter windows, the dead-process barrier guard);
  * ``launcher``   — spawn N local processes, each under a timeout
    (``launch/dist_run.py`` is the CLI).
"""
from repro_torch.dist.bootstrap import (DistContext, barrier,
                                        column_process_map, context,
                                        gather_to_host, initialize,
                                        is_multiprocess_mesh, local_columns,
                                        make_dist_mesh, put_global)
from repro_torch.dist.faults import (DeadProcessError, FaultPlan,
                                     StutterWindow, guarded_barrier)
from repro_torch.dist.launcher import JobResult, run_local
from repro_torch.dist.telemetry import SuperstepTelemetry

__all__ = [
    "DistContext", "barrier", "column_process_map", "context",
    "gather_to_host", "initialize", "is_multiprocess_mesh", "local_columns",
    "make_dist_mesh", "put_global", "DeadProcessError", "FaultPlan",
    "StutterWindow", "guarded_barrier", "JobResult", "run_local",
    "SuperstepTelemetry",
]
