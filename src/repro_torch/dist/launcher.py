"""Spawn-N-local-processes runner: the one-machine stand-in for a cluster
scheduler (mirrors ``repro.dist.launcher``).

    result = launcher.run_local(2, "repro_torch.launch.dist_run",
                                args=["--device", "cpu", "--backend", "gloo"],
                                timeout_s=180)
    assert result.ok, result.summary()

Each worker gets the ``REPRO_DIST_*`` env vars (``bootstrap.initialize()``
reads them), ``PYTHONPATH`` with this checkout's ``src`` first, and a
fresh coordinator port.  When one worker exits non-zero the others are
killed ``grace_s`` later, and every worker is killed at ``timeout_s``: a
dead process fails the job instead of leaving its peers wedged in a
collective.  Each worker's output goes to a file of its own (a pipe that
nobody reads would block a chatty worker).
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

_SRC = pathlib.Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class JobResult:
    returncodes: List[int]
    outputs: List[str]          # merged stdout+stderr per process
    timed_out: bool = False
    seconds: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.timed_out and all(rc == 0 for rc in self.returncodes)

    def summary(self, tail: int = 4000) -> str:
        head = "job timed out\n" if self.timed_out else ""
        return head + "\n".join(
            f"--- process {i} (exit {rc}) ---\n{out[-tail:]}"
            for i, (rc, out) in enumerate(zip(self.returncodes,
                                              self.outputs)))


def worker_env(process_id: int, num_processes: int, coordinator: str,
               extra: Optional[dict] = None) -> dict:
    """Env block of one worker; exposed so other harnesses (pytest,
    shell scripts) can reuse it."""
    env = dict(os.environ)
    env["REPRO_DIST_COORD"] = coordinator
    env["REPRO_DIST_NPROCS"] = str(num_processes)
    env["REPRO_DIST_PROCID"] = str(process_id)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env.update(extra or {})
    return env


def _command(script, args) -> list:
    """``script``: a path to a Python file, or a module name (``-m``)."""
    s = str(script)
    if s.endswith(".py") or os.sep in s:
        return [sys.executable, s, *map(str, args)]
    return [sys.executable, "-m", s, *map(str, args)]


def run_local(num_processes: int, script, *, args: Sequence[str] = (),
              timeout_s: float = 900.0, grace_s: float = 15.0,
              coordinator: Optional[str] = None,
              env: Optional[dict] = None) -> JobResult:
    """Run ``script`` (a file or a module) as ``num_processes``
    coordinated local processes and collect each one's merged output."""
    coordinator = coordinator or f"127.0.0.1:{free_port()}"
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="repro-torch-job-") as td:
        logs, procs = [], []
        for pid in range(num_processes):
            log = open(pathlib.Path(td) / f"worker_{pid}.log", "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                _command(script, args), stdout=log,
                stderr=subprocess.STDOUT, text=True,
                env=worker_env(pid, num_processes, coordinator, env)))
        deadline = t0 + timeout_s
        fail_deadline = None
        timed_out = False
        while True:
            states = [p.poll() for p in procs]
            if all(s is not None for s in states):
                break
            now = time.monotonic()
            if any(s not in (None, 0) for s in states) and \
                    fail_deadline is None:
                fail_deadline = now + grace_s
            if now > deadline or (fail_deadline and now > fail_deadline):
                timed_out = timed_out or now > deadline
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
                break
            time.sleep(0.05)
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
    return JobResult([p.returncode for p in procs], outputs, timed_out,
                     time.monotonic() - t0)
