"""repro_torch.analysis — the port's linter and its audits on the card
(mirrors ``repro.analysis``).

The port's correctness rests on invariants no unit test pins directly:
collectives outside process-local control flow (DIST002), placement
through ``resolve_device``/``put_global`` in code that runs as a rank
(DIST001), lambda as a runtime argument so one superstep build serves a
whole path (JIT001), durations via ``repro_torch.timing`` and one batched
readback a superstep (SYNC001), process-stable hashing in io/ (HASH001),
fp32 results of bf16 products and no TF32 (PREC001), timing through
``timing``/``obs`` only (OBS001).  This package turns them into a gate:

* ``python -m repro_torch.analysis --check``  — AST lint over
  src/repro_torch, chip_smoke.py and profile_superstep.py,
  baseline-ratcheted (see lint.py);
* ``python -m repro_torch.analysis --audit``  — the audits, on the card
  (``--device cpu``: on the CPU's plain versions): launch units (fused
  superstep = 2, unfused = 5) and, on the card, the profiler's kernel
  records; each kernel's registers and shared memory within the card's
  limits; a collective sequence that is the same in every superstep; zero
  steady-state rebuilds (see audit.py).

Rule docs: ``repro-torch-lint --explain DIST002``.  The rules, their AST
plumbing and the lint engine are pure stdlib ``ast`` (they import nothing
of torch themselves); the audit imports the solver and the kernels.
"""
from repro_torch.analysis.astutil import Violation  # noqa: F401
from repro_torch.analysis.lint import lint_paths, lint_text, main  # noqa: F401
