"""The port's roofline pieces (mirrors ``repro.roofline``): the
superstep's launch model, the card's kernel memory budget and the traced
step's counts (``hlo.py``: ``analyze_step``, the counterpart of
``analyze_hlo``), and the LM's analytic model flops against the card's
peaks (``model.py``).
"""
from repro_torch.roofline.hlo import (StepStats, analyze_step,  # noqa: F401
                                      fake_mode, registers_per_sm,
                                      shared_memory_budget,
                                      superstep_launch_targets)
