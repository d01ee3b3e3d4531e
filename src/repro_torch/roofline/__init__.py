"""The port's roofline pieces (mirrors ``repro.roofline``): the
superstep's launch model and the card's kernel memory budget (``hlo.py``),
and the LM's analytic model flops against the card's peaks (``model.py``).
"""
from repro_torch.roofline.hlo import (registers_per_sm,  # noqa: F401
                                      shared_memory_budget,
                                      superstep_launch_targets)
