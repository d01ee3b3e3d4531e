"""The port's roofline pieces (mirrors ``repro.roofline``): so far the
superstep's launch model and the card's kernel memory budget; the rest
waits for ROADMAP Queue 1 item 6 (see ``hlo.py``)."""
from repro_torch.roofline.hlo import (registers_per_sm,  # noqa: F401
                                      shared_memory_budget,
                                      superstep_launch_targets)
