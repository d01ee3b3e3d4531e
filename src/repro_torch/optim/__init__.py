"""The port's optimizer (mirrors ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState,  # noqa: F401
                                     adamw_init, adamw_update, schedule)
