"""The port's LM training runtime (mirrors ``repro.runtime``)."""
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: F401
