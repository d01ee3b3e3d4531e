from repro_torch.checkpoint.manager import (Block,  # noqa: F401
                                           CheckpointManager, Stacked)
