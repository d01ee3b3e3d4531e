"""The architecture and input-shape schema and the registry of the LM
template's configurations: a copy of the JAX package's ``repro.configs``
(plain dataclasses, field for field and default for default), which the
port imports nothing of."""
from repro_torch.configs.base import ArchConfig, SHAPES, ShapeSpec  # noqa: F401
from repro_torch.configs.glm_webscale import GLM_SHAPES  # noqa: F401
from repro_torch.configs.registry import (ARCHS, get_arch,  # noqa: F401
                                          smoke_variant)
