"""Architecture registry: ``--arch <id>`` resolution for launch/benchmarks."""
from __future__ import annotations

from repro_torch.configs import (gemma3_12b, qwen2_5_32b, phi4_mini_3_8b,
                                 mistral_large_123b, zamba2_1_2b,
                                 deepseek_v2_lite_16b, mixtral_8x7b,
                                 xlstm_1_3b, llama_3_2_vision_11b,
                                 whisper_tiny)

_MODULES = {
    "gemma3-12b": gemma3_12b,
    "qwen2.5-32b": qwen2_5_32b,
    "phi4-mini-3.8b": phi4_mini_3_8b,
    "mistral-large-123b": mistral_large_123b,
    "zamba2-1.2b": zamba2_1_2b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "mixtral-8x7b": mixtral_8x7b,
    "xlstm-1.3b": xlstm_1_3b,
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
    "whisper-tiny": whisper_tiny,
}

ARCHS = {name: mod.FULL for name, mod in _MODULES.items()}


def get_arch(name: str):
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; have {sorted(ARCHS)}")


def smoke_variant(name: str):
    return _MODULES[name].SMOKE
