"""Roofline terms and the analytic model flops (6 N D accounting).

A port of the JAX package's ``repro.roofline.model`` on the card's peaks
(``launch/mesh.py``).  ``roofline_terms`` takes the compute peak as an
argument: the port's LM path runs float32 with TF32 off, so its default
is ``PEAK_FLOPS_FP32``, where the reference's is the TPU's bf16 peak.
``count_params`` counts the port's own ``param_defs``, the MoE's inactive
experts by the reference's rule (every ``w_gate``/``w_up``/``w_down``
under an ``ffn``: the dense layers' and shared experts' too).
"""
from __future__ import annotations

from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW_PER_LINK,
                                     PEAK_FLOPS_FP32)


def roofline_terms(stats, n_chips: int, *, peak_flops: float =
                   PEAK_FLOPS_FP32):
    """Seconds of each term of one card's share of a step (``stats``:
    ``flops``, ``bytes_accessed``, ``collective_bytes`` per card).

    compute    = flops / peak_flops
    memory     = bytes / HBM bandwidth
    collective = collective bytes / one NVLink's bandwidth
    """
    compute = stats.flops / peak_flops
    memory = stats.bytes_accessed / HBM_BW
    collective = stats.collective_bytes / NVLINK_BW_PER_LINK
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        "bound_s": max(compute, memory, collective),
    }


def count_params(cfg) -> tuple[int, int]:
    """(total params, active params) from the model's own param defs."""
    import math

    from repro_torch.models import lm
    from repro_torch.models.common import flatten, param_count

    defs = lm.param_defs(cfg)
    total = param_count(defs)
    if cfg.family != "moe":
        return total, total
    # active = total - (the inactive routed experts' share)
    expert_params = sum(
        math.prod(d.shape) for name, d in flatten(defs).items()
        if "ffn" in name.split(".")
        and set(name.split(".")) & {"w_gate", "w_up", "w_down"})
    frac_active = cfg.top_k / max(cfg.n_experts, 1)
    active = total - int(expert_params * (1.0 - frac_active))
    return total, active


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (prefill, decode), N the active
    params, D the tokens of the step (one a sequence in decode)."""
    _, active = count_params(cfg)
    if shape.kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch
