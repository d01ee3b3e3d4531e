"""Feed-forward blocks: SwiGLU (all assigned LMs) and GELU (whisper).

A port of the JAX package's ``repro.models.mlp``; ``jax.nn.gelu`` defaults
to its tanh approximation, and so does ``gelu_apply``.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.common import ParamDef, matmul


def swiglu_defs(cfg, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ParamDef((d, f), (None, "model")),
        "w_up": ParamDef((d, f), (None, "model")),
        "w_down": ParamDef((f, d), ("model", None)),
    }


def swiglu_apply(p, x):
    return matmul(F.silu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"]),
                  p["w_down"])


def gelu_defs(cfg, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_in": ParamDef((d, f), (None, "model")),
        "b_in": ParamDef((f,), ("model",), init_scale=0.0),
        "w_out": ParamDef((f, d), ("model", None)),
        "b_out": ParamDef((d,), (None,), init_scale=0.0),
    }


def gelu_apply(p, x, leave=None):
    """The GELU MLP; ``leave`` (a tensor-parallel region's exit) sums the
    row-parallel product over ``model`` before the whole ``b_out`` is
    added, once."""
    h = F.gelu(matmul(x, p["w_in"]) + p["b_in"], approximate="tanh")
    y = matmul(h, p["w_out"])
    return (y if leave is None else leave(y)) + p["b_out"]
