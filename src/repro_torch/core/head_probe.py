"""GLM head probes on frozen LM features: where the paper's technique meets
the LM template.

A port of the JAX package's ``repro.core.head_probe``.  The workload:
extract pooled features Phi (n x d) from a frozen backbone, then fit an
elastic-net GLM readout with d-GLMNET on Phi as its design matrix (the
calibration / linear-probe / CTR-readout setting the paper targets, fed by
LM embeddings).  The features stay on the backbone's device and go into
``GLMSolver`` there (``device=None``: the CUDA card).

Multi-class is one-vs-rest: each class is an independent binary GLM.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.dglmnet import DGLMNETConfig, FitResult
from repro_torch.device import resolve_device


def extract_features(apply_fn: Callable, model, token_batches,
                     *, pool: str = "mean") -> torch.Tensor:
    """Run the frozen backbone over batches; mean- or last-token-pool the
    final hidden states.  ``apply_fn(model, tokens) -> (B, S, d)`` hidden
    states.  Returns the (n, d) features on the backbone's device."""
    feats = []
    for tokens in token_batches:
        h = apply_fn(model, tokens)
        if pool == "mean":
            feats.append(h.mean(dim=1))
        elif pool == "last":
            feats.append(h[:, -1, :])
        else:
            raise ValueError(f"unknown pool {pool!r}")
    return torch.cat(feats, dim=0)


_SESSION_KWARGS = ("axis_data", "axis_model", "speeds", "seed", "row_block",
                   "reorder", "design_info")


def fit_probe(features, labels, config: DGLMNETConfig, *, mesh=None,
              device=None, **fit_kwargs) -> FitResult:
    """Binary probe: labels in {-1, +1}.  Features are the GLM design
    matrix, on ``device`` (None: the CUDA card).

    Keyword args split between the GLMSolver session (sharding/ALB/packing)
    and the fit itself (beta0, verbose, checkpointing), as the reference's
    one-shot surface forwards both kinds.
    """
    from repro_torch.core.solver import GLMSolver
    session_kwargs = {k: fit_kwargs.pop(k) for k in _SESSION_KWARGS
                      if k in fit_kwargs}
    solver = GLMSolver(features, labels, config=config, mesh=mesh,
                       device=device, **session_kwargs)
    return solver.fit(**fit_kwargs)


def fit_probe_multiclass(features, labels_int, n_classes: int,
                         config: DGLMNETConfig, *, mesh=None, device=None):
    """One-vs-rest multi-class probe.  Returns the (n_classes, d) weight
    matrix."""
    betas = []
    for c in range(n_classes):
        y = np.where(np.asarray(labels_int) == c, 1.0, -1.0).astype(
            np.float32)
        res = fit_probe(features, y, config, mesh=mesh, device=device)
        betas.append(res.beta)
    return np.stack(betas, axis=0)


def predict_proba(features, beta, *, device=None) -> torch.Tensor:
    """sigmoid(features @ beta), on the features' device when they are a
    tensor, else on ``device`` (None: the CUDA card)."""
    if torch.is_tensor(features):
        X = features.float()
    else:
        X = torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(
            resolve_device(device))
    b = torch.as_tensor(np.asarray(beta, np.float32)).to(X.device)
    return torch.sigmoid(X @ b)
