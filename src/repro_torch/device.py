"""Where the port runs: ``device=None`` means the CUDA card.

Every public entry point that places tensors (``GLMSolver``, the design
builders, ``convert``, the superstep and line-search helpers, the serving
engine) resolves its ``device`` argument here, so the CPU is taken only when
the caller asks for it and there is no silent fall back to it.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # full fp32 Gram sums: TF32 would break the 1e-5 bar on beta
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):     # meta: shapes, no storage
        raise ValueError(f"unsupported device {dev}")
    return dev


def as_float32(a, device: torch.device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a numpy array or a tensor (a
    float32 tensor already there is returned as it is)."""
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def read_f_nnz(f, nnz) -> tuple:
    """(f as a float, nnz as an int) from two 0-d device tensors in one
    read."""
    fh, nh = torch.stack([f.double(), nnz.double()]).tolist()
    return fh, int(nh)
