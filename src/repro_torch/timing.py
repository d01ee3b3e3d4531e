"""Wall-clock helpers that measure the work, not its dispatch.

A copy of ``percentiles``, ``quantile`` and ``timed`` of the JAX package's
``repro.timing`` (the port imports nothing of it).  A CUDA call returns as
soon as its kernels are queued, so ``timed`` synchronizes the card before
it reads the clock when the result lies there.
"""
from __future__ import annotations

import time
from typing import Sequence

import torch


def _on_card(out) -> bool:
    if torch.is_tensor(out):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_on_card(o) for o in out)
    if isinstance(out, dict):
        return any(_on_card(o) for o in out.values())
    return False


def timed(fn, *args, **kwargs):
    """(result, seconds) of one call, waiting for the card when the result
    lies on it."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if _on_card(out):
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def quantile(sorted_samples: Sequence[float], q: float) -> float:
    """Linear-interpolation q-percentile (q in [0, 100]) of an ascending
    sequence, bit for bit ``np.percentile``'s default."""
    n = len(sorted_samples)
    if n == 0:
        raise ValueError("quantile of an empty sequence")
    if n == 1:
        return float(sorted_samples[0])
    pos = (q / 100.0) * (n - 1)    # numpy's operand order, bit for bit
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    a, b = float(sorted_samples[lo]), float(sorted_samples[hi])
    # numpy's lerp: anchor on b when frac >= 0.5 (a + frac*(b-a) differs by
    # one ulp there)
    if frac >= 0.5:
        return b - (b - a) * (1.0 - frac)
    return a + (b - a) * frac


def percentiles(samples: Sequence[float], qs=(50.0, 99.0)) -> dict:
    """``{"p50": ..., "p99": ..., "mean": ...}`` over raw samples (any
    unit; empty input yields None values)."""
    xs = sorted(float(x) for x in samples)
    if not xs:
        return {**{f"p{g:g}": None for g in qs}, "mean": None}
    out = {f"p{g:g}": quantile(xs, g) for g in qs}
    out["mean"] = sum(xs) / len(xs)
    return out
