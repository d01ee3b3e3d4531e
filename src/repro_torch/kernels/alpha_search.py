"""K4 alpha_search: the line search's candidate losses in one pass.

The CUDA kernel is ``csrc/alpha_search.cu``; it replaces
``repro/kernels/alpha_search.py::alpha_search_pallas``.  ``plain`` is its
plain PyTorch version (``kernels/ref.py``).  One logical launch is one CUDA
launch: the block that finishes last adds the blocks' partial sums, in
block order, after taking the last ticket of an unsigned counter kept on
the device (``ticket``).  The counter and the partials' scratch are
allocated once for each card and stream (the scratch grown when a call
needs more) and reused: the launches on one stream run one after another,
so no two launches share a workspace at once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.glm_stats import FAMILY_CODES

_P = ctypes.c_void_p
KERNEL = build.CudaKernel(
    "alpha_search", "repro_alpha_search",
    [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P,
     ctypes.c_longlong, _P, _P, ctypes.c_int, _P])

plain = ref.alpha_search
THREADS = 256             # a block of the K <= 32 layout (the least)

# (a card's index, a stream on it) -> (its ticket counter, the partials'
# scratch, the most blocks a launch takes: an SM's threads over THREADS,
# per SM)
_scratch: dict = {}


def ticket(device) -> torch.Tensor:
    """The ticket counter of the card's current stream (one int32, 0
    between launches)."""
    return _workspace(torch.device(device), 0)[0]


def _workspace(device, K: int):
    """(the ticket counter, partials of at least K floats a block) of the
    device's current stream."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (idx, torch.cuda.current_stream(idx).cuda_stream)
    if key not in _scratch:
        props = torch.cuda.get_device_properties(idx)
        blocks = props.multi_processor_count * (
            props.max_threads_per_multi_processor // THREADS)
        _scratch[key] = (torch.zeros(1, dtype=torch.int32, device=device),
                         torch.empty(0, dtype=torch.float32, device=device),
                         blocks)
    tick, part, blocks = _scratch[key]
    if part.numel() < K * blocks:
        part = torch.empty(K * blocks, dtype=torch.float32, device=device)
        _scratch[key] = (tick, part, blocks)
    return tick, part


def grid(n: int, K: int, family: str = "logistic") -> tuple[int, int]:
    """(blocks, threads a block) of the launch for n rows and K candidates
    on the current card: one wave (the occupancy API times the SM count; one
    block an SM past 32 candidates), at most one block per 256 rows."""
    fn = build.library().repro_alpha_search_grid
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    threads = ctypes.c_int(0)
    nb = fn(n, K, FAMILY_CODES[family], ctypes.byref(threads))
    if nb < 1:
        raise RuntimeError(f"alpha_search: no grid for n {n}, K {K}")
    return nb, threads.value


def launch(y, xb, xdb, weights, alphas, family: str, offset=None):
    """(K,) f32 losses from the CUDA kernel."""
    if family not in FAMILY_CODES:
        raise ValueError(
            f"alpha_search has no CUDA body for family {family!r}")
    build.check_cuda("alpha_search", torch.float32, y, xb, xdb, weights,
                     alphas, offset)
    n = y.shape[0]
    for t in (xb, xdb, weights, offset):
        if t is not None and t.shape != (n,):
            raise ValueError(f"alpha_search: expected ({n},) vectors, "
                             f"got {tuple(t.shape)}")
    if alphas.dim() != 1 or alphas.shape[0] == 0:
        raise ValueError("alpha_search: alphas must be a non-empty (K,)")
    K = alphas.shape[0]
    tick, partials = _workspace(y.device, K)
    out = torch.empty(K, dtype=torch.float32, device=y.device)
    KERNEL(build.ptr(y), build.ptr(xb), build.ptr(xdb), build.ptr(weights),
           build.ptr(offset), build.ptr(alphas), K, n, build.ptr(partials),
           partials.numel(), build.ptr(tick), build.ptr(out),
           FAMILY_CODES[family], build.stream_of(y))
    return out
