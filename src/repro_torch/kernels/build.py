"""Build the hand-written CUDA kernels with ``nvcc`` and bind them with ctypes.

Every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``) by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library with a plain C interface.  The library lands in
``kernels/_build/<hash of the sources and flags>/`` (listed in .gitignore),
so a checkout builds it at the first launch of any kernel and reuses it
after.  A missing ``nvcc`` or a failed build raises: there is no fallback
to the plain PyTorch versions on the card.

Each kernel is a ``CudaKernel``: it binds its C entry point with explicit
``argtypes``, raises when the entry returns a CUDA error, and counts its
successful launches in the plain integer ``launches``.  ``counts()`` gives
the nvcc builds and library loads this process made (a steady state makes
neither), and ``resources(stem)`` what each ``__global__`` function of one
source asks of the card (``csrc/resources.cuh``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("glm_stats.cu", "cd_tile_solve.cu", "tile_gram.cu",
           "alpha_search.cu", "stats_gram_solve.cu", "margin_ls.cu",
           "predict_tile.cu", "admm_shooting.cu", "online_tg.cu",
           "ssm_scan.cu", "mlstm_scan.cu", "slstm_scan.cu")
HEADERS = ("glm_family.cuh", "cd_chain.cuh", "gram_tc.cuh", "mbarrier.cuh",
           "resources.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_COUNTS = {"builds": 0, "loads": 0}


def counts() -> dict:
    """nvcc builds (a library compiled and linked) and library loads made
    by this process."""
    return dict(_COUNTS)


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` (default
    /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels of repro_torch are built from source at first use")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Compile and link the kernels unless this source hash is built already.

    Returns the library's path.  The compiler's report (``-Xptxas -v``:
    registers, shared memory and spills per kernel) is kept beside it in
    ``build.log``.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    _COUNTS["builds"] += 1
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for name, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {name} (rc {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        (tmp / "build.log").write_text("\n".join(log))
        try:
            tmp.rename(out.parent)
        except OSError:
            # another process finished the same build first
            if not out.exists():
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _COUNTS["loads"] += 1
            _lib = lib
        return _lib


class CudaKernel:
    """One C entry point of the kernel library plus its launch count."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = library().repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed: {msg} "
                               f"(error {err})")
        self.launches += 1


class KernelResources(ctypes.Structure):
    """One record of ``repro_<source>_resources`` (``csrc/resources.cuh``'s
    struct, field for field)."""
    _fields_ = [("name", ctypes.c_char * 96),
                ("regs", ctypes.c_int),
                ("static_smem", ctypes.c_int),
                ("local_bytes", ctypes.c_int),
                ("max_dynamic_smem", ctypes.c_int),
                ("max_threads", ctypes.c_int),
                ("requested_dynamic_smem", ctypes.c_int),
                ("requested_threads", ctypes.c_int),
                ("launches", ctypes.c_int)]


def resources(stem: str) -> list:
    """[{name, regs, static_smem, ...}] of every ``__global__`` function
    (template instance) of ``csrc/<stem>.cu`` on the current card: its
    attributes, and the most dynamic shared bytes and threads a block any
    of its launches asked for since the library was loaded."""
    fn = getattr(library(), f"repro_{stem}_resources")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    cap = 64
    out = (KernelResources * cap)()
    err = fn(out, cap, ctypes.byref(n))
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{stem}: cudaFuncGetAttributes failed: {msg}")
    if n.value > cap:
        raise RuntimeError(f"{stem}: {n.value} kernels, room for {cap}")
    return [{f: (getattr(r, f).decode() if f == "name" else getattr(r, f))
             for f, _ in KernelResources._fields_} for r in out[:n.value]]


def ptr(t) -> int | None:
    """Device address of a tensor (None for an absent optional input)."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, dtype, *tensors) -> None:
    """Raise unless every given tensor is a contiguous CUDA tensor of
    ``dtype`` on one device (None entries are skipped)."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: inputs on {dev} and {t.device}")


def out_buffer(out, shape, like):
    """The tensor a kernel writes a result of ``shape`` into: ``out``
    itself where it is a contiguous float32 tensor of that shape on
    ``like``'s device (written in place), else a new one, which the
    caller copies into ``out`` when there is one."""
    import torch
    if out is not None and out.dtype == torch.float32 \
            and out.is_contiguous() and tuple(out.shape) == tuple(shape) \
            and out.device == like.device:
        return out
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def into(out, t):
    """``t`` copied into ``out`` (returned), or ``t`` where there is no
    ``out`` or it is ``t`` already."""
    if out is None or out is t:
        return t
    out.copy_(t)
    return out
