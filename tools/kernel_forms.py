#!/usr/bin/env python3
"""Time other forms of K6 margin_ls and K7 predict_tile beside the kept ones.

    python3 tools/kernel_forms.py [--out FILE]

Needs a CUDA card and nvcc.  Each form is the kernel's own source
(``src/repro_torch/kernels/csrc/{margin_ls,predict_tile}.cu``) with a few
constants or lines swapped, built with nvcc into a library of its own and
called through the same C entry point on the same inputs: K6 at the dense
Jacobi fit's shape (n = 400,000, p = 2,048, K = 294 candidates and K = 1,
which leaves out the candidate pass), K7 at the serving shapes on a random
table.  Every form is checked against the plain version (1e-5) and timed
twice, in turns, with ``chip_smoke.time_ms``; ``torch.mv`` on the same X
and an empty kernel on K7's grid (``tools/launch_floor.cu``) are timed in
the same rounds.  Prints one JSON line a kernel and writes them to FILE.

K6 forms: ``kept``; ``one_wave`` (one block an SM, no more); ``w8_8kb``
(eight warps a block, one 8 KB row a copy, one wave: the first form run
on the card); ``depth2`` (two copies a warp in flight); ``direct`` (no
bulk copies: each lane loads its 16-byte pieces of X with eight loads
unrolled before the first FMA, two blocks an SM); ``copy_only`` (the
stream with no dot product and no losses: wrong results, a diagnostic of
the stream alone).  K7 forms: ``kept``; ``by_j`` (8 lanes a row, 16 for
J > 64, whatever the batch: the form first planned).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))
import chip_smoke  # noqa: E402  (timing, errors, the floor probe)

ONE_WAVE = [("constexpr int kWaves = 4;", "constexpr int kWaves = 1;")]
DIRECT = [
    ("if (lane == 0)\n    for (int j = 0; j < min(kDepth, copies); ++j) "
     "issue(j);", ""),
    ("            repro::mbar_wait(&bar[j % kDepth], (j / kDepth) & 1);",
     "            ;"),
    ("            if (lane == 0 && j + kDepth < copies) issue(j + kDepth);",
     "            ;"),
    ("const float* row = st + (chunks > 1 ? 0 : (g0 + r) * p);",
     "const float* row = X + (r0 + i0 + g0 + r) * p + c0;"),
    ("float* d_s = smem + kWarps * kDepth * kStage;",
     "float* d_s = smem + kGroup * kWarps;"),
    ("(kWarps * kDepth * kStage + (p <= kDbetaShared ? p : 0));",
     "(kGroup * kWarps + (p <= kDbetaShared ? p : 0));"),
    ("  for (int c = lane * 4; c < cw; c += 128) {",
     "#pragma unroll 8\n  for (int c = lane * 4; c < cw; c += 128) {"),
    ("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads)"),
    ("constexpr int kWarps = 16;", "constexpr int kWarps = 8;"),
    ("constexpr int kStage = 1024;", "constexpr int kStage = 2048;")]
K6_FORMS = {
    "kept": [],
    "one_wave": ONE_WAVE,
    "w8_8kb": ONE_WAVE + [
        ("constexpr int kWarps = 16;", "constexpr int kWarps = 8;"),
        ("constexpr int kStage = 1024;", "constexpr int kStage = 2048;")],
    "depth2": [("constexpr int kDepth = 3;", "constexpr int kDepth = 2;")],
    "direct": DIRECT,
    "copy_only": [
        ("""          if (!B16 || d_shared)   // dbeta staged as it is to be read
            dot_part<B16, false>(row, dv + c0, cw, lane, s);
          else
            dot_part<true, true>(row, dv + c0, cw, lane, s);""",
         "          (void)row;\n          (void)cw;"),
        ("""        ls.add(lane, __shfl_sync(0xffffffffu, yl, r),
               __shfl_sync(0xffffffffu, bl, r),
               __shfl_sync(0xffffffffu, cl, r), d);""", "        (void)d;")],
}
K7_FORMS = {
    "kept": [],
    "by_j": [("  const int per_lane = B <= kSmallBatch ? 1 : kQ;",
              "  const int per_lane = kQ;")],
}


def build_form(nvcc, arch, csrc, src: str, swaps, out: pathlib.Path) -> str:
    """Compile ``src`` with ``swaps`` applied into ``out`` (headers from
    ``csrc``); '' or the compiler's complaint."""
    for old, new in swaps:
        if old not in src:
            return f"form does not apply: {old[:60]!r}"
        src = src.replace(old, new)
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    r = subprocess.run([nvcc, *arch, "-std=c++17", "-O3", "-Xcompiler",
                        "-fPIC", "-shared", "-I", str(csrc), str(cu),
                        "-o", str(out)], capture_output=True, text=True,
                       timeout=600)
    return "" if r.returncode == 0 else r.stderr[-2000:]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_forms: no CUDA device is available")
    from repro_torch.core import linesearch
    from repro_torch.kernels import build, margin_ls, predict_tile, ref

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    nvcc = build.nvcc_path()
    jobs = [("k6", k, v) for k, v in K6_FORMS.items()] + \
        [("k7", k, v) for k, v in K7_FORMS.items()]
    srcs = {"k6": (build.CSRC / "margin_ls.cu").read_text(),
            "k7": (build.CSRC / "predict_tile.cu").read_text()}
    lines = []
    with tempfile.TemporaryDirectory(prefix="kernel_forms-") as tmp:
        outs = {(kern, name): pathlib.Path(tmp) / f"{kern}_{name}.so"
                for kern, name, _ in jobs}
        with ThreadPoolExecutor(len(jobs)) as ex:
            errs = list(ex.map(lambda j: build_form(
                nvcc, build.ARCH, build.CSRC, srcs[j[0]], j[2],
                outs[j[0], j[1]]), jobs))
        for (kern, name, _), err in zip(jobs, errs):
            chip_smoke.check(not err, f"{kern} {name}: {err}")
        libs = {key: ctypes.CDLL(str(path)) for key, path in outs.items()}

        rng = np.random.default_rng(0)
        n, p = 400_000, 2048
        X = 0.05 * torch.randn(n, p, device=dev)
        y = torch.from_numpy(rng.choice([-1.0, 1.0], n).astype(np.float32)) \
            .to(dev)
        xb, off = torch.randn(n, device=dev), 0.1 * torch.randn(n, device=dev)
        w, dbeta = torch.rand(n, device=dev), 0.3 * torch.randn(p, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        k6 = {"card": card, "n": n, "p": p}
        calls = {}
        for K in (294, 1):
            al = (linesearch.full_candidates(1e-3, 13, 0.5, 20, device=dev)
                  if K == 294 else torch.ones(1, device=dev))
            want = ref.fused_ls_dense(X.view(n, 1, p).transpose(0, 1), y, xb,
                                      dbeta, w, al, "logistic", offset=off)
            for name in K6_FORMS:
                fn = libs["k6", name].repro_margin_ls
                fn.argtypes = margin_ls.KERNEL.argtypes
                fn.restype = ctypes.c_int
                xdb = torch.empty(n, device=dev)
                part = torch.empty(-(-n // 1024) * K, device=dev)
                los = torch.empty(K, device=dev)

                def call(fn=fn, al=al, K=K, xdb=xdb, part=part, los=los):
                    chip_smoke.check(fn(
                        X.data_ptr(), n, p, dbeta.data_ptr(), y.data_ptr(),
                        xb.data_ptr(), w.data_ptr(), off.data_ptr(),
                        al.data_ptr(), K, xdb.data_ptr(), part.data_ptr(),
                        los.data_ptr(), 0, 0, stream) == 0,
                        "k6 launch failed")
                call()
                torch.cuda.synchronize()
                e = max(chip_smoke.errs(xdb, want[0])[1],
                        chip_smoke.errs(los, want[1])[1])
                chip_smoke.check(name == "copy_only" or e <= 1e-5,
                                 f"k6 {name} K={K}: error {e}")
                calls[f"{name}_K{K}"] = call
        calls["torch_mv"] = lambda: torch.mv(X, dbeta)
        for rnd in range(2):
            for key in (list(calls) if rnd == 0 else list(calls)[::-1]):
                k6.setdefault(f"{key}_ms", []).append(
                    chip_smoke.time_ms(torch, calls[key], 20))
        lines.append({"kernel": "margin_ls", **k6})
        del X, calls

        floor_lib = chip_smoke.floor_tool()
        A, L = 16384, 4
        table = torch.zeros(A + 1, L, device=dev)
        table[:-1] = 0.2 * torch.randn(A, L, device=dev)
        b0 = torch.randn(L, device=dev)
        k7 = {"card": card, "A": A, "L": L}
        for B in (4096, 64):
            for J in (32, 64, 128):
                slots = torch.from_numpy(rng.integers(
                    0, A + 1, size=(B, J)).astype(np.int32)).to(dev)
                vals = torch.randn(B, J, device=dev)
                want = ref.predict_tile(slots, vals, table, b0, "logistic",
                                        kind="response")
                out = torch.empty(B, L, device=dev)
                blocks, threads = predict_tile.grid(B, J)
                calls = {"launch_floor": None}
                for name in K7_FORMS:
                    fn = libs["k7", name].repro_predict_tile
                    fn.argtypes = predict_tile.KERNEL.argtypes
                    fn.restype = ctypes.c_int

                    def call(fn=fn, slots=slots, vals=vals, out=out, B=B,
                             J=J):
                        chip_smoke.check(fn(
                            slots.data_ptr(), vals.data_ptr(), B, J,
                            table.data_ptr(), A + 1, L, b0.data_ptr(),
                            out.data_ptr(), 0, stream) == 0,
                            "k7 launch failed")
                    call()
                    torch.cuda.synchronize()
                    e = chip_smoke.errs(out, want)[1]
                    chip_smoke.check(e <= 1e-5, f"k7 {name}: error {e}")
                    calls[name] = call
                row = {}
                for rnd in range(2):
                    for key in (list(calls) if rnd == 0
                                else list(calls)[::-1]):
                        row.setdefault(f"{key}_ms", []).append(
                            chip_smoke.launch_floor(
                                torch, floor_lib, [(blocks, 1, threads)],
                                200) if key == "launch_floor" else
                            chip_smoke.time_ms(torch, calls[key], 200))
                k7[f"B{B}_J{J}"] = row
        lines.append({"kernel": "predict_tile", **k7})
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
