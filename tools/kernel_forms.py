#!/usr/bin/env python3
"""Time other forms of K1 glm_stats, K4 alpha_search, K6 margin_ls and K7
predict_tile beside the kept ones, or the kept K1 and K4 of another
checkout.

    python3 tools/kernel_forms.py [--out FILE] [--kernels k1,k4,k6,k7]
    python3 tools/kernel_forms.py --checkout DIR [--tag NAME] [--out FILE]

Needs a CUDA card and nvcc.  Each form is the kernel's own source
(``src/repro_torch/kernels/csrc/{glm_stats,alpha_search,margin_ls,
predict_tile}.cu``) with a few constants or lines swapped, built with
nvcc into a library of its own and called through the same C entry point
on the same inputs: K1 at the fits' n (131,072 and 400,000), K4 at
the main path's shapes (n = 131,072 with K = 14, 20 and 294; n = 400,000
with K = 20), K6 at the dense Jacobi fit's shape (n = 400,000, p = 2,048,
K = 294 candidates and K = 1, which leaves out the candidate pass), K7 at
the serving shapes on a random table.  Every form is checked against the
plain version (1e-5) and timed twice, in turns, with
``chip_smoke.time_ms``; ``torch.mv`` on the same X and an empty kernel on
K7's grid (``tools/launch_floor.cu``) are timed in the same rounds.
Prints one JSON line a kernel and appends them to FILE.

K1 forms: ``kept`` (one quad a thread); ``quads2`` (two quads a thread,
half the blocks: the form first run on the card).  K4 forms: ``kept``
(up to 32 candidates: a thread's rows one at a time, the candidates in
branch-free groups of 4; past 32, all ten lane slots evaluated);
``rows2``, ``rows4`` (blocks over whole quads of rows, 2 rows a thread
at a time, one float2 a vector; 4, one float4: half and a quarter of the
threads with work at the fits' n); ``group8`` (groups of 8); ``group1``
(a branch a candidate in both layouts); ``no_loss`` (the margins summed
in place of the losses below 33 candidates: wrong results, a diagnostic
of all but the losses).  K6 forms: ``kept``; ``every_slot`` (all ten lane
slots evaluated with no branch, as K4's are); ``one_wave`` (one
block an SM, no more); ``w8_8kb`` (eight warps a block, one 8 KB row a
copy, one wave: the first form run on the card); ``depth2`` (two copies a
warp in flight); ``direct`` (no bulk copies: each lane loads its 16-byte
pieces of X with eight loads unrolled before the first FMA, two blocks an
SM); ``copy_only`` (the stream with no dot product and no losses: wrong
results, a diagnostic of the stream alone).  K7 forms: ``kept``;
``by_j`` (8 lanes a row, 16 for J > 64, whatever the batch: the form
first planned).

With ``--checkout DIR`` no form is built: the script imports
``repro_torch`` from DIR/src and times K1 and K4 through that checkout's
own ``ops.glm_stats`` and ``ops.alpha_search`` (entry points every
checkout of the port shares), logistic with weights and an offset, K1 at
n = 131,072 and 400,000, K4 at n = 131,072 with K = 14, 20, 21 and 294
and at n = 400,000 with K = 14, 20 and 21, on inputs made on the card from
a seed, the same in every run.  It digests (sha256 of the output bytes)
those outputs and K6's (``margin_ls.launch`` at n = 20,000, p = 256, 294
candidates), so that two checkouts, run in turns in one call on one card
(a, b, b, a), are compared in time and in bits.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
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
    "every_slot": [("      if (lane + 32 * j < kc) {\n        const float m",
                    "      {\n        const float m")],
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
K1_FORMS = {
    "kept": [],
    "quads2": [("constexpr int kQuadsPerThread = 1;",
                "constexpr int kQuadsPerThread = 2;")],
}
K4_GROUP = "constexpr int kCandGroup = 4;"
K4_LOOP = """    for (long long i = r0 + tid; i < r1; i += kRowsThreads) {
      float base = xb[i];
      if (offset != nullptr) base = base + offset[i];
      rs.add(y[i], base, weights[i], xdb[i]);
    }"""


# K4's lane sums with a branch a slot, as K6's: slot j of lane l is live
# when l + 32 j < kc, that is when j < ceil((kc - l) / 32)
K4_SLOT_BRANCH = [
    ("  int kc, inner;", "  int kc, inner, live;"),
    ("    kc = min(kGroup, K - k0);\n",
     "    kc = min(kGroup, K - k0);\n    live = (kc - lane + 31) / 32;\n"),
    ("""      const float m = __fadd_rn(base, __fmul_rn(a[j], d));
      part[j] += __fmul_rn(repro::Stats<F>::loss(yi, m), ci);""",
     """      if (j < live) {
        const float m = __fadd_rn(base, __fmul_rn(a[j], d));
        part[j] += __fmul_rn(repro::Stats<F>::loss(yi, m), ci);
      }""")]


def k4_items(rows: int) -> list:
    """K4 with blocks over whole quads of rows and ``rows`` rows a thread
    at a time, one vector load of each input (the inputs 16-byte aligned),
    then the rows one after another; a row at a time past the last whole
    item."""
    return [
        ("  r0 = n * blockIdx.x / gridDim.x;\n"
         "  r1 = n * (blockIdx.x + 1) / gridDim.x;",
         "  const long long nq = (n + 3) / 4;\n"
         "  r0 = min(4 * (nq * blockIdx.x / gridDim.x), n);\n"
         "  r1 = min(4 * (nq * (blockIdx.x + 1) / gridDim.x), n);"),
        ("// block b's rows [r0, r1) of n",
         f"""constexpr int kItem = {rows};
using Vec = {"float2" if rows == 2 else "float4"};
__device__ __forceinline__ void vload(const float* p, float (&v)[kItem]) {{
  const Vec t = *reinterpret_cast<const Vec*>(p);
  const float* q = reinterpret_cast<const float*>(&t);
#pragma unroll
  for (int e = 0; e < kItem; ++e) v[e] = q[e];
}}

// block b's rows [r0, r1) of n"""),
        (K4_LOOP, """    for (long long i = r0 + kItem * tid; i < r1;
         i += kItem * kRowsThreads) {
      if (i + kItem <= r1) {
        float yv[kItem], bv[kItem], cv[kItem], dv[kItem], ov[kItem] = {};
        vload(y + i, yv);
        vload(xb + i, bv);
        vload(weights + i, cv);
        vload(xdb + i, dv);
        if (offset != nullptr) vload(offset + i, ov);
#pragma unroll
        for (int e = 0; e < kItem; ++e)
          rs.add(yv[e], offset != nullptr ? bv[e] + ov[e] : bv[e], cv[e],
                 dv[e]);
      } else {
        for (long long j = i; j < r1; ++j) {
          float base = xb[j];
          if (offset != nullptr) base = base + offset[j];
          rs.add(y[j], base, weights[j], xdb[j]);
        }
      }
    }""")]


K4_FORMS = {
    "kept": [],
    "rows2": k4_items(2),
    "rows4": k4_items(4),
    "group8": [(K4_GROUP, "constexpr int kCandGroup = 8;")],
    "group1": [(K4_GROUP, "constexpr int kCandGroup = 1;")] + K4_SLOT_BRANCH,
    "no_loss": [("part[g + c] += __fmul_rn(repro::Stats<F>::loss(yi, m), "
                 "ci);", "part[g + c] += __fmul_rn(m, ci);")],
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


def time_rounds(torch, calls: dict, reps: int, timer=None) -> dict:
    """{name_ms: [ms, ms]}: each call timed twice, in turns (the second
    round in reverse order)."""
    out = {}
    for rnd in range(2):
        for key in (list(calls) if rnd == 0 else list(calls)[::-1]):
            out.setdefault(f"{key}_ms", []).append(
                timer(key) if timer is not None and calls[key] is None
                else chip_smoke.time_ms(torch, calls[key], reps))
    return out


def k1_k4_forms(torch, libs, want_k, card, stream) -> list:
    """K1's and K4's forms at the main path's shapes (logistic, with
    weights and an offset)."""
    from repro_torch.core import linesearch
    from repro_torch.kernels import alpha_search, glm_stats, ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sets = {}
    for n in (131_072, 400_000):
        r = lambda s=1.0: s * torch.randn(n, generator=gen, device=dev)
        sets[n] = (torch.where(r() >= 0, 1.0, -1.0), r(1.5), r(),
                   torch.rand(n, generator=gen, device=dev), r(0.1))
    lines = []
    if "k1" in want_k:
        k1 = {"kernel": "glm_stats", "card": card}
        for n, (y, xb, _, w, off) in sets.items():
            want = ref.glm_stats(y, xb, w, "logistic", offset=off)
            calls = {}
            for name in K1_FORMS:
                fn = libs["k1", name].repro_glm_stats
                fn.argtypes = glm_stats.KERNEL.argtypes
                fn.restype = ctypes.c_int
                outs = [torch.empty(n, device=dev) for _ in range(3)]

                def call(fn=fn, outs=outs, y=y, xb=xb, w=w, off=off, n=n):
                    chip_smoke.check(fn(
                        y.data_ptr(), xb.data_ptr(), w.data_ptr(),
                        off.data_ptr(), *(o.data_ptr() for o in outs), n,
                        0, stream) == 0, "k1 launch failed")
                call()
                torch.cuda.synchronize()
                e = max(chip_smoke.errs(a, b)[1] for a, b in zip(outs, want))
                chip_smoke.check(e <= 1e-5, f"k1 {name} n={n}: error {e}")
                calls[name] = call
            k1[f"n{n}"] = time_rounds(torch, calls, 200)
        lines.append(k1)
    if "k4" in want_k:
        grid14 = linesearch.candidate_alphas(1e-3, 13, dev)
        cand = {14: grid14,
                20: linesearch.backtrack_chains(grid14[5:6], 0.5, 20)[0],
                294: linesearch.full_candidates(1e-3, 13, 0.5, 20,
                                                device=dev)}
        partials = torch.empty(1 << 20, device=dev)
        tickets = {name: torch.zeros(1, dtype=torch.int32, device=dev)
                   for name in K4_FORMS}
        k4 = {"kernel": "alpha_search", "card": card}
        for n, K in ((131_072, 14), (131_072, 20), (131_072, 294),
                     (400_000, 20)):
            y, xb, xdb, w, off = sets[n]
            al = cand[K]
            want = ref.alpha_search(y, xb, xdb, w, al, "logistic", offset=off)
            calls = {}
            for name in K4_FORMS:
                fn = libs["k4", name].repro_alpha_search
                fn.argtypes = alpha_search.KERNEL.argtypes
                fn.restype = ctypes.c_int
                out = torch.empty(K, device=dev)

                def call(fn=fn, out=out, al=al, K=K, n=n, y=y, xb=xb,
                         xdb=xdb, w=w, off=off, t=tickets[name]):
                    chip_smoke.check(fn(
                        y.data_ptr(), xb.data_ptr(), xdb.data_ptr(),
                        w.data_ptr(), off.data_ptr(), al.data_ptr(), K, n,
                        partials.data_ptr(), partials.numel(), t.data_ptr(),
                        out.data_ptr(), 0, stream) == 0, "k4 launch failed")
                call()
                torch.cuda.synchronize()
                e = chip_smoke.errs(out, want)[1]
                chip_smoke.check(name == "no_loss" or e <= 1e-5,
                                 f"k4 {name} K={K}: error {e}")
                calls[name] = call
            k4[f"n{n}_K{K}"] = time_rounds(torch, calls, 200)
        lines.append(k4)
    return lines


def k6_forms(torch, np, rng, libs, card, stream) -> dict:
    """K6's forms at the dense Jacobi fit's shape."""
    from repro_torch.core import linesearch
    from repro_torch.kernels import margin_ls, ref

    dev = torch.device("cuda", 0)
    n, p = 400_000, 2048
    X = 0.05 * torch.randn(n, p, device=dev)
    y = torch.from_numpy(rng.choice([-1.0, 1.0], n).astype(np.float32)) \
        .to(dev)
    xb, off = torch.randn(n, device=dev), 0.1 * torch.randn(n, device=dev)
    w, dbeta = torch.rand(n, device=dev), 0.3 * torch.randn(p, device=dev)
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
    k6.update(time_rounds(torch, calls, 20))
    return {"kernel": "margin_ls", **k6}


def k7_forms(torch, np, rng, libs, card, stream) -> dict:
    """K7's forms at the serving shapes on a random table, beside the
    launch floor of its grid."""
    from repro_torch.kernels import predict_tile, ref

    dev = torch.device("cuda", 0)
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

                def call(fn=fn, slots=slots, vals=vals, out=out, B=B, J=J):
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
            k7[f"B{B}_J{J}"] = time_rounds(
                torch, calls, 200, timer=lambda key: chip_smoke.launch_floor(
                    torch, floor_lib, [(blocks, 1, threads)], 200))
    return {"kernel": "predict_tile", **k7}


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def checkout_times(torch, tag: str, card: str) -> dict:
    """K1 and K4 timed and digested through the imported checkout's ``ops``,
    and K6 digested through its ``margin_ls.launch``."""
    from repro_torch.core import linesearch
    from repro_torch.kernels import margin_ls, ops

    n_sparse = 131_072
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    sets = {}
    for n in (n_sparse, chip_smoke.N_DENSE):
        sets[n] = dict(y=torch.where(randn(n) >= 0, 1.0, -1.0),
                       xb=randn(n, scale=1.5), xdb=randn(n),
                       weights=torch.rand(n, generator=gen, device=dev),
                       offset=randn(n, scale=0.1))
    grid14 = linesearch.candidate_alphas(1e-3, 13, dev)
    chain = lambda k: linesearch.backtrack_chains(grid14[5:6], 0.5, k)[0]
    full = linesearch.full_candidates(1e-3, 13, 0.5, 20, device=dev)
    cand = {14: grid14, 20: chain(20), 21: chain(21), 294: full}

    rec = {"checkout": tag, "card": card, "glm_stats": [],
           "alpha_search": [], "digest": {}}
    for n, v in sets.items():
        k1 = lambda: ops.glm_stats(v["y"], v["xb"], "logistic",
                                   weights=v["weights"], offset=v["offset"])
        rec["glm_stats"].append({"n": n, "ms": chip_smoke.time_ms(
            torch, k1, 200)})
        rec["digest"][f"glm_stats/n={n}"] = digest(*k1())
        for K in ((14, 20, 21, 294) if n == n_sparse else (14, 20, 21)):
            k4 = lambda: ops.alpha_search(
                v["y"], v["xb"], v["xdb"], cand[K], "logistic",
                weights=v["weights"], offset=v["offset"])
            rec["alpha_search"].append({"n": n, "K": K, "ms":
                                        chip_smoke.time_ms(torch, k4, 200)})
            rec["digest"][f"alpha_search/n={n}/K={K}"] = digest(k4())
    n6, p6 = 20_000, 256
    X = randn(n6, p6, scale=0.1)
    v = {k: t[:n6] for k, t in sets[n_sparse].items()}
    rec["digest"]["margin_ls"] = digest(*margin_ls.launch(
        X, randn(p6, scale=0.3), v["y"], v["xb"], v["weights"], full,
        "logistic", offset=v["offset"]))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--kernels", default="k1,k4,k6,k7")
    ap.add_argument("--checkout", type=pathlib.Path, default=None)
    ap.add_argument("--tag", default=None)
    args = ap.parse_args()
    want_k = set(args.kernels.split(","))
    if args.checkout is not None:
        sys.path.insert(0, str(args.checkout.resolve() / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_forms: no CUDA device is available")
    from repro_torch.kernels import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.checkout is not None:
        emit([checkout_times(torch, args.tag or str(args.checkout), card)],
             args.out)
        return
    nvcc = build.nvcc_path()
    forms = {"k1": K1_FORMS, "k4": K4_FORMS, "k6": K6_FORMS,
             "k7": K7_FORMS}
    files = {"k1": "glm_stats.cu", "k4": "alpha_search.cu",
             "k6": "margin_ls.cu", "k7": "predict_tile.cu"}
    jobs = [(kern, name, swaps) for kern in sorted(want_k & set(forms))
            for name, swaps in forms[kern].items()]
    srcs = {kern: (build.CSRC / f).read_text() for kern, f in files.items()}
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
        stream = torch.cuda.current_stream().cuda_stream
        if want_k & {"k1", "k4"}:
            lines += k1_k4_forms(torch, libs, want_k, card, stream)
        if "k6" in want_k:
            lines.append(k6_forms(torch, np, rng, libs, card, stream))
        if "k7" in want_k:
            lines.append(k7_forms(torch, np, rng, libs, card, stream))
    emit(lines, args.out)


def emit(lines, out) -> None:
    """Print each line as JSON and append them to ``out``."""
    for line in lines:
        print(json.dumps(line), flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        with out.open("a") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
