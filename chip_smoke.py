#!/usr/bin/env python3
"""Drive repro_torch's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Run from a checkout (it imports ``src/repro_torch`` beside it) on a machine
with a CUDA card and ``nvcc``.  It builds the twelve hand-written CUDA
kernels from ``src/repro_torch/kernels/csrc``, holds each against its plain
PyTorch version on the card at its path's shapes and times both, then
drives each path through the entry points a user calls and checks it:

  * sparse fit: make_sparse(n=163840, p=16384, avg_nnz=50) -> a 131072 x
    16384 train split packed into 256 x 256 bricks, ``GLMSolver.fit`` with
    the default Gauss-Seidel superstep (glm_stats, tile_gram, cd_tile_solve,
    alpha_search);
  * serve: a 4-column artifact from warm-started fits of that data, saved
    and loaded, scored by ``ScoringEngine.score_coo`` and
    ``GLMSolver.predict`` over the 16384-row sparse test split and driven by
    ``MicroBatcher`` traffic (predict_tile), then the same traffic traced
    through a fresh engine: one ``serve/flush`` span a batch,
    ``serve.compiled_shapes`` equal to ``compile_count``;
  * dense fit: make_dense(n=500000, p=2000) -> a 400000 x 2000 train split
    (glm_stats, cd_tile_solve, alpha_search; the dense tile Gram is a plain
    matrix product);
  * dense Jacobi fit: the same data with ``coupling="jacobi"``, the fused
    superstep (stats_gram_solve, margin_ls), then a short profiled fit that
    counts the CUDA launches behind each of its logical launches; the
    unfused Jacobi superstep on the same data follows for comparison;
  * precision="bf16": the dense Jacobi fit again through the bf16 modes of
    stats_gram_solve and margin_ls, and Jacobi fits of the sparse data in
    fp32 and bf16 (glm_stats, tile_gram or its bf16 mode, the batched
    cd_tile_solve, a matvec and alpha_search); each bf16 fit is held
    against its fp32 twin by the reference's own bar (tests/test_fused.py:
    alpha equal on at least 80% of supersteps, beta within 0.05 max(max
    |beta_fp32|, 1));
  * sparse_path: ``GLMSolver.fit_path(n_lambdas=12, lam_ratio=0.05)`` on
    the sparse solver, with strong-rule screening and KKT re-entry, then
    unscreened on the same grid: every lambda converged, no frozen
    coordinate failing the KKT test after a lambda's last round, the
    screened f at most the unscreened f + 1e-5 max(1, |f|), screened tiles
    skipped, K2 and K3 launched once a live tile, K4 twice a superstep, K1
    once a superstep or a gradient check; one gradient check taken apart;
  * path_reference: 6-lambda paths of small sparse and dense inputs
    (Gauss-Seidel and fused Jacobi) and a 3-fold standardized ``fit_cv``
    of the dense one, the card against the CPU;
  * dense_cv: ``fit_cv(n_folds=3, n_lambdas=8)`` of the dense split,
    standardized (centered, the intercept column left exact ones), fused
    Jacobi: K5 and K6 once a superstep, K1 once a gradient check, and the
    unscaled copy of the design freed after construction;
  * checkpoint: on the sparse solver, two fits run through show whether
    the card gives the same bits; the fit cut at its last save before its
    end (``ckpt_every=5``) and sparse_path's grid cut after 6 of its 12
    lambdas (async saves), both resumed in a fresh session, are held to
    those bits (else within 1e-6); each save's and the restore's ms and
    the bytes on disk;
  * trace (after checkpoint): the sparse fit traced (``repro_torch.obs``:
    spans, ``record_function`` and NVTX ranges, a convergence stream) for
    5 supersteps with checkpoints every 2, equal bit for bit to the same
    fit untraced, with one stream event a superstep (f equal to
    ``history["f"]``), the span counts, a resume's ``ckpt/restore``;
    ``ops.launch_trace()`` of one superstep equal to its
    ``launch_counts()``; one profiled superstep whose ``solver/superstep``
    range holds the host launches of K1-K4; a screened 4-lambda path's
    stream context; overheads (traced and untraced supersteps in turns,
    each part of tracing alone); ``trace_report`` over the directory;
  * multinomial: ``MultinomialGLM`` on the sparse train split, 4 classes,
    3 cycles: K1-K4 launched exactly for the class visits' supersteps,
    the standardized objective never rising, training accuracy at least
    the majority share + 0.1, ``predict_proba`` rows summing to 1;
  * estimator: ``LogisticRegressionCD`` fitted, saved (fp32 and int8) and
    loaded, the loaded model's test-split margins (K7) equal to the
    fitted one's and int8 within the manifest's bound,
    ``repro_torch.launch.serve_glm.main`` over the artifact; a family
    registered with the squared formulas fitted on the card only through
    the plain route (``"<kernel>/plain"``), against the squared fit on
    the CPU;
  * stream (after dense_cv): the dense train split kept as a host array
    and streamed by ``streaming_design`` in chunks of 8,192 rows (49, the
    last 6,784; p_pad 2,048, 8 tiles): 5 Gauss-Seidel and 3 Jacobi
    supersteps held against the in-memory fits of as many supersteps
    (the same alpha at each, f within 1e-5 relative, beta within 1e-3),
    K1 and K4 once a chunk and K2 once a swept tile (Jacobi: once a
    superstep); every chunk and a superstep with prefetch off against on,
    bit for bit, each superstep timed by part; the fit cut by its chunk
    source mid-pass (chunk 25 of superstep 3, a chunk-cursor save every
    16 chunks) and resumed in a fresh session; a screened 4-lambda path
    with the KKT test held; the pinned copy rate, the idle share of one
    profiled superstep, the checkpoint's bytes and save ms, K1, K2 and K4
    at the chunk shapes; one superstep traced, its ``phase_us`` (the three
    passes) summing to its ``step_us``;
  * baselines (after stream): the paper's competing algorithms on the
    dense train split (400,000 x 2,000, no intercept column): the two
    scan kernels (admm_shooting: one ADMM x-update, every block's
    Shooting passes; online_tg: one epoch of every shard) held against
    their plain versions at full width and timed beside their bytes
    bound and dependency floor; then benchmarks/fig2_4_l1.py's L1
    comparison at lam1 = 1 (FISTA's f*, d-GLMNET fused Jacobi, ADMM over
    a rho grid, online truncated gradient) and fig5_6_l2.py's L2 one at
    lam2 = 1 (f*, d-GLMNET with a fixed mu, online-warmstarted and plain
    L-BFGS); d-GLMNET run on to 800 supersteps within 1e-3 max(1, |f*|)
    of f*, both L-BFGS within 1e-3 |f*|, ADMM one admm_shooting launch
    and 13 of K1 an iteration, online TG one online_tg launch an epoch;
    each fit_* small, card against CPU;
  * ingest: the sparse train split's first 65,536 rows written as libsvm
    text, then ``repro_torch.launch.ingest_train.main`` in process
    (hashed into 4,096 columns, chunks of 4,096 rows, 3 supersteps: f
    never rising, K1 and K4 once a chunk) and its ``--smoke`` (file
    against memory within 1e-5); write, scan and parse rates and one
    profiled superstep.
  * dist (last): the mesh on torch.distributed, worlds of processes
    started by ``repro_torch.dist.launcher`` (this script is their worker,
    ``--dist-worker``), each under a timeout: (a) NCCL, a world of one,
    mesh (1, 1): the sparse fit's 5 supersteps against the single-device
    fit above (the same alphas and n_iter, beta within 1e-6, whether the
    bits are equal), then the same fit run to tol; (b) gloo, worlds of 2
    ((1, 2)) and 4 ((2, 2)) sharing the one card, the sparse fit at full
    width run to tol, f within 2e-3 |f| of (a)'s, each rank's K1 once a
    superstep, K3 and K2 once a budgeted local tile, K4 twice, seconds a
    superstep, the host seconds inside collectives, world start-up; over
    NCCL too when the machine has a card per rank; (c) small (1, 2) and
    (2, 2) fits on the card against the same worlds on the CPU (beta
    within 1e-5, the same alphas and n_iter); (d) ``dist_run`` under
    ``--faults "1:4.0" --telemetry``: process 1 down-budgeted after the
    warm-up, every rank the same budgets; (e) a 2-process restart from a
    checkpoint (the same bits) and an elastic resume (1, 2) -> (2, 1)
    within 2e-3 |f| of the uninterrupted fit; (f) ``dist_run --data``
    over the dense train split (memory-mapped .npy, chunks of 8,192
    rows): 2 processes over their chunk ranges equal 1 within 1e-6.
    Gloo stages the card's tensors through the host: its times are not
    NCCL's.
  * analysis (its line after lm_families'; ``repro_torch.analysis``): the lint
    gate of this checkout (0 new findings, 0 stale baseline entries); on
    the sparse session's bricks and the dense session's design, fused and
    unfused Jacobi supersteps built on them: 2 and 5 logical units (the
    dense one 2 and 4 kernel launches), each CUDA function of
    ``ops.CUDA_FUNCTIONS`` one profiler record a logical launch and the
    device's kernel records the host's launch calls; a warm 3-lambda path
    of the sparse session with 0 superstep builds, nvcc builds and library
    loads; after lm_families, every kernel of the twelve sources within
    the card's shared memory and register limits, as ptxas reported it,
    the spilling ones named; the collective sequence of the (1, 2) gloo
    world's sparse session, the same in two supersteps and on both ranks.
    Any part not ``ok`` fails the run.
  * lm (the LM template's serving path): gemma3-12b's full config
    (48 layers, d 3840, vocab 262,144; 11,765,395,200 float32 parameters,
    47 GB, drawn on the card from a seed) built by
    ``repro_torch.models.lm.build_model`` after every earlier phase freed
    its memory; ``repro_torch.launch.serve.generate`` at batch 2, a prompt
    of 1,536 tokens (two 1,024-key attention chunks, past the 1,024-token
    local window) and 32 greedy tokens, timed, then one full forward over
    the prompt and the generated tokens.  Under the reference's init the
    forward's roundings grow about tenfold a layer, so the 48 layers'
    decode-vs-forward difference is reported beside the forward's own
    floor (one row forwarded alone); the check holds one-layer cuts of the
    same weights (layer 0, local; layer 5, global) to 1e-3 of the largest
    logit with greedy tokens equal but for ties, a decode one position off
    must exceed it, and a depth profile (2, 3, 6, 12 layers) is reported.
    Then ``repro_torch.core.head_probe``: examples/lm_head_probe.py's
    task, 2,048 sequences of 32 tokens mean-pooled into (2,048, 3,840)
    features on the card, ``fit_probe`` on the first 1,600 rows (tile 256:
    15 tiles, Gauss-Seidel; K1, K2 and K4 launched) held against the same
    fit on the CPU (the same alphas and n_iter, beta within 1e-5, or a
    float32 tie named);
  * lm_families: the template's other five families at full width,
    one model at a time on the card (built from a seed, served, checked,
    freed): deepseek-v2-lite-16b (moe with MLA, 9 of its 27 layers,
    5,182,236,672 parameters: the whole run's 900 s once train_dist trains
    six families), mixtral-8x7b (8 of its 32 layers: 186.81
    GB of float32 do not fit the card), zamba2-1.2b (hybrid),
    xlstm-1.3b (ssm), llama-3.2-vision-11b (vlm, 1,601 image tokens) and
    whisper-tiny (audio, 1,500 frames).  ``serve.generate`` at batch 2, a
    1,408-token prompt (zamba2 and xlstm 704, whisper 320) and 128 greedy
    tokens, timed (the scan kernels' seconds inside the hybrid and ssm
    prefills, beside the plain loops' earlier figures); at capacity for
    every MoE token, decode against one full forward at full depth
    (reported beside the forward's floor) and on a cut of one block of
    each kind, held to the reference's _DECODE_TOL
    (1e-3; zamba2 5e-3, xlstm 2e-2) or twice the cut's own forward floor,
    the larger, with greedy tokens equal but for ties and a decode one
    position off past the bar (an MoE cut past the bar at one position
    only passes where the router's top-k set differs there).  At full
    width the reference's init overflows xlstm's sLSTM (NaN logits in
    both packages), so its cut is reported by where it is not finite and
    its mLSTM and sLSTM blocks are held alone (the sLSTM on a tenth of
    its inputs), with a state one token short as the fault control.  On
    deepseek's features, the head probe by the fused Jacobi superstep
    (1,024 sequences of 32 tokens, 800 train rows, tile 256; K5 and K6
    launched) held against the same fit on the CPU.  zamba2's and
    xlstm's serve checks run their recurrences through the scan kernels
    (ssm_scan, mlstm_scan, slstm_scan): each launched exactly once a
    recurrent layer a call (the prefill, each decode step, the forward
    and row 0's), no ``/plain`` call.  Then the scans part: on each of
    the two models, layer 0's recurrent mixers on the normed embeddings
    of the prompts (the sLSTM's a tenth of them), each scan kernel
    against its plain version on the card at those full-width arguments
    (zamba2 B 2, S 704, H 64, hd 64, ds 64; xlstm B 2, S 704, H 4, hd
    512) within 1e-5 of the largest |value| of each output and final
    state, the non-finite positions equal, timed beside its bound and
    beside the same kernel on one (batch row, head): its dependency
    chain alone on the card.
  * train (``train_phase``, which ``train_phase(np, torch, dev,
    card)`` also runs alone): LM training, no GLM kernel on its path
    (their launch counts stay 0); the recurrences' scans run their plain
    loops under a gradient (no backward kernel yet): the scan kernels at
    0, every call on the card counted ``"<scan>/plain"``.
    phi4-mini-3.8b at full width, 4 of its 32 layers (1,631,874,048 parameters; 32 layers' parameters,
    gradients and AdamW moments take 71.2 GB of float32, and 16 layers'
    save, 57 s, then 8 layers' beside train_dist's six families, kept the
    whole run past its 900 s), float32 with remat
    and flash attention, through ``runtime.trainer.Trainer``: batch 2 x
    2,048 tokens of ``TokenPipeline``, 6 AdamW steps (lr 3e-3, warmup 1),
    one checkpoint at the last (2 layers where the disk cannot hold 4
    layers' 20 GB); each step's loss, grad norm, lr and seconds,
    tokens/s, model flops (6 N D) a second against the fp32 peak, peak
    memory, the save's seconds and bytes; every loss and grad norm finite
    and every parameter moved; a fresh trainer restores the checkpoint
    bit for bit (parameters, moments, count, next step 6), and one more
    step from either state gives the same loss.  The flash backward
    (``FlashAttention``) against autograd through the plain chunked
    forward at phi4's and gemma3-12b's head shapes (B 2, S 2,048, causal;
    gemma3's 1,024 window; a softcap of 50) within 1e-4 of each
    gradient's largest entry, a log-sum-exp one chunk stale past it.
    examples/train_lm.py's config (4 layers, d 256, vocab 2,048, batch 8
    x 128) 200 steps: the last 10 losses below the first 10 by more than
    0.1, and the straight run's checkpoint at step 100 resumed by a fresh
    trainer within the reference's rtol 2e-4, atol 2e-5 of the straight
    run's last 100 losses.  One ``make_train_step``
    step of every architecture of the registry at its smoke config, the
    card against the CPU: loss 1e-5, grad norm 1e-4, gradients 1e-4 of
    the largest entry, updated parameters 1e-7 where AdamW's step is not
    near sign(g).
  * train_dist (after train; ``train_dist_phase``): sharded LM training
    and the dry-run, no GLM kernel on its path, the scans' training calls
    on the plain loops (counted) and their serving calls on the kernels
    (on (1, 2) the sLSTM's once a time step).  phi4-mini-3.8b
    at full width, 2 of 32 layers (1,430,535,168 parameters), float32 with
    remat, batch 2 x 512, 3 AdamW steps (lr 1e-3) from the tests' parity
    weights (the trainer's draw rescaled to N(0, 0.02^2)): the
    single-device ``Trainer`` first, then (a) ``Trainer(mesh=)`` on a
    world of one over NCCL, mesh (1, 1), bit for bit the single-device
    run's losses, grad norms and parameters; (b) a gloo world of 2 on the
    one card (this script is its worker, ``--train-dist-worker``), mesh
    (1, 2), tensor parallel with sequence parallelism: every step's loss
    within 1e-5 and grad norm within 1e-4 of the single-device run's, the
    first step's parameters within 1e-7 where AdamW's step is not near
    sign(g) (by the single run's gradients), both ranks the same
    collectives, each rank's
    memory after placement within 1% of the dry-run's parameters and
    moments for (1, 2), its step seconds (gloo stages the card's tensors
    through the host: not NCCL's times).  In the same world (b) then
    trains the five other families at full width, each at the depth cut
    that keeps every kind of layer it has (deepseek-v2-lite-16b 2 layers,
    1 dense and 1 MoE, 32 of 64 experts a rank; mixtral-8x7b 1 layer, its
    experts split inside; zamba2-1.2b 2 Mamba layers and the shared block;
    xlstm-1.3b 8 layers, 7 mLSTM in their chunkwise form and 1 sLSTM;
    llama-3.2-vision-11b 5 layers and 1 cross block; whisper-tiny whole,
    its vocab padded to 51,866), 2 steps of batch 2 x 512 (whisper's
    decoder 2 x 256), each against its single-device run made before the
    world started and freed: the same bars, the ranks' collectives and
    metrics the same, memory after placement within 1% of the dry-run's,
    the router's margin from a tie reported.  Before any training the
    same world serves (serve_dist, ``serve_dist_rank``): phi4-mini and the
    five families at those cuts from the parity weights, batch 2 x 512
    prompts (whisper's decoder 2 x 256) and 16 greedy tokens through
    ``launch.serve.generate`` on (1, 2), then zamba2 at batch 1 on (2, 1)
    of the same two ranks, its shared block's KV cache split on the
    sequence over data; each against its single-card run made before the
    world: every logit within 1e-5 of the largest |logit| (or 4x the
    single run's float32 control, its logits under weights times 1 +
    1e-7 N(0, 1), where that is larger), the same tokens, the same collectives on both ranks, each rank's bytes after
    placement (parameters and caches) the dry-run's for its layout, its
    prefill seconds and decode ms a step.  Every run sets the first
    step's near-sign(g) entries (whose update float32's order of a sum
    decides) back to their initial values before the second step: xlstm's
    second step at full width moves 3x on them.  (c) ``launch.dryrun`` in
    process over every architecture and
    shape and dglmnet on the meshes of 1 and 4 cards: no failed cell, the
    largest per-card bytes.
No built-in family takes a plain route in any phase; the only plain
route on the card is the scans' under a gradient (training).

K3 and K5 run on the tensor cores (3xTF32): their report gives both bounds,
the fp32 FMA one and the tensor-core one, with the share of each and the
TF32 TFLOP/s executed, and checks that G is exactly symmetric.  K2, a
dependent chain, is held bit for bit at T = 256 and 512 and in its batched
launch; beside its bytes bound the report gives its dependency floor, T
times the time of the step's 13 dependent rounded operations run alone,
and the time of one step of the kernel's own panel loop (both measured by
the probes of tools/chain_floor.cu, built here with nvcc).  K6 must give
the same bits on two runs and is timed beside torch.mv on the same X.  K7
is held and timed at 4,096 rows (bulk scoring) and at 64 (the batcher's
largest bucket); beside K1, K4 and K7 stands their launch floor, an empty
kernel on the same grid timed the same way (tools/launch_floor.cu).  K1
and K4 are held for the four families at the sparse fit's n and at the
dense fit's 400,000 rows (K1 also with every vector off a 16-byte
boundary, its element path); K4 at 14, 20, 21, 294 and 321 candidates,
and timed at the main path's shapes (14 and 20 for the Gauss-Seidel line
search, 294 for the fused Jacobi superstep on bricks; 21 beside them).
Their bound is the larger of their bytes and their per-example work at
the rate that the probes of tools/loss_floor.cu (built here with nvcc)
measure on the whole card: one candidate loss for K4, one row's
statistics for K1.  K4 must give the same bits on two runs and leave its
ticket counter at 0.
The bf16 modes of K3, K5 and K6 are held against their plain bf16 versions
(the same roundings, summed in float64 or float32) at 1e-5 relative to the
largest entry; K5's G and g in that mode against the plain bf16 Gram at
the kernel's own w and s (see ``bf16_fused_parity``).  Their bound is the
larger of bytes over the memory rate and all of G's flops at the dense bf16
tensor-core rate (K6: its operations on the fp32 pipes).

Each path runs with every kernel's launch count set to 0 just before it and
read just after; the counts must equal the path's exact needs.  Small fits
on the card (Gauss-Seidel and both Jacobi forms) are also held against the
same fits on the CPU.  It prints one JSON object per phase, the card's name
and power limit, the kernel report and, last, ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero without that line; so does a machine
without a CUDA device, or a directory without the package.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

SEED = 0
REPO = pathlib.Path(__file__).resolve().parent
H100_FP32_FLOPS = 67e12     # dense fp32 outside the tensor cores (SXM, 700 W)
H100_TF32_FLOPS = 495e12    # dense TF32 on the tensor cores (SXM, 700 W)
H100_BF16_FLOPS = 989e12    # dense bf16 on the tensor cores (SXM, 700 W)
H100_BYTES_PER_S = 3.35e12  # HBM3


LAM1_FRACTION = 0.05        # lam1 of the full-size fits, over lambda_max
N_DENSE = 400_000           # train rows of the dense fit (K1 and K4 run there)
SERVE_FRACTIONS = (0.2, 0.1, 0.05, 0.02)   # the served model's columns
DIST_TIMEOUT_S = 300        # one world of the dist phase
DIST_SMALL_STEPS = 8        # supersteps of the small card-vs-CPU fits
BASELINE_LAM1 = 1.0         # benchmarks/fig2_4_l1.py's LAM1
BASELINE_LAM2 = 1.0         # benchmarks/fig5_6_l2.py's LAM2
BASELINE_ITERS = 30         # fig2_4_l1.py's ITERS
BASELINE_L2_ITERS = 25      # fig5_6_l2.py's d-GLMNET and L-BFGS iterations
BASELINE_FISTA_CAP = 500    # FISTA's max_iter for f* (the figures: 3,000)
BASELINE_GATE_SUPERSTEPS = 800   # d-GLMNET run on to this for the f* gate
BASELINE_WITNESS_ROWS = 40_000   # train rows of the protocol's witness cut


def full_size_data(synthetic, kind: str):
    """The data set of one of the two full-size fits (``profile_superstep.py``
    profiles the same two)."""
    if kind == "sparse":
        return synthetic.make_sparse(n=163_840, p=16_384, avg_nnz=50,
                                     k_true=200, seed=SEED)
    return synthetic.make_dense(n=500_000, p=2_000, k_true=200, seed=SEED)


def full_size_solver(GLMSolver, ds, dev, config=None, **kw):
    """The solver of a full-size fit: logistic with an intercept."""
    return GLMSolver(ds.train.X, ds.train.y, family="logistic",
                     fit_intercept=True, device=dev, config=config, **kw)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(bytes_moved: float, flops: float,
             peak_flops: float = H100_FP32_FLOPS):
    """The larger of the bytes over the memory rate and the flops over
    ``peak_flops`` (a bf16 Gram's: all of G at the dense bf16 rate)."""
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_bf16_ms(torch, a, b, reps: int):
    """(ms, what was timed) of one PyTorch product of bf16 operands with a
    float32 result: ``torch.mm`` (2-D) or ``torch.bmm`` (3-D) with
    ``out_dtype=torch.float32``; where this torch lacks that, a float32
    product of the same rounded operands."""
    mm = torch.bmm if a.dim() == 3 else torch.mm
    name = "bmm" if a.dim() == 3 else "mm"
    try:
        mm(a, b, out_dtype=torch.float32)
        return (time_ms(torch, lambda: mm(a, b, out_dtype=torch.float32),
                        reps),
                f"torch.{name}(bf16, bf16, out_dtype=torch.float32)")
    except (TypeError, RuntimeError, NotImplementedError):
        a32, b32 = a.float(), b.float()
        return (time_ms(torch, lambda: mm(a32, b32), reps),
                f"torch.{name} in float32 of the bf16-rounded operands "
                "(no out_dtype in this torch)")


def bf16_tracks_fp32(np, tag: str, r32, r16) -> dict:
    """The reference's bar for a bf16 fit (tests/test_fused.py,
    test_bf16_tracks_fp32_alpha_sequence): alpha equal to the fp32 fit's
    on at least 80% of the supersteps both ran, beta within 0.05 max(max
    |beta_fp32|, 1); and the two differ (the mode did round)."""
    a32 = np.asarray(r32.history["alpha"])
    a16 = np.asarray(r16.history["alpha"])
    k = min(len(a32), len(a16))
    match = float(np.mean(np.isclose(a32[:k], a16[:k], rtol=1e-6)))
    err = float(np.abs(r16.beta - r32.beta).max())
    scale = float(np.abs(r32.beta).max())
    check(k > 0 and match >= 0.8,
          f"{tag}: alpha matches the fp32 fit on {match} of {k} supersteps")
    check(err <= 0.05 * max(scale, 1.0),
          f"{tag}: beta {err} off the fp32 fit (scale {scale})")
    check(err > 0, f"{tag}: beta equals the fp32 fit's bit for bit")
    return {"phase": f"{tag}_vs_fp32", "supersteps": k,
            "alpha_match": match, "alpha_fp32": a32[:k].tolist(),
            "alpha_bf16": a16[:k].tolist(), "beta_max_abs_diff": err,
            "beta_scale": scale, "f_fp32": r32.history["f"],
            "f_bf16": r16.history["f"],
            "bar": {"alpha_match": 0.8, "beta": 0.05 * max(scale, 1.0)}}


def gram_bounds(bytes_moved: float, gram_flops: float, other_flops: float,
                executed_flops: float, ms: float) -> dict:
    """K3's and K5's two bounds.  gram_flops: one FMA a row for each of G's
    T (T + 1) / 2 unique entries; other_flops: the rest (w scaling, g,
    stats); executed_flops: the TF32 products the kernel issues (three a
    product, over the whole upper blocks and rows it streams).  The FMA
    bound puts all the work on the fp32 pipes; the tensor-core bound, the
    least time on the pipe the kernel uses, three TF32 products of G's
    unique entries.  Each share is that bound over ``ms``."""
    fma, fma_by = bound_ms(bytes_moved, gram_flops + other_flops)
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_tc = 3.0 * gram_flops / H100_TF32_FLOPS * 1e3
    tc, tc_by = (t_bytes, "bytes") if t_bytes >= t_tc else (t_tc,
                                                            "operations")
    return dict(bound_ms=tc, bound_by=tc_by, bound_fma_ms=fma,
                bound_fma_by=fma_by, share_of_tensor_core_bound=tc / ms,
                share_of_fma_bound=fma / ms,
                tflops_needed=gram_flops / ms / 1e9,
                tf32_tflops_executed=executed_flops / ms / 1e9)


def time_ms(torch, fn, reps: int, warmup: int = 2,
            queued: bool = True) -> float:
    """Mean device milliseconds per call, from CUDA events around ``reps``
    calls.  A sleep kernel is queued first, so the host has queued every
    call before the card reaches the first one: a kernel shorter than its
    host-side launch is timed on the card, not at the host's launch rate
    (where ``torch.cuda._sleep`` is missing, the host rate bounds it).
    ``queued=False`` queues no sleep, for a call whose host-side launches
    take longer than its kernels (a plain version's loop): the sleep would
    hide its first 50 ms."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    sleep = getattr(torch.cuda, "_sleep", None)
    if queued and sleep is not None:
        sleep(100_000_000)          # ~50 ms at the H100's clock
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def build_tool(name: str):
    """A probe of ``tools/`` (on no path of the package), built here with
    nvcc into a temporary directory and loaded with ctypes."""
    import ctypes

    from repro_torch.kernels import build

    src = REPO / "tools" / f"{name}.cu"
    with tempfile.TemporaryDirectory(prefix=f"{name}-") as tmp:
        lib_path = pathlib.Path(tmp) / f"lib{name}.so"
        out = subprocess.run(
            [build.nvcc_path(), *build.ARCH, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-I", str(build.CSRC),
             str(src), "-o", str(lib_path)], capture_output=True, text=True,
            timeout=600)
        check(out.returncode == 0,
              f"{src.name} did not build:\n{out.stdout}{out.stderr}")
        return ctypes.CDLL(str(lib_path))


def floor_tool():
    """tools/launch_floor.cu, built and bound: ``launch_floor_empty(gx, gy,
    threads, stream)`` launches one empty kernel."""
    import ctypes

    lib = build_tool("launch_floor")
    lib.launch_floor_empty.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def launch_floor(torch, lib, grids, reps: int) -> float:
    """The launch floor of a kernel: ms per call of one empty kernel on each
    of its CUDA launches' grids ((gx, gy, threads) each), launched through
    ctypes and timed by ``time_ms`` as the kernel itself is."""
    fn = lib.launch_floor_empty

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        for gx, gy, threads in grids:
            check(fn(gx, gy, threads, stream) == 0,
                  f"launch_floor: launch {gx}x{gy}x{threads} failed")

    return time_ms(torch, run, reps)


def chain_floor(torch, G, g, beta_t, penf, mu, nu, lam1, lam2) -> dict:
    """K2's dependency floor and its design's step latency, from the
    probes of tools/chain_floor.cu (built here with nvcc): SM cycles and
    nanoseconds a step, each pair from one timed loop, so the clock is the
    one the probe ran at.  The minimal probe runs the step's 13 dependent
    rounded operations on the first 16 coordinates of the tile (entering
    step 0, as K2 is timed); the design probe, the kernel's own panel loop
    on the first 32.  Neither counts as a launch of K2."""
    import ctypes

    from repro_torch.kernels import ops

    lib = build_tool("chain_floor")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.chain_floor_minimal.argtypes = [P, I, P, P, P]
    lib.chain_floor_design.argtypes = [P, P, P, P, I, I, P, P, P]
    n = 16
    h = torch.diagonal(G)[:n]
    bk, pk = beta_t[:n], penf[:n]
    muh = mu * h
    den = muh + nu + lam2 * pk
    div = torch.where(den > 0, den.clamp(min=1e-30), torch.ones_like(den))
    consts = torch.cat([muh * bk, nu * bk, lam1 * pk, div, 1.0 / div, bk,
                        torch.zeros_like(bk),
                        torch.diagonal(G[1:n + 1, :n]),
                        torch.stack([mu.reshape(()).float(), g[0]])]) \
        .float().contiguous()
    params = ops.solve_params(mu, nu, lam1, lam2, g)
    res = torch.zeros(2, dtype=torch.int64, device=g.device)
    sink = torch.empty(32, device=g.device)
    stream = P(torch.cuda.current_stream().cuda_stream)
    T = g.shape[0]
    runs = {
        "floor": (lambda reps: lib.chain_floor_minimal(
            consts.data_ptr(), reps, res.data_ptr(), sink.data_ptr(),
            stream), 8192, n),
        "design": (lambda reps: lib.chain_floor_design(
            G.data_ptr(), g.data_ptr(), beta_t.data_ptr(), params.data_ptr(),
            T, reps, res.data_ptr(), sink.data_ptr(), stream), 2000, 32)}
    rep = {}
    for who, (run, reps, steps) in runs.items():
        for _ in range(2):          # the second run is the one kept
            check(run(reps) == 0, f"chain_floor {who}: launch failed")
            torch.cuda.synchronize()
        cycles, ns = (int(v) for v in res.tolist())
        check(cycles > 0 and ns > 0, f"chain_floor {who}: no time taken")
        rep[f"{who}_step_cycles"] = cycles / (reps * steps)
        rep[f"{who}_step_ns"] = ns / (reps * steps)
        rep[f"{who}_probe_clock_mhz"] = cycles / ns * 1e3
    return rep


def k2_bound(T: int):
    """K2's bound at tile width T: it reads only G's entries on and below
    the diagonal (T (T + 1) / 2), g, h, beta, the entering step and penf,
    the 4 params, and writes T steps; it makes T (T - 1) / 2 updates of 3
    operations each and about 12 operations a step."""
    return bound_ms((T * (T + 1) / 2 + 6 * T + 4) * 4,
                    3.0 * T * (T - 1) / 2 + 12 * T)


def loss_floors(np, torch, codes) -> dict:
    """{family: {"loss_ns", "stats_ns"}}: the nanoseconds the whole card
    needs for one K4 candidate loss (m = b + alpha d, loss times c, summed)
    and for one K1 row's statistics (Stats<F>::all, three outputs times
    c), from the probes of tools/loss_floor.cu (built here with nvcc):
    inputs in registers, one full wave, no memory traffic.  ``codes``:
    family -> its code in the kernels."""
    import ctypes

    lib = build_tool("loss_floor")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.loss_floor_run.argtypes = [I, I, I, P, P, P, P, P]
    props = torch.cuda.get_device_properties(0)
    sink = torch.empty(props.multi_processor_count * 2048,
                       device=torch.cuda.current_device())
    rng = np.random.default_rng(SEED + 5)
    threads, work = ctypes.c_int(0), ctypes.c_longlong(0)
    out = {}
    for fam, code in codes.items():
        y = rng.poisson(2.0, 1024) if fam == "poisson" \
            else rng.choice([-1.0, 1.0], 1024)
        rows = np.stack([y, 1.5 * rng.normal(size=1024),
                         rng.normal(size=1024), rng.random(1024)], axis=1)
        inp = torch.from_numpy(rows.astype(np.float32).ravel()) \
            .to(sink.device)
        rec = {}
        for mode, key in ((0, "loss_ns"), (1, "stats_ns")):
            def run():
                check(lib.loss_floor_run(
                    code, mode, 1000, inp.data_ptr(), sink.data_ptr(),
                    ctypes.byref(threads), ctypes.byref(work),
                    torch.cuda.current_stream().cuda_stream) == 0,
                    f"loss_floor {fam} mode {mode}: launch failed")
            ms = time_ms(torch, run, 3, warmup=1)
            rec[key] = ms * 1e6 / work.value
        out[fam] = rec
    return out


def shifted(torch, v, m: int):
    """The first m entries of v in a contiguous view one element into its
    storage: 4 bytes past a 16-byte boundary (None stays None)."""
    if v is None:
        return None
    return torch.cat([v.new_zeros(1), v[:m]])[1:]


def timed_bound(n_vec: float, n_ops: float, op_ns: float):
    """(bound ms, "bytes" or "operations", bytes ms, operations ms): the
    larger of n_vec bytes over the memory rate and n_ops operations of
    op_ns each on the whole card (a probe of tools/loss_floor.cu)."""
    t_bytes = n_vec / H100_BYTES_PER_S * 1e3
    t_ops = n_ops * op_ns * 1e-6
    return ((t_ops, "operations") if t_ops >= t_bytes else
            (t_bytes, "bytes")) + (t_bytes, t_ops)


def k1_report(np, torch, rng, sets, floors, floor_lib, tol, parity):
    """K1 against its plain version at each n of ``sets`` ({n: (y, wobs,
    off, xb, xdb)}) for the four families, and at n - 1 rows with every
    vector one element off a 16-byte boundary (the element path and a
    tail); timed at each n with its launch floor and its bound."""
    from repro_torch.kernels import glm_stats as glm_stats_k
    from repro_torch.kernels import ops, ref

    err = 0.0
    for n, (y, wobs, off, xb, _) in sets.items():
        for fam in glm_stats_k.FAMILY_CODES:
            yy = labels_for(np, torch, rng, fam, y)
            cases = [("", (yy, xb, wobs, off)),
                     ("/unaligned", tuple(shifted(torch, v, n - 1)
                                          for v in (yy, xb, wobs, off)))]
            for tag, (a_y, a_xb, a_w, a_off) in cases:
                got = ops.glm_stats(a_y, a_xb, fam, weights=a_w,
                                    offset=a_off)
                want = ref.glm_stats(a_y, a_xb, a_w, fam, offset=a_off)
                e = max(errs(a, b)[1] for a, b in zip(got, want))
                parity[f"glm_stats/n={n}/{fam}{tag}"] = e
                check(e <= tol["glm_stats_probit" if fam == "probit"
                               else "glm_stats"],
                      f"glm_stats n={n} {fam}{tag}: error {e}")
                err = max(err, max(errs(a, b)[0] for a, b in zip(got, want)))
    shapes = []
    for n, (y, wobs, off, xb, _) in sets.items():
        ms = time_ms(torch, lambda: glm_stats_k.launch(
            y, xb, wobs, "logistic", offset=off), 200)
        plain = time_ms(torch, lambda: ref.glm_stats(
            y, xb, wobs, "logistic", offset=off), 50)
        nb = glm_stats_k.grid(n)
        floor = launch_floor(torch, floor_lib,
                             [(nb, 1, glm_stats_k.THREADS)], 200)
        # y, xb, weights and offset in, loss, s and w out
        b_ms, b_by, t_bytes, t_ops = timed_bound(
            n * 4.0 * (3 + (off is not None) + 3), n,
            floors["logistic"]["stats_ns"])
        shapes.append(dict(n=n, ms=ms, plain_ms=plain, bound_ms=b_ms,
                           bound_by=b_by, bytes_bound_ms=t_bytes,
                           stats_floor_ms=t_ops, share_of_bound=b_ms / ms,
                           launch_floor_ms=floor,
                           share_of_launch_floor=floor / ms, grid_blocks=nb))
    main = shapes[0]
    return dict(main, library_ms=None, max_abs_err=err, shapes=shapes,
                stats_floor_ns=floors["logistic"]["stats_ns"])


def k4_report(np, torch, rng, sets, floors, floor_lib, tol, parity):
    """K4 against its plain version for the four families at each n of
    ``sets`` and K = 14 (the Gauss-Seidel grid), 20 (its backtracking
    chain), 21, 294 (every candidate of the fused Jacobi superstep) and 321
    (past one 320-candidate pass); bit-identical over two calls, the
    ticket counter back at 0; timed at the main path's shapes beside the
    launch floor of its grid and its bound, the larger of its bytes and n
    K candidate losses at the probe's rate.  Returns (the report, the
    candidate counts)."""
    from repro_torch.core import linesearch
    from repro_torch.kernels import alpha_search as alpha_search_k
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda", torch.cuda.current_device())
    grid14 = linesearch.candidate_alphas(1e-3, 13, dev)
    chain = lambda k: linesearch.backtrack_chains(grid14[5:6], 0.5, k)[0]
    full = linesearch.full_candidates(1e-3, 13, 0.5, 20, device=dev)
    cand = {14: grid14, 20: chain(20), 21: chain(21), 294: full,
            321: torch.cat([full, chain(27)])}
    err = 0.0
    n_small = min(sets)
    for n, (y, wobs, off, xb, xdb) in sets.items():
        for fam in ("logistic", "squared", "probit", "poisson"):
            yy = labels_for(np, torch, rng, fam, y)
            for K, al in cand.items():
                got = ops.alpha_search(yy, xb, xdb, al, fam, weights=wobs,
                                       offset=off)
                want = ref.alpha_search(yy, xb, xdb, wobs, al, fam,
                                        offset=off)
                ea, e = errs(got, want)
                parity[f"alpha_search/n={n}/{fam}/K={K}"] = e
                check(e <= tol["alpha_search"],
                      f"alpha_search n={n} {fam} K={K}: error {e}")
                err = max(err, ea)
        # fixed rows and fixed-order sums, no float atomics: two calls
        # give the same bits; the last block leaves the ticket at 0
        for K, al in cand.items():
            runs = [alpha_search_k.launch(y, xb, xdb, wobs, al, "logistic",
                                          offset=off) for _ in range(2)]
            check(torch.equal(runs[0], runs[1]),
                  f"alpha_search n={n} K={K}: two calls differ")
        torch.cuda.synchronize()
        check(int(alpha_search_k.ticket(dev).item()) == 0,
              "alpha_search: the ticket counter is not back at 0")
    shapes = []
    for n, K in ((n_small, 14), (n_small, 20), (n_small, 21),
                 (n_small, 294), (N_DENSE, 14), (N_DENSE, 20),
                 (N_DENSE, 21)):
        y, wobs, off, xb, xdb = sets[n]
        al = cand[K]
        ms = time_ms(torch, lambda: alpha_search_k.launch(
            y, xb, xdb, wobs, al, "logistic", offset=off), 200)
        plain = time_ms(torch, lambda: ref.alpha_search(
            y, xb, xdb, wobs, al, "logistic", offset=off), 20)
        nb, threads = alpha_search_k.grid(n, K)
        floor = launch_floor(torch, floor_lib, [(nb, 1, threads)], 200)
        b_ms, b_by, t_bytes, t_ops = timed_bound(
            n * 4.0 * (4 + (off is not None)) + 8.0 * K, n * K,
            floors["logistic"]["loss_ns"])
        shapes.append(dict(n=n, K=K, ms=ms, plain_ms=plain, bound_ms=b_ms,
                           bound_by=b_by, bytes_bound_ms=t_bytes,
                           loss_floor_ms=t_ops, share_of_bound=b_ms / ms,
                           at_half_of_bound=b_ms / ms >= 0.5,
                           launch_floor_ms=floor,
                           share_of_launch_floor=floor / ms, grid_blocks=nb,
                           threads=threads))
    # the line's numbers are the Gauss-Seidel chain's, at the sparse fit's n
    main = shapes[1]
    return (dict(main, library_ms=None, max_abs_err=err, shapes=shapes,
                 loss_floor_ns=floors["logistic"]["loss_ns"]),
            sorted(cand))


def errs(got, want):
    """(max |got - want|, that over max(max |want|, 1))."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1.0)


def labels_for(np, torch, rng, fam, y):
    """The fit's labels, or Poisson counts for the poisson family."""
    if fam == "poisson":
        return torch.from_numpy(rng.poisson(2.0, y.shape[0])
                                .astype(np.float32)).to(y.device)
    return y


# host idle time at each edge of a profiled fit's recording window
PROFILE_EDGE_S = 0.1


def profiled_fit(torch, solver, lam1, steps: int):
    """A ``steps``-superstep fit under torch.profiler: (the profiler, the
    fit's result, its host seconds, the logical launch counts of the fit,
    set to 0 just before it).  The profiler's first cycle is a warm-up, a
    one-superstep fit traced and thrown away; the measured fit is its
    second and last cycle.  The profiler keeps only the device records
    whose times, moved onto the host's clock, fall inside the recording
    window, and on the H100 those times were seen running up to about 2
    ms early: a fit launched at the window's edge lost its first kernels
    (tools/profile_records.py).  So the host idles PROFILE_EDGE_S at both
    edges, outside the timed fit."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import ops

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        solver.fit(lam1=lam1, max_outer=1)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_EDGE_S)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = solver.fit(lam1=lam1, max_outer=steps, tol=0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        logical = ops.launch_counts()
        time.sleep(PROFILE_EDGE_S)
    return prof, res, wall, logical


def cuda_function_counts(torch, prof, prefixes) -> dict:
    """{kernel: {CUDA function: device records}} of a profile, for the
    kernels of ``prefixes`` (kernel: name prefix of its CUDA functions)."""
    from torch.autograd import DeviceType

    from repro_torch.analysis.audit import short_name
    found = {k: {} for k in prefixes}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        name = short_name(evt.key)
        for k, pre in prefixes.items():
            if name.startswith(pre):
                found[k][name] = found[k].get(name, 0) + evt.count
    return found


def cuda_launches(torch, solver, lam1, prefixes, steps: int = 2):
    """The CUDA launches behind each logical launch, counted by
    torch.profiler over a ``steps``-superstep fit.  ``prefixes`` maps a
    kernel to the name prefix of its CUDA functions; returns ({kernel:
    {CUDA function: launches}}, the logical launch counts, supersteps)."""
    prof, res, _, logical = profiled_fit(torch, solver, lam1, steps)
    return cuda_function_counts(torch, prof, prefixes), logical, res.n_iter


def fused_parity(np, torch, solver, dev, report, parity):
    """K5 and K6 against their plain versions on the full-size dense
    design (one tile marked dead), timed beside a library yardstick; K2's
    batched launch (the Jacobi sweep's solves) on K5's G and g."""
    from repro_torch.core import linesearch
    from repro_torch.kernels import cd_tile_solve as cd_tile_solve_k
    from repro_torch.kernels import margin_ls as margin_ls_k
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import gram_tc
    from repro_torch.kernels import stats_gram_solve as sgs_k

    design = solver.design
    X = design.data
    n, p = X.shape
    T, nt = design.tile_size, design.n_tiles
    y, wobs, off, penf = solver._ys, solver._wobs, solver._offsets, \
        solver._penf
    rng = np.random.default_rng(SEED + 2)
    beta = torch.from_numpy((0.01 * rng.normal(size=p)
                             * (rng.random(p) < 0.2)).astype(np.float32)) \
        .to(dev)
    xb = design.matvec(beta)
    live = np.ones(nt, bool)
    live[3] = False
    n_live = int(live.sum())
    mu = torch.full((), 1.0, device=dev)
    g0 = ops.fused_stats_sweep(design, y, xb, beta, "logistic", mu=mu,
                               nu=1e-6, lam1=0.0, lam2=0.0, weights=wobs,
                               offset=off, penf=penf, tile_live=live)[5]
    kw = dict(mu=mu, nu=1e-6, lam1=0.05 * float(g0.abs().max()), lam2=0.0)
    params = ops.solve_params(**kw, like=y)
    # tolerances on max |kernel - plain| / max(max |plain|, 1): the stats,
    # G and g as K1 and K3 (probit 3e-4: its w comes from erfc, the plain
    # version's from log_ndtr); the step is the K2 chain, exact in itself,
    # run on a G summed in another order: 1e-4 of the largest step
    tol = {"stats_gram_solve": 1e-5, "stats_gram_solve_probit": 3e-4,
           "stats_gram_solve_dbeta": 1e-4, "margin_ls": 1e-5}
    err5 = 0.0
    for fam in ("logistic", "squared", "probit", "poisson"):
        yy = labels_for(np, torch, rng, fam, y)
        got = ops.fused_stats_sweep(design, yy, xb, beta, fam, weights=wobs,
                                    offset=off, penf=penf, tile_live=live,
                                    **kw)
        want = ref.stats_gram_solve(design.tiles3(), yy, xb, wobs, beta, fam,
                                    offset=off, penf=penf, tile_live=live,
                                    **kw)
        pairs = [(got[0], want[0]), (got[1], want[1]), (got[2], want[2]),
                 (got[4], want[3]), (got[5], want[4])]
        e = max(errs(a, b)[1] for a, b in pairs)
        parity[f"stats_gram_solve/{fam}"] = e
        check(e <= tol["stats_gram_solve_probit" if fam == "probit"
                       else "stats_gram_solve"],
              f"stats_gram_solve {fam}: error {e}")
        check(not bool(got[4][3].any()) and not bool(got[3][3 * T:4 * T]
                                                     .any()),
              f"stats_gram_solve {fam}: the dead tile was touched")
        check(torch.equal(got[4], got[4].transpose(1, 2)),
              f"stats_gram_solve {fam}: G is not symmetric")
        ed = float((got[3] - want[5]).abs().max()) / max(
            float(want[5].abs().max()), 1e-3)
        parity[f"stats_gram_solve/{fam}/dbeta"] = ed
        check(ed <= tol["stats_gram_solve_dbeta"],
              f"stats_gram_solve {fam}: step error {ed}")
        err5 = max(err5, max(errs(a, b)[0] for a, b in pairs))
        if fam == "logistic":
            dbeta = got[3]
            check(bool(dbeta.abs().max() > 0), "stats_gram_solve: no step")
            # K5's solve pass and K2's batched launch are the same chain:
            # on K5's own G and g both give the plain chain's bits
            chain = ref.jacobi_tile_solves(got[4], got[5], beta, penf=penf,
                                           tile_live=live, **kw)
            k2b = ops.jacobi_tile_solves(got[4], got[5], beta, params,
                                         penf=penf, tile_live=live)
            check(torch.equal(dbeta, chain),
                  "stats_gram_solve: step differs from the plain chain")
            check(torch.equal(k2b, chain),
                  "cd_tile_solve (batched): not bit-exact")
            G_all, g_all = got[4], got[5]
            # both against float64 sums of the live tiles' G
            f64 = {"kernel": 0.0, "plain": 0.0}
            for t in np.flatnonzero(live):
                Xt = X[:, t * T:(t + 1) * T].double()
                G64 = (Xt * want[2].double()[:, None]).T @ Xt
                scale = float(G64.abs().max())
                for who, G in (("kernel", got[4]), ("plain", want[3])):
                    f64[who] = max(f64[who], float(
                        (G[t].double() - G64).abs().max()) / scale)
                del Xt, G64
            parity["stats_gram_solve/G_vs_float64"] = f64
            check(f64["kernel"] <= 1e-5,
                  f"stats_gram_solve: G {f64['kernel']} off float64 sums")
    # timed at the path's shape: the dense Jacobi fit has every tile live
    order, n_all = ops.tile_order(None, nt, dev)
    report["cd_tile_solve"]["batched_ms"] = time_ms(
        torch, lambda: cd_tile_solve_k.launch_tiles(
            G_all, g_all, beta, params, order, n_all, penf), 100)
    report["cd_tile_solve"]["batched_tiles"] = n_all
    del G_all, g_all
    k5_ms = time_ms(torch, lambda: sgs_k.launch(
        X, y, xb, wobs, off, beta, penf, params, order, n_all, T,
        "logistic"), 10)
    k5_plain = time_ms(torch, lambda: ref.stats_gram_solve(
        design.tiles3(), y, xb, wobs, beta, "logistic", offset=off,
        penf=penf, **kw), 2, 1)
    _, s_, w_ = ops.glm_stats(y, xb, "logistic", weights=wobs, offset=off)
    X3 = X.view(n, nt, T)
    k5_lib = time_ms(torch, lambda: (
        torch.einsum("nti,ntj->tij", X3 * w_[:, None, None], X3),
        torch.einsum("nti,n->ti", X3, s_)), 3, 1)
    # G is symmetric: the least work is its T (T + 1) / 2 unique entries
    # (one FMA a row each), beside the w scaling and g's FMAs, per tile
    bn = gram_tc.band(T)
    k5_bytes = (n * n_all * T + 7 * n + nt * (T * T + T) + 3 * p) * 4.0
    bounds = gram_bounds(
        k5_bytes, n_all * n * T * (T + 1.0), n_all * n * 3.0 * T + 20.0 * n,
        6.0 * n_all * gram_tc.n_pairs(T) * bn * bn * n, k5_ms)
    report["stats_gram_solve"] = dict(
        ms=k5_ms, plain_ms=k5_plain, **bounds,
        library_ms=k5_lib, library_covers="G and g only (torch.einsum)",
        plain_note="the plain version sums G and g in float64; the float32 "
                   "product is library_ms",
        max_abs_err=err5, n_live=n_all,
        G_vs_float64=parity["stats_gram_solve/G_vs_float64"])

    cand = linesearch.full_candidates(1e-3, 13, 0.5, 20, device=dev)
    K = cand.shape[0]
    err6 = 0.0
    for fam in ("logistic", "squared", "probit", "poisson"):
        yy = labels_for(np, torch, rng, fam, y)
        got = ops.fused_ls(design, yy, xb, dbeta, cand, fam, weights=wobs,
                           offset=off)
        want = ref.fused_ls_dense(design.tiles3(), yy, xb, dbeta, wobs, cand,
                                  fam, offset=off)
        e = max(errs(a, b)[1] for a, b in zip(got, want))
        parity[f"margin_ls/{fam}"] = e
        check(e <= tol["margin_ls"], f"margin_ls {fam}: error {e}")
        err6 = max(err6, max(errs(a, b)[0] for a, b in zip(got, want)))
    # fixed row ranges and fixed-order sums, no atomics: the same bits on
    # every run
    runs = [margin_ls_k.launch(X, dbeta, y, xb, wobs, cand, "logistic",
                               offset=off) for _ in range(2)]
    check(torch.equal(runs[0][0], runs[1][0])
          and torch.equal(runs[0][1], runs[1][1]),
          "margin_ls: two runs differ")
    del runs
    # torch.mv before and after the kernel; the faster of the two is kept
    k6_lib = time_ms(torch, lambda: torch.mv(X, dbeta), 10)
    k6_ms = time_ms(torch, lambda: margin_ls_k.launch(
        X, dbeta, y, xb, wobs, cand, "logistic", offset=off), 10)
    k6_lib2 = time_ms(torch, lambda: torch.mv(X, dbeta), 10)
    k6_plain = time_ms(torch, lambda: ref.fused_ls_dense(
        design.tiles3(), y, xb, dbeta, wobs, cand, "logistic", offset=off),
        3, 1)
    k6_bytes = (n * p + 5 * n + p + 2 * K) * 4.0
    b_ms, b_by = bound_ms(k6_bytes, 2.0 * n * p + 12.0 * n * K)
    k6_lib = min(k6_lib, k6_lib2)
    report["margin_ls"] = dict(
        ms=k6_ms, plain_ms=k6_plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=k6_lib, library_covers="xdb only (torch.mv)",
        share_of_bound=b_ms / k6_ms, library_share_of_bound=b_ms / k6_lib,
        max_abs_err=err6, K=K, bit_identical_runs=True,
        grid_blocks=margin_ls_k.grid(n, p),
        sm_count=torch.cuda.get_device_properties(dev).multi_processor_count)
    emit({"phase": "fused_kernel_parity", "n": n, "p_pad": p, "T": T,
          "n_tiles": nt, "n_live_parity": n_live, "K": K, "tolerance": tol,
          "max_rel_err": {k: v for k, v in parity.items()
                          if k.split("/")[0] in ("stats_gram_solve",
                                                 "margin_ls")},
          "stats_gram_solve": report["stats_gram_solve"],
          "margin_ls": report["margin_ls"]})

    # ---- the bf16 modes (precision="bf16") on the same inputs.  K5's
    # stats are held like fp32's; its G and g against the plain bf16 Gram
    # at the kernel's own w and s: a float32 s one ulp off the plain
    # version's crosses a bf16 rounding boundary now and then, and such a
    # term moves by 2^-8 of itself, which a cancelling sum such as g can
    # show above the tolerance though the Gram's arithmetic is right.  Its
    # step is the chain on its own G and g (bit for bit) and within 1e-4
    # of the plain version's whole function.
    tolb = {"stats_gram_solve_bf16": 1e-5, "stats_gram_solve_bf16_probit":
            3e-4, "stats_gram_solve_bf16_dbeta": 1e-4,
            "margin_ls_bf16": 1e-5}
    err5b = 0.0
    for fam in ("logistic", "squared", "probit", "poisson"):
        yy = labels_for(np, torch, rng, fam, y)
        got = ops.fused_stats_sweep(design, yy, xb, beta, fam, weights=wobs,
                                    offset=off, penf=penf, tile_live=live,
                                    precision="bf16", **kw)
        want = ref.stats_gram_solve(design.tiles3(), yy, xb, wobs, beta, fam,
                                    offset=off, penf=penf, tile_live=live,
                                    precision="bf16", **kw)
        e_st = max(errs(a, b)[1] for a, b in zip(got[:3], want[:3]))
        check(e_st <= tolb["stats_gram_solve_bf16_probit" if fam == "probit"
                           else "stats_gram_solve_bf16"],
              f"stats_gram_solve bf16 {fam}: stats error {e_st}")
        G_own, g_own = ref.shaped_tile_grams(
            nt, lambda ids: ref.gram_dense_tiles(
                design.tiles3()[ids], got[2], got[1], "bf16"), live)
        e_g = max(errs(got[4], G_own)[1], errs(got[5], g_own)[1])
        check(e_g <= tolb["stats_gram_solve_bf16"],
              f"stats_gram_solve bf16 {fam}: G, g error {e_g}")
        parity[f"stats_gram_solve_bf16/{fam}"] = max(e_st, e_g)
        parity[f"stats_gram_solve_bf16/{fam}/G_g_vs_plain_stats"] = max(
            errs(got[4], want[3])[1], errs(got[5], want[4])[1])
        check(not bool(got[4][3].any()) and not bool(got[3][3 * T:4 * T]
                                                     .any()),
              f"stats_gram_solve bf16 {fam}: the dead tile was touched")
        # (squared's w is the observation weight, 1 on every row here, and
        # bf16(1 x) = bf16(x) leaves its G symmetric)
        check(fam == "squared" or all(not torch.equal(got[4][t], got[4][t].T)
                                      for t in np.flatnonzero(live)),
              f"stats_gram_solve bf16 {fam}: a live tile's G is symmetric")
        asym = errs(got[4] - got[4].transpose(1, 2),
                    G_own - G_own.transpose(1, 2))[0] / float(
                        G_own.abs().max())
        check(asym <= tolb["stats_gram_solve_bf16"],
              f"stats_gram_solve bf16 {fam}: asymmetry off by {asym}")
        ed = float((got[3] - want[5]).abs().max()) / max(
            float(want[5].abs().max()), 1e-3)
        parity[f"stats_gram_solve_bf16/{fam}/dbeta"] = ed
        check(ed <= tolb["stats_gram_solve_bf16_dbeta"],
              f"stats_gram_solve bf16 {fam}: step error {ed}")
        chain = ref.jacobi_tile_solves(got[4], got[5], beta, penf=penf,
                                       tile_live=live, **kw)
        check(torch.equal(got[3], chain),
              f"stats_gram_solve bf16 {fam}: step differs from the chain")
        err5b = max(err5b, max(errs(a, b)[0] for a, b in
                               zip(got[:3], want[:3])),
                    errs(got[4], G_own)[0], errs(got[5], g_own)[0])
        del got, want, G_own, g_own
    k5b = lambda: sgs_k.launch(X, y, xb, wobs, off, beta, penf, params,
                               order, n_all, T, "logistic",
                               precision="bf16")
    runs = [k5b() for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "stats_gram_solve bf16: two runs differ")
    del runs
    k5b_ms = time_ms(torch, k5b, 10)
    k5b_plain = time_ms(torch, lambda: ref.stats_gram_solve(
        design.tiles3(), y, xb, wobs, beta, "logistic", offset=off,
        penf=penf, precision="bf16", **kw), 2, 1)
    X3 = X.view(n, nt, T)
    A16 = (X3 * w_[:, None, None]).to(torch.bfloat16).permute(1, 2, 0) \
        .contiguous()
    B16 = X3.to(torch.bfloat16).permute(1, 0, 2).contiguous()
    k5b_lib, k5b_what = library_bf16_ms(torch, A16, B16, 5)
    del A16, B16
    b_ms, b_by = bound_ms(k5_bytes, 2.0 * n * T * T * n_all,
                          H100_BF16_FLOPS)
    report["stats_gram_solve_bf16"] = dict(
        ms=k5b_ms, plain_ms=k5b_plain, bound_ms=b_ms, bound_by=b_by,
        share_of_bound=b_ms / k5b_ms, library_ms=k5b_lib,
        library_covers=f"G only, operands rounded beforehand: {k5b_what}",
        max_abs_err=err5b, n_live=n_all, bit_identical_runs=True)

    err6b = 0.0
    for fam in ("logistic", "squared", "probit", "poisson"):
        yy = labels_for(np, torch, rng, fam, y)
        got = ops.fused_ls(design, yy, xb, dbeta, cand, fam, weights=wobs,
                           offset=off, precision="bf16")
        want = ref.fused_ls_dense(design.tiles3(), yy, xb, dbeta, wobs, cand,
                                  fam, offset=off, precision="bf16")
        e = max(errs(a, b)[1] for a, b in zip(got, want))
        parity[f"margin_ls_bf16/{fam}"] = e
        check(e <= tolb["margin_ls_bf16"], f"margin_ls bf16 {fam}: {e}")
        err6b = max(err6b, max(errs(a, b)[0] for a, b in zip(got, want)))
    k6b = lambda: margin_ls_k.launch(X, dbeta, y, xb, wobs, cand, "logistic",
                                     offset=off, precision="bf16")
    runs = [k6b() for _ in range(2)]
    check(torch.equal(runs[0][0], runs[1][0])
          and torch.equal(runs[0][1], runs[1][1]),
          "margin_ls bf16: two runs differ")
    del runs
    k6b_ms = time_ms(torch, k6b, 10)
    k6b_plain = time_ms(torch, lambda: ref.fused_ls_dense(
        design.tiles3(), y, xb, dbeta, wobs, cand, "logistic", offset=off,
        precision="bf16"), 3, 1)
    X16 = X.to(torch.bfloat16)
    k6b_lib, k6b_what = library_bf16_ms(
        torch, X16, dbeta.to(torch.bfloat16)[:, None], 10)
    del X16
    # the products run on the fp32 pipes: the bound of the fp32 mode
    b_ms, b_by = bound_ms(k6_bytes, 2.0 * n * p + 12.0 * n * K)
    report["margin_ls_bf16"] = dict(
        ms=k6b_ms, plain_ms=k6b_plain, bound_ms=b_ms, bound_by=b_by,
        share_of_bound=b_ms / k6b_ms, library_ms=k6b_lib,
        library_covers=f"xdb only, from a bf16 copy of X (half the bytes): "
                       f"{k6b_what}",
        max_abs_err=err6b, K=K, bit_identical_runs=True)
    emit({"phase": "bf16_kernel_parity", "n": n, "p_pad": p, "T": T,
          "n_live_parity": n_live, "tolerance": tolb,
          "max_rel_err": {k: v for k, v in parity.items()
                          if k.split("/")[0].endswith("_bf16")},
          "stats_gram_solve_bf16": report["stats_gram_solve_bf16"],
          "margin_ls_bf16": report["margin_ls_bf16"],
          "tile_gram_bf16": report["tile_gram_bf16"]})


def closed_loop(batcher, reqs, n_req: int, n_clients: int):
    """``n_req`` requests of ``reqs`` from ``n_clients`` closed-loop client
    threads through ``batcher``: (results, failures, wall seconds, whether
    every client thread ended)."""
    outs = [None] * n_req
    failed = []

    def client(c):
        try:
            for i in range(c, n_req, n_clients):
                idx, val = reqs[i]
                outs[i] = batcher.submit(idx, val).get(timeout=60.0)
        except Exception as exc:          # reported by the caller
            failed.append(repr(exc))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300.0)
    return outs, failed, time.perf_counter() - t0, \
        not any(th.is_alive() for th in threads)


SERVE_REQUESTS, SERVE_CLIENTS = 4096, 32
SERVE_BUCKETS = dict(max_delay_ms=2.0, batch_buckets=(1, 4, 16, 64),
                     nnz_buckets=(32, 64, 128))


def traced_traffic(np, torch, model, reqs, dev, tdir) -> dict:
    """The serve phase's closed-loop traffic again, traced, through a fresh
    engine and batcher, the metrics registry at 0 just before: one
    ``serve/flush`` span a batch, ``serve.compiled_shapes`` equal to the
    engine's ``compile_count``, and the ``serve.latency_ms`` histogram's
    p50/p99 beside the batcher's own ``stats()``."""
    from repro_torch.obs import metrics, trace
    from repro_torch.serve import MicroBatcher, ScoringEngine

    metrics.registry().reset()
    trace.enable(tdir)
    eng = ScoringEngine(model, device=dev)
    batcher = MicroBatcher(eng, **SERVE_BUCKETS)
    batcher.warmup()
    outs, failed, wall, ended = closed_loop(batcher, reqs, SERVE_REQUESTS,
                                            SERVE_CLIENTS)
    batcher.close()
    spans = span_counts(save_shard(tdir, "serve"))
    st = batcher.stats()
    snap = metrics.registry().snapshot()
    hist = snap["histograms"]["serve.latency_ms"]
    flushes = {r: snap["counters"].get(f"serve.flush.{r}", 0.0)
               for r in ("full", "deadline", "close")}
    check(not failed and ended, f"serve traced: traffic failed {failed[:3]}")
    check(spans.get("serve/flush") == st["n_batches"]
          == sum(flushes.values()) and hist["n"] == st["n_requests"]
          == SERVE_REQUESTS,
          f"serve traced: {spans.get('serve/flush')} flush spans, "
          f"{flushes} flushes, {hist['n']} latencies for {st}")
    check(snap["counters"].get("serve.compiled_shapes")
          == eng.compile_count > 0,
          f"serve traced: serve.compiled_shapes "
          f"{snap['counters'].get('serve.compiled_shapes')} for "
          f"compile_count {eng.compile_count}")
    return {"wall_s": wall, "flush_spans": spans.get("serve/flush"),
            "flushes": flushes, "compiled_shapes": eng.compile_count,
            "latency_hist_p50_ms": metrics.snapshot_quantile(hist, 50),
            "latency_hist_p99_ms": metrics.snapshot_quantile(hist, 99),
            "stats": st}


def serve_phase(np, torch, solver, ds, dev, report, parity, floor_lib,
                tdir):
    """Serving on the sparse model: a 4-column artifact from warm-started
    fits, saved and loaded; K7 against its plain version; the test split
    through ``score_coo`` and ``GLMSolver.predict``; closed-loop traffic
    through ``MicroBatcher``, then again traced into ``tdir``.  Returns
    the launch counts of the untraced run."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import predict_tile as predict_tile_k
    from repro_torch.serve import (MicroBatcher, ScoringEngine,
                                   artifact_bytes, coo_to_requests,
                                   load_artifact, save_artifact)

    lmax = solver.lambda_max()
    betas, b0s, lams = [], [], []
    beta0, icpt = None, 0.0
    t0 = time.perf_counter()
    for frac in SERVE_FRACTIONS:
        res = solver.fit(lam1=frac * lmax, beta0=beta0, intercept0=icpt,
                         max_outer=5)
        beta0, icpt = res.beta, solver.intercept_
        betas.append(beta0)
        b0s.append(icpt)
        lams.append(frac * lmax)
    path_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        art = save_artifact(pathlib.Path(tmp) / "model",
                            betas=np.stack(betas), intercepts=b0s,
                            family="logistic", lambdas=lams)
        model = load_artifact(art)
        art_bytes = artifact_bytes(art)
    check(np.array_equal(model.betas, np.stack(betas)),
          "serve: the artifact does not read back")
    eng = ScoringEngine(model, device=dev)
    Xte, yte = ds.test.X, ds.test.y
    reqs = coo_to_requests(Xte)

    # K7 at the serving shapes: 4096 test rows (bulk scoring) and 64 (the
    # batcher's largest bucket) in the J = 64 bucket, L = 4; beside each,
    # its launch floor, an empty kernel on its grid timed the same way
    J = 64
    table, b0 = eng._table, eng._b0
    A1, L = table.shape
    fit_rows = [r for r in reqs if len(r[0]) <= J]
    err7 = 0.0
    by_b = {}
    for B in (4096, 64):
        check(len(fit_rows) >= B, "serve: too few test rows for the J bucket")
        slots_h, vals_h = eng.pack_requests(fit_rows[:B], nnz_pad=J)
        slots = torch.from_numpy(slots_h).to(dev)
        vals = torch.from_numpy(vals_h).to(dev)
        for fam in ("logistic", "squared", "probit", "poisson"):
            for kind_ in ("link", "response"):
                got = ops.predict_tile(slots, vals, table, b0, fam,
                                       kind=kind_)
                want = ref.predict_tile(slots, vals, table, b0, fam,
                                        kind=kind_)
                ea, e = errs(got, want)
                parity[f"predict_tile/B={B}/{fam}/{kind_}"] = e
                check(e <= 1e-5, f"predict_tile B={B} {fam} {kind_}: "
                                 f"error {e}")
                err7 = max(err7, ea)
        k7_ms = time_ms(torch, lambda: predict_tile_k.launch(
            slots, vals, table, b0, "logistic", "response"), 200)
        blocks, threads = predict_tile_k.grid(B, J)
        floor = launch_floor(torch, floor_lib, [(blocks, 1, threads)], 200)
        b_ms, b_by = bound_ms((B * J * 2 + A1 * L + L + B * L) * 4.0,
                              2.0 * B * J * L + 4.0 * B * L)
        by_b[B] = dict(ms=k7_ms, launch_floor_ms=floor,
                       share_of_launch_floor=floor / k7_ms, bound_ms=b_ms,
                       bound_by=b_by, slots=slots, vals=vals)
    big = by_b[4096]
    slots, vals = big.pop("slots"), big.pop("vals")
    k7_plain = time_ms(torch, lambda: ref.predict_tile(
        slots, vals, table, b0, "logistic", kind="response"), 50)
    k7_lib = time_ms(torch, lambda: F.embedding_bag(
        slots, table, per_sample_weights=vals, mode="sum"), 200)
    small = {k: v for k, v in by_b[64].items() if k not in ("slots", "vals")}
    report["predict_tile"] = dict(
        **big, plain_ms=k7_plain, library_ms=k7_lib,
        library_covers="margins only (F.embedding_bag, mode sum)",
        max_abs_err=err7, B=4096, J=J, L=L, A1=A1,
        **{f"{k}_B64": v for k, v in small.items()})
    del by_b, slots, vals

    # the path: the counts at 0, then score_coo, predict and traffic
    calls = [0]
    score_packed = ScoringEngine.score_packed

    def counted(self, *a, **k):
        calls[0] += 1
        return score_packed(self, *a, **k)

    ScoringEngine.score_packed = counted
    try:
        batcher = MicroBatcher(eng, **SERVE_BUCKETS)
        batcher.warmup()
        n_warm = eng.compile_count
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        calls[0] = 0

        n_req, n_clients = SERVE_REQUESTS, SERVE_CLIENTS
        outs, failed, traffic_s, ended = closed_loop(batcher, reqs, n_req,
                                                     n_clients)
        batcher.close()
        n_traffic = eng.compile_count
        t0 = time.perf_counter()
        scores = eng.score_coo(Xte, kind="response")
        coo_s = time.perf_counter() - t0
        pred = solver.predict(Xte, kind="response")
        counts = ops.launch_counts()
    finally:
        ScoringEngine.score_packed = score_packed
    check(not failed and ended, f"serve: traffic failed {failed[:3]}")
    st = batcher.stats()

    # held against a host product of the same rows (float64 sums)
    want = np.stack([Xte.matvec(bk) for bk in np.stack(betas)], axis=1) \
        + np.asarray(b0s, np.float32)
    want = 1.0 / (1.0 + np.exp(-want.astype(np.float64)))
    e_coo = float(np.abs(scores - want).max())
    e_pred = float(np.abs(pred - scores[:, -1]).max())
    e_traffic = float(np.abs(np.stack(outs) - scores[:n_req]).max())
    check(e_coo <= 1e-5, f"serve: score_coo error {e_coo}")
    check(e_pred <= 1e-6, f"serve: predict differs from the engine {e_pred}")
    check(e_traffic <= 1e-5, f"serve: batcher results differ {e_traffic}")
    # warmup visits every (batch, nnz) bucket of both kinds; the traffic
    # must add no shape of its own
    n_shapes = len(batcher.batch_buckets) * len(batcher.nnz_buckets) * 2
    check(n_warm <= n_shapes and n_traffic == n_warm,
          f"serve: {n_warm} shapes after warmup, {n_traffic} after the "
          f"traffic, {n_shapes} buckets")
    check(counts["predict_tile"] == calls[0] > 0,
          f"serve: {counts['predict_tile']} predict_tile launches for "
          f"{calls[0]} engine calls")
    check(sum(v for k, v in counts.items() if k != "predict_tile") == 0,
          f"serve: other kernels launched {counts}")
    acc = [float(((scores[:, k] > 0.5) == (yte > 0)).mean())
           for k in range(scores.shape[1])]
    traced = traced_traffic(np, torch, model, reqs, dev, tdir)
    emit({"phase": "serve", "lambdas": lams, "fits_s": path_s,
          "artifact_bytes": art_bytes, "n_active": eng.n_active,
          "test_rows": int(Xte.shape[0]), "score_coo_s": coo_s,
          "score_coo_rows_per_s": Xte.shape[0] / coo_s,
          "max_err": {"score_coo": e_coo, "predict": e_pred,
                      "traffic": e_traffic},
          "test_accuracy": acc,
          "traffic": {"requests": n_req, "clients": n_clients,
                      "loop": "closed", "wall_s": traffic_s, **st,
                      "occupancy": st["mean_batch"] / batcher.max_batch},
          "shapes": {"buckets": n_shapes, "after_warmup": n_warm,
                     "after_traffic": n_traffic},
          "engine_calls": calls[0], "launches": counts,
          "predict_tile": report["predict_tile"], "traced": traced})
    return counts


# the lambda path at full width (sparse_path) and the CV (dense_cv): a grid
# of PATH_LAMBDAS from lambda_max down to PATH_RATIO of it; tol stops each
# lambda at 1e-6 of f (about a dozen float32 ulps of the sparse fit's f),
# and the cap bounds a KKT round's supersteps
PATH_LAMBDAS, PATH_RATIO = 12, 0.05
PATH_TOL, PATH_MAX_OUTER = 1e-6, 40
# dense_cv's cap: the standardized fused path takes 40 supersteps and more
# at its two smallest lambdas (NVIDIA H100 80GB HBM3, 700 W)
CV_MAX_OUTER = 200
KKT_SLACK = 1e-4            # fit_path's default, the test it re-checks


def path_probe(torch, solver):
    """Log the path's events on this one solver: each ``_run`` (lam1,
    active mask, supersteps, seconds, its ``step_s``), each gradient ``g``
    (the screening and KKT gradients) with its seconds, and each whole path
    (``_path_impl``: fit_cv runs one per fold after the full-data one) with
    its seconds; the card is synchronized around each, so the seconds are
    the host clock's for finished work.  ``release(solver)`` removes the
    probe."""
    events = []
    impl, run, grad = solver._path_impl, solver._run, solver._grad_state

    def timed(fn, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def probe_run(state, lam1, lam2, **kw):
        out, sec = timed(run, state, lam1, lam2, **kw)
        events.append({"run": lam1, "active": kw.get("active"),
                       "supersteps": out[2], "s": sec,
                       "step_s": out[1]["step_s"]})
        return out

    def probe_grad(state, weights=None):
        g, sec = timed(grad, state, weights)
        events.append({"grad": g, "s": sec})
        return g

    def probe_impl(*a, **k):
        out, sec = timed(impl, *a, **k)
        events.append({"path": sec})
        return out

    solver._path_impl = probe_impl
    solver._run, solver._grad_state = probe_run, probe_grad
    return events


def release(solver):
    del solver._path_impl, solver._run, solver._grad_state


def kkt_rounds(np, events, pf, T):
    """Per lambda of a screened path: (KKT rounds, live tiles of the last
    round, frozen coordinates violating the KKT test after it).  Each run
    is followed by its KKT gradient; a violation after a lambda's last
    round means the eighth round still found one."""
    out = {}
    for i, ev in enumerate(events):
        if "run" not in ev or ev["active"] is None:
            continue
        lam = ev["run"]
        g = events[i + 1]["grad"]
        act = ev["active"]
        viol = (~act) & (np.abs(g) > pf * lam * (1.0 + KKT_SLACK) + 1e-7)
        rounds = out.get(lam, (0,))[0] + 1
        out[lam] = (rounds, int(act.reshape(-1, T).any(axis=1).sum()),
                    int(viol.sum()))
    return out


def host_ms(torch, fn, reps: int) -> float:
    """Mean host milliseconds per call of ``fn``, the card synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def sparse_path_phase(np, torch, solver):
    """fit_path at full width, screened and then unscreened on the same
    grid, each with the launch counts and ``launch_stats`` at 0 just
    before; then one gradient check taken apart."""
    from repro_torch.kernels import ops

    nt, T = solver.design.n_tiles, solver.config.tile_size
    runs = {}
    grid = dict(n_lambdas=PATH_LAMBDAS, lam_ratio=PATH_RATIO)
    for screen in (True, False):
        events = path_probe(torch, solver)
        solver.launch_stats.update(dict.fromkeys(solver.launch_stats, 0))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        path = solver.fit_path(**grid, screen=screen,
                               max_outer=PATH_MAX_OUTER, tol=PATH_TOL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, st = ops.launch_counts(), dict(solver.launch_stats)
        release(solver)
        grid = dict(lambdas=path.lambdas)
        n_grad = sum("grad" in ev for ev in events)
        steps = [s for ev in events if "run" in ev for s in ev["step_s"]]
        runs[screen] = dict(
            path=path, counts=counts, stats=st, events=events,
            wall_s=wall, n_grad=n_grad,
            superstep_s=sum(ev["s"] for ev in events if "run" in ev),
            gradient_s=sum(ev["s"] for ev in events if "grad" in ev),
            mean_step_s=float(np.mean(steps)),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        tag = "sparse_path" + ("" if screen else " unscreened")
        f = path.f
        check(np.isfinite(f).all(), f"{tag}: non-finite f {f}")
        check(bool(path.converged.all()),
              f"{tag}: lambdas not converged {path.converged.tolist()} "
              f"after {path.n_iters.tolist()} supersteps")
        # the head: every feature at 0 (nnz counts the intercept besides)
        check(np.count_nonzero(path.betas[0]) == 0 and path.nnz[0] == 1,
              f"{tag}: head nnz {path.nnz[0]}")
        check(st["sweep_tile_launches"] + st["sweep_tiles_skipped"]
              == st["supersteps"] * nt, f"{tag}: tiles {st}")
        want = {"tile_gram": st["sweep_tile_launches"],
                "cd_tile_solve": st["sweep_tile_launches"],
                "alpha_search": 2 * st["supersteps"],
                "glm_stats": st["supersteps"] + n_grad}
        got = {k: counts[k] for k in want}
        check(got == want and sum(counts.values()) == sum(want.values()),
              f"{tag}: launches {counts} != {want}")
    scr, uns = runs[True], runs[False]
    check(scr["stats"]["sweep_tiles_skipped"] > 0,
          f"sparse_path: no tile skipped {scr['stats']}")
    check(uns["stats"]["sweep_tiles_skipped"] == 0,
          f"sparse_path unscreened: tiles skipped {uns['stats']}")
    pf = solver._penf_host
    lambdas = scr["path"].lambdas
    kkt = kkt_rounds(np, scr["events"], pf, T)
    bad = {lam: v for lam, v in kkt.items() if v[2]}
    check(len(kkt) == len(lambdas) and not bad,
          f"sparse_path: KKT violated after the last round at {bad}")
    fs, fu = scr["path"].f, uns["path"].f
    gap = fs - fu - 1e-5 * np.maximum(1.0, np.abs(fu))
    check(bool((gap <= 0).all()),
          f"sparse_path: screened f above unscreened {fs} {fu}")
    # a gradient check at the path's last state, taken apart: K1, the
    # brick X^T s (a host loop of 65 einsums) and the copy of g to the
    # host; device ms from CUDA events (one call behind the sleep kernel),
    # host ms synchronized
    y, xb = solver._ys, solver._state.xb
    w, o = solver._wobs, solver._offsets
    _, s_i, _ = ops.glm_stats(y, xb, "logistic", weights=w, offset=o)
    rmatvec = lambda: solver.design.rmatvec(s_i)
    g = rmatvec()
    split = {"glm_stats_ms": time_ms(torch, lambda: ops.glm_stats(
                 y, xb, "logistic", weights=w, offset=o), 20),
             "rmatvec_ms": time_ms(torch, rmatvec, 1),
             "rmatvec_host_ms": host_ms(torch, rmatvec, 5),
             "to_host_ms": host_ms(torch, lambda: g.cpu(), 5),
             "check_host_ms": host_ms(torch, lambda: solver._grad_state(
                 solver._state), 5)}
    del g, s_i
    # standardize=True's passes on these bricks (scale-only): the moments,
    # tile by tile, and the new scaled copy, with the memory each adds above
    # what is held
    d = solver.design
    scale = torch.ones(d.n_tiles * T, device=d.device)
    std = {"bricks_gb": d.bricks.numel() * 4 / 1e9}
    for name, fn in (("col_moments", lambda: d.col_moments(w)),
                     ("scale_columns", lambda: d.scale_columns(scale))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        std[name + "_ms"] = host_ms(torch, fn, 1)
        std[name + "_extra_gb"] = \
            (torch.cuda.max_memory_allocated() - held) / 1e9
    per_lambda = [{"lam1": float(lam), "n_iters": int(scr["path"].n_iters[k]),
                   "kkt_rounds": kkt[lam][0], "live_tiles": kkt[lam][1],
                   "nnz": int(scr["path"].nnz[k]),
                   "f": float(fs[k]), "f_unscreened": float(fu[k]),
                   "n_iters_unscreened": int(uns["path"].n_iters[k])}
                  for k, lam in enumerate(map(float, lambdas))]
    emit({"phase": "sparse_path", "n_lambdas": len(lambdas),
          "lam_ratio": PATH_RATIO, "tol": PATH_TOL,
          "max_outer": PATH_MAX_OUTER, "per_lambda": per_lambda,
          **{("" if s else "unscreened_") + k: runs[s][k]
             for s in (True, False)
             for k in ("wall_s", "superstep_s", "gradient_s", "n_grad",
                       "mean_step_s", "peak_mem_gb", "stats", "counts")},
          "launches_per_superstep": {
              k: v / scr["stats"]["supersteps"]
              for k, v in scr["counts"].items() if v},
          "gradient_check": split, "standardize": std,
          "max_screened_minus_unscreened": float((fs - fu).max())})
    return scr["path"]


def path_reference_phase(np, GLMSolver, DGLMNETConfig, synthetic, dev):
    """Small paths and a small CV on the card against the same on the CPU
    (the card takes the CPU's grid): per lambda f within 1e-4 relative,
    beta within 1e-3 and nnz equal; the CV's dev_mean within 1e-4 relative
    and the same best_index."""
    out = {}
    couplings = {"gauss-seidel": DGLMNETConfig(tile_size=256),
                 "jacobi-fused": DGLMNETConfig(tile_size=256,
                                               coupling="jacobi")}
    small = {"sparse": synthetic.make_sparse(n=3000, p=700, avg_nnz=20,
                                             k_true=30, seed=SEED + 1),
             "dense": synthetic.make_dense(n=3000, p=300, k_true=20,
                                           seed=SEED + 1)}
    for kind, data in small.items():
        for coupling, cfg in couplings.items():
            paths = []
            for d in ("cpu", dev):
                s = GLMSolver(data.train.X, data.train.y, config=cfg,
                              fit_intercept=True, device=d)
                grid = dict(lambdas=paths[0].lambdas) if paths else \
                    dict(n_lambdas=6, lam_ratio=0.05)
                paths.append(s.fit_path(**grid, max_outer=30, tol=1e-4))
            pc, pg = paths
            f_err = float(np.max(np.abs(pg.f / pc.f - 1)))
            b_err = float(np.max(np.abs(pg.betas - pc.betas)))
            out[f"{kind}/{coupling}"] = {
                "f_rel_err": f_err, "beta_abs_err": b_err,
                "nnz_cpu": pc.nnz.tolist(), "nnz_gpu": pg.nnz.tolist(),
                "n_iters_cpu": pc.n_iters.tolist(),
                "n_iters_gpu": pg.n_iters.tolist()}
            check(f_err <= 1e-4 and b_err <= 1e-3
                  and np.array_equal(pc.nnz, pg.nnz),
                  f"path_reference {kind} {coupling}: f {f_err} beta "
                  f"{b_err} nnz {pc.nnz.tolist()} {pg.nnz.tolist()}")
    cvs = []
    for d in ("cpu", dev):
        s = GLMSolver(small["dense"].train.X, small["dense"].train.y,
                      config=couplings["jacobi-fused"], fit_intercept=True,
                      standardize=True, device=d)
        grid = dict(lambdas=cvs[0].lambdas) if cvs else \
            dict(n_lambdas=6, lam_ratio=0.01)
        cvs.append(s.fit_cv(n_folds=3, **grid, max_outer=30, tol=1e-4))
    cc, cg = cvs
    dev_err = float(np.max(np.abs(cg.dev_mean / cc.dev_mean - 1)))
    out["dense_cv_standardized"] = {
        "dev_mean_rel_err": dev_err, "best_index_cpu": cc.best_index,
        "best_index_gpu": cg.best_index}
    check(dev_err <= 1e-4 and cc.best_index == cg.best_index,
          f"path_reference cv: dev_mean {dev_err}, best index "
          f"{cc.best_index} {cg.best_index}")
    emit({"phase": "path_reference",
          "tolerance": {"f_rel": 1e-4, "beta_abs": 1e-3, "nnz": "equal",
                        "dev_mean_rel": 1e-4}, **out})


def dense_cv_phase(np, torch, GLMSolver, DGLMNETConfig, dd, dev):
    """fit_cv at full width: the dense split standardized (centered, with
    an intercept), fused Jacobi, 3 folds over an 8-lambda grid.  Every
    lambda of every path must converge within CV_MAX_OUTER supersteps.  On
    this split the validation deviance still falls at the grid's last
    lambda, so the selection lands on the grid's end: the phase holds the
    mechanics (folds, deviances, the refit at best_index), not an interior
    minimum."""
    from repro_torch.kernels import ops

    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    s = full_size_solver(GLMSolver, dd, dev, DGLMNETConfig(
        coupling="jacobi"), standardize=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    data = s.design.data
    design_gb = data.numel() * 4 / 1e9
    setup_peak = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    held = (torch.cuda.memory_allocated() - mem0) / 1e9
    # one copy is held after construction: the unscaled one was freed
    check(held < 1.2 * design_gb,
          f"dense_cv: {held} GB held after standardization for a "
          f"{design_gb} GB design")
    check(bool((data[:, s._icol()] == 1.0).all()),
          "dense_cv: the intercept column is not exact ones")
    # standardization's two device passes, timed again on the scaled
    # design (the same shapes): the moments, and the new scaled copy
    std_ms = {"col_moments_ms": host_ms(
                  torch, lambda: s.design.col_moments(s._wobs), 1),
              "scale_columns_ms": host_ms(
                  torch, lambda: s.design.scale_columns(
                      s._put(s._scale_packed), s._put(s._center_packed)), 1)}

    events = path_probe(torch, s)
    t0 = time.perf_counter()
    lmax = s.lambda_max()
    torch.cuda.synchronize()
    lmax_s = time.perf_counter() - t0
    s.launch_stats.update(dict.fromkeys(s.launch_stats, 0))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    n_before = len(events)
    t0 = time.perf_counter()
    cv = s.fit_cv(n_folds=3, n_lambdas=8, lam_ratio=1e-2,
                  max_outer=CV_MAX_OUTER, tol=PATH_TOL)
    torch.cuda.synchronize()
    cv_s = time.perf_counter() - t0
    counts, st = ops.launch_counts(), dict(s.launch_stats)
    peak = torch.cuda.max_memory_allocated() / 1e9
    release(s)
    events = events[n_before:]
    n_grad = sum("grad" in ev for ev in events)
    paths_s = [ev["path"] for ev in events if "path" in ev]
    check(np.isfinite(cv.dev_mean).all(),
          f"dense_cv: dev_mean {cv.dev_mean}")
    check(len(paths_s) == 4 and bool(cv.path.converged.all()),
          f"dense_cv: lambdas not converged {cv.path.converged.tolist()} "
          f"after {cv.path.n_iters.tolist()} supersteps")
    check(np.array_equal(cv.beta, cv.path.betas[cv.best_index]),
          "dense_cv: beta is not the full-data path's at best_index")
    want = {"stats_gram_solve": st["supersteps"],
            "margin_ls": st["supersteps"], "glm_stats": n_grad}
    check(counts == {k: want.get(k, 0) for k in counts},
          f"dense_cv: launches {counts} != {want}")
    check(st["sweep_tile_launches"] + st["sweep_tiles_skipped"]
          == st["supersteps"] * s.design.n_tiles, f"dense_cv: tiles {st}")
    emit({"phase": "dense_cv", "train_shape": list(dd.train.X.shape),
          "design_gb": design_gb, "setup_s": setup_s,
          "standardize": std_ms, "setup_peak_gb": setup_peak,
          "held_after_setup_gb": held, "lambda_max": lmax,
          "lambda_max_s": lmax_s, "cv_s": cv_s,
          "full_path_s": paths_s[0], "fold_path_s": paths_s[1:],
          "gradient_s": sum(ev["s"] for ev in events if "grad" in ev),
          "n_grad": n_grad, "superstep_s_mean": float(np.mean(
              [x for ev in events if "run" in ev for x in ev["step_s"]])),
          "dev_mean": cv.dev_mean.tolist(), "dev_se": cv.dev_se.tolist(),
          "best_index": cv.best_index, "lam_best": cv.lam_best,
          "selection_at_grid_end": cv.best_index == len(cv.lambdas) - 1,
          "max_outer": CV_MAX_OUTER,
          "nnz": cv.path.nnz.tolist(), "n_iters": cv.path.n_iters.tolist(),
          "converged": cv.path.converged.tolist(), "stats": st,
          "launches": counts, "peak_mem_gb": peak})


# checkpoint: the sparse fit cut at CKPT_CUT supersteps (a save every
# CKPT_EVERY) and resumed in a fresh session, against the fit run through
# (tol 0: a fit stops only where f repeats to the last bit, or at
# CKPT_MAX_OUTER); the path cut after PATH_CUT of sparse_path's lambdas
CKPT_EVERY, CKPT_CUT, CKPT_MAX_OUTER, PATH_CUT = 5, 10, 20, 6
# multinomial: classes, nonzero rows of B a class, cycles
MN_CLASSES, MN_SUPPORT, MN_CYCLES = 4, 50, 3


def checkpoint_phase(np, torch, GLMSolver, solver, ds, dev, path):
    """Checkpoints of the sparse solver (``fit(ckpt_manager=)`` saved
    synchronously, ``fit_path(ckpt_manager=)`` asynchronously), each cut
    and resumed in a fresh session.  Two fits run through first show
    whether the card's fits give the same bits; if they do the resumed
    beta, f and alpha are held to those bits, else within 1e-6.  ``path``
    is sparse_path's screened path, the uninterrupted one."""
    from repro_torch.checkpoint import CheckpointManager

    class Timed(CheckpointManager):
        """Records each save's seconds: the call (what the fit waits for)
        and until the checkpoint is durable (the writer joined)."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.saves = []

        def save(self, step, tree, *, metadata=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().save(step, tree, metadata=metadata)
            call = time.perf_counter() - t0
            self.wait()
            self.saves.append({"step": step, "call_ms": call * 1e3,
                               "durable_ms":
                                   (time.perf_counter() - t0) * 1e3})

    def on_disk(mgr):
        d = mgr.dir / f"ckpt_{mgr.latest_step()}"
        return sum(f.stat().st_size for f in d.iterdir())

    fit = dict(lam1=LAM1_FRACTION * solver.lambda_max(), tol=0.0)
    runs = [solver.fit(max_outer=CKPT_MAX_OUTER, **fit) for _ in range(2)]
    full = runs[0]
    same = np.array_equal(runs[0].beta, runs[1].beta) and all(
        runs[0].history[k] == runs[1].history[k] for k in ("f", "alpha"))
    twice_gap = float(np.abs(runs[0].beta - runs[1].beta).max())
    check(full.n_iter > CKPT_EVERY, f"checkpoint: the fit stops after "
          f"{full.n_iter} supersteps, before its first save")
    cut = min(CKPT_CUT, CKPT_EVERY * ((full.n_iter - 1) // CKPT_EVERY))
    pargs = dict(max_outer=PATH_MAX_OUTER, tol=PATH_TOL)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        fit_mgr = Timed(tmp / "fit")
        solver.fit(max_outer=cut, ckpt_manager=fit_mgr,
                   ckpt_every=CKPT_EVERY, **fit)
        check(fit_mgr.latest_step() == cut,
              f"checkpoint: last save {fit_mgr.latest_step()}, cut {cut}")
        fit_bytes = on_disk(fit_mgr)
        st = solver._state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back, _ = fit_mgr.restore({"beta": st.beta, "xb": st.xb,
                                   "mu": st.mu})
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        check(all(v.is_cuda for v in back.values()),
              "checkpoint: restore left a tensor off the card")
        del back, st
        path_mgr = Timed(tmp / "path", async_save=True)
        solver.fit_path(lambdas=path.lambdas[:PATH_CUT],
                        ckpt_manager=path_mgr, **pargs)
        path_bytes = on_disk(path_mgr)

        t0 = time.perf_counter()
        fresh = full_size_solver(GLMSolver, ds, dev)
        torch.cuda.synchronize()
        fresh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = fresh.fit(max_outer=CKPT_MAX_OUTER, ckpt_every=CKPT_EVERY,
                        ckpt_manager=CheckpointManager(tmp / "fit"), **fit)
        resume_fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pres = fresh.fit_path(lambdas=path.lambdas, **pargs,
                              ckpt_manager=CheckpointManager(tmp / "path"))
        resume_path_s = time.perf_counter() - t0
        del fresh
    torch.cuda.empty_cache()

    def held(a, b):
        """The same bits on a deterministic card, else within 1e-6."""
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.array_equal(a, b) if same else \
            bool(np.all(np.abs(a - b) <= 1e-6 * np.maximum(1.0, np.abs(b))))

    gaps = {"fit_beta": float(np.abs(res.beta - full.beta).max()),
            "path_prefix_beta": float(np.abs(
                pres.betas[:PATH_CUT] - path.betas[:PATH_CUT]).max()),
            "path_tail_beta": float(np.abs(
                pres.betas[PATH_CUT:] - path.betas[PATH_CUT:]).max()),
            "path_tail_f_rel": float(np.max(np.abs(
                pres.f[PATH_CUT:] / path.f[PATH_CUT:] - 1)))}
    check(res.n_iter == full.n_iter,
          f"checkpoint: resumed n_iter {res.n_iter} != {full.n_iter}")
    check(held(res.beta, full.beta) and all(
        held(res.history[k], full.history[k][cut:]) for k in ("f", "alpha")),
        f"checkpoint: the resumed fit parts from the uninterrupted one "
        f"{gaps}")
    check(np.array_equal(pres.betas[:PATH_CUT], path.betas[:PATH_CUT])
          if same else held(pres.betas[:PATH_CUT], path.betas[:PATH_CUT]),
          f"checkpoint: the path's completed prefix changed {gaps}")
    check(np.array_equal(pres.nnz, path.nnz)
          and np.array_equal(pres.n_iters, path.n_iters)
          and held(pres.f, path.f) and held(pres.betas, path.betas),
          f"checkpoint: the resumed path's tail parts {gaps} nnz "
          f"{pres.nnz.tolist()} {path.nnz.tolist()} n_iters "
          f"{pres.n_iters.tolist()} {path.n_iters.tolist()}")
    emit({"phase": "checkpoint", "deterministic": bool(same),
          "two_runs_beta_gap": twice_gap, "n_iter": full.n_iter, "cut": cut,
          "ckpt_every": CKPT_EVERY, "path_cut": PATH_CUT,
          "n_lambdas": len(path.lambdas), "fit_ckpt_bytes": fit_bytes,
          "path_ckpt_bytes": path_bytes, "fit_saves_sync": fit_mgr.saves,
          "path_saves_async": path_mgr.saves, "restore_ms": restore_ms,
          "fresh_session_s": fresh_s, "resume_fit_s": resume_fit_s,
          "resume_path_s": resume_path_s, "gaps": gaps,
          "f_after_cut": res.history["f"],
          "alpha_after_cut": res.history["alpha"]})


# the trace phase: supersteps of the traced fit and its checkpoint period,
# the lambdas of sparse_path's grid it traces (from the third: the strong
# rule at a cold start below lambda_max misses coordinates, so KKT rounds
# follow), traced and untraced fits timed in turns, disabled spans timed
TRACE_STEPS, TRACE_CKPT_EVERY = 5, 2
TRACE_PATH_FROM, TRACE_PATH_LAMBDAS = 2, 4
TRACE_TURNS = (False, True, True, False, False, True)
TRACE_NOOP_SPANS, RECORD_LAUNCH_CALLS = 1000, 100_000
K1_K4 = {"glm_stats": "glm_stats_", "tile_gram": "tile_gram_",
         "cd_tile_solve": "cd_tile_solve_", "alpha_search": "alpha_search_"}


def save_shard(tdir, tag: str):
    """Write the enabled tracer's events as ``trace_<pid>_<tag>.json`` in
    ``tdir`` (each traced part of the run its own shard, so a later
    ``enable`` overwrites none), then disable it; returns its events."""
    from repro_torch.obs import trace

    tr = trace.get_tracer()
    tr.save(pathlib.Path(tdir) / f"trace_{tr.pid}_{tag}.json")
    trace.disable()
    return tr.export()["traceEvents"]


def span_counts(events) -> dict:
    out = {}
    for e in events:
        if e["ph"] == "B":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def ranges_hold_launches(torch, prof, name: str, prefixes) -> tuple:
    """(the host ranges named ``name`` in a profile, {kernel: [device
    records, records whose host launch was found, launches inside a
    range]}) for the kernels of ``prefixes``.  A record's launch is the
    runtime call with its correlation id, on the host's clock."""
    from torch.autograd import DeviceType

    from repro_torch.analysis.audit import short_name
    evs = prof.events()
    ranges = [(e.time_range.start, e.time_range.end) for e in evs
              if e.name == name and e.device_type == DeviceType.CPU]
    launch_at = {e.id: e.time_range.start for e in evs
                 if e.device_type == DeviceType.CPU and "aunch" in e.name}
    out = {k: [0, 0, 0] for k in prefixes}
    for e in evs:
        if e.device_type != DeviceType.CUDA:
            continue
        kname = short_name(e.name)
        for k, pre in prefixes.items():
            if kname.startswith(pre):
                out[k][0] += 1
                t = launch_at.get(e.id)
                if t is not None:
                    out[k][1] += 1
                    out[k][2] += any(a <= t <= b for a, b in ranges)
    return ranges, out


def tracing_parts(torch, tdir) -> dict:
    """Median us of each part of tracing a superstep, alone, over
    TRACE_NOOP_SPANS calls: a disabled span, an enabled span with its
    ``record_function`` and NVTX ranges, one convergence event written and
    flushed into ``tdir`` (the trace directory's file system); and their
    sum for the one span and one event a traced superstep adds."""
    from repro_torch.obs import convergence, trace
    from repro_torch.timing import percentiles

    def median_us(fn):
        out = []
        for _ in range(TRACE_NOOP_SPANS):
            t0 = time.perf_counter_ns()
            fn()
            out.append((time.perf_counter_ns() - t0) / 1e3)
        return percentiles(out)["p50"]

    def span_in(tr):
        def fn():
            with tr.span("bench/noop"):
                pass
        return fn

    event = dict(step=1, outer_it=1, lam1=1.0, lam2=0.0, f=1.0, loss=1.0,
                 deviance=1.0, alpha=1.0, mu=1.0, nnz=1, accepted_unit=1.0,
                 active_size=1, supersteps=1, sweep_tile_launches=65,
                 sweep_tiles_skipped=0, step_us=20000.0)
    path = pathlib.Path(tdir) / "bench.jsonl"
    with convergence.ConvergenceStream(path) as cs:
        emit_us = median_us(lambda: cs.emit(**event))
    path.unlink()
    span_us = median_us(span_in(trace.Tracer()))
    return {"disabled_span_us_median": median_us(span_in(trace.NullTracer())),
            "enabled_span_us_median": span_us,
            "stream_event_us_median": emit_us,
            "tracing_us_per_superstep": span_us + emit_us}


def trace_phase(np, torch, solver, path, tdir, card):
    """The sparse fit traced (``repro_torch.obs``), through the entry
    points a user calls: ``trace.enable``, a convergence stream on the
    session, ``fit`` with checkpoints and its resume, a profiled
    superstep, a screened ``fit_path`` over TRACE_PATH_LAMBDAS lambdas of
    sparse_path's grid, then ``trace_report`` over the directory.  Gates:
    the traced fit equals the untraced one bit for bit (beta, f, alpha,
    n_iter, launch counts); one stream event a superstep with f equal to
    ``history["f"]``; the span counts; ``launch_trace`` of one superstep
    equal to its ``launch_counts``; the profiled superstep's range
    holding the host launches of K1-K4; the path's stream context.  Then
    the overheads: traced and untraced ``superstep_s`` in turns, the
    disabled span, ``record_launch`` outside a trace."""
    import collections
    import contextlib

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch import trace_report
    from repro_torch.obs import convergence, metrics, trace

    t_phase = time.perf_counter()
    nt = solver.design.n_tiles
    lam1 = LAM1_FRACTION * solver.lambda_max()
    fit = dict(lam1=lam1, max_outer=TRACE_STEPS, tol=0.0,
               ckpt_every=TRACE_CKPT_EVERY)

    def counted(**kw):
        ops.reset_launch_counts()
        res = solver.fit(**kw)
        torch.cuda.synchronize()
        return res, ops.launch_counts()

    with tempfile.TemporaryDirectory(prefix="trace-ckpt-") as ck:
        ck = pathlib.Path(ck)
        plain, plain_counts = counted(
            ckpt_manager=CheckpointManager(ck / "untraced"), **fit)
        tr = trace.enable(tdir)
        conv_path = pathlib.Path(tdir) / f"convergence_{tr.pid}.jsonl"
        stream = convergence.ConvergenceStream(conv_path)
        solver.set_convergence_stream(stream)
        traced, traced_counts = counted(
            ckpt_manager=CheckpointManager(ck / "traced"), **fit)
        n_fit = stream.n_events
        fit_spans = span_counts(tr.export()["traceEvents"])
        resumed = solver.fit(ckpt_manager=CheckpointManager(ck / "traced"),
                             **fit)
        torch.cuda.synchronize()
    spans = span_counts(tr.export()["traceEvents"])
    check(np.array_equal(traced.beta, plain.beta)
          and traced.history["f"] == plain.history["f"]
          and traced.history["alpha"] == plain.history["alpha"]
          and traced.n_iter == plain.n_iter == TRACE_STEPS
          and traced_counts == plain_counts,
          f"trace: the traced fit differs from the untraced one: n_iter "
          f"{traced.n_iter} / {plain.n_iter}, f {traced.history['f']} / "
          f"{plain.history['f']}, launches {traced_counts} / "
          f"{plain_counts}, beta gap "
          f"{float(np.abs(traced.beta - plain.beta).max())}")
    evs = convergence.read_events(conv_path)
    check(n_fit == TRACE_STEPS and [e["f"] for e in evs[:n_fit]]
          == traced.history["f"] and all(e["step_us"] for e in evs),
          f"trace: {n_fit} stream events, f {[e['f'] for e in evs]} for "
          f"{traced.history['f']}")
    n_saves = TRACE_STEPS // TRACE_CKPT_EVERY
    check(fit_spans == {"solver/superstep": TRACE_STEPS,
                        "ckpt/save": n_saves, "ckpt/commit": n_saves},
          f"trace: spans of the traced fit {fit_spans}")
    # the resumed fit restores the last save and runs the supersteps after
    # it, to the fit run through
    check(spans.get("ckpt/restore") == 1 and resumed.n_iter == TRACE_STEPS
          and np.array_equal(resumed.beta, traced.beta)
          and resumed.history["f"] == traced.history["f"][n_saves
                                                         * TRACE_CKPT_EVERY:],
          f"trace: resume spans {spans}, n_iter {resumed.n_iter}, f "
          f"{resumed.history['f']}")

    # one profiled superstep, traced: its range, its K1-K4 launches, and
    # the span's us beside step_s and the device's busy time
    prof, pres, pwall, _ = profiled_fit(torch, solver, lam1, 1)
    ranges, held = ranges_hold_launches(torch, prof, "solver/superstep",
                                        K1_K4)
    want_rec = {"glm_stats": 1, "alpha_search": 2}
    check(len(ranges) == 1 and all(
        n_rec >= want_rec.get(k, nt) and n_rec == found == inside
        for k, (n_rec, found, inside) in held.items()),
        f"trace: profiled superstep ranges {len(ranges)}, K1-K4 records "
        f"[records, launches found, inside] {held}")
    busy = device_idle(torch, prof, pwall)
    prof_span_us = convergence.read_events(conv_path)[-1]["step_us"]
    del prof

    # a screened path over part of sparse_path's grid
    lambdas = path.lambdas[TRACE_PATH_FROM:TRACE_PATH_FROM
                           + TRACE_PATH_LAMBDAS]
    n0 = stream.n_events
    tpath = solver.fit_path(lambdas=lambdas, max_outer=PATH_MAX_OUTER,
                            tol=PATH_TOL)
    pev = convergence.read_events(conv_path)[n0:]
    check(len(pev) == int(tpath.n_iters.sum()), f"trace path: {len(pev)} "
          f"events for {tpath.n_iters.tolist()} supersteps")
    rounds = collections.Counter()
    ctx_ok = True
    for e in pev:
        k = e["lam_index"]
        if e["outer_it"] == 1:
            rounds[k] += 1
        first = rounds[k] == 1
        ctx_ok &= isinstance(e["screened"], int) and e["screened"] >= 0 and (
            e["kkt_violations"] is None if first
            else isinstance(e["kkt_violations"], int)
            and e["kkt_violations"] > 0)
    ctx = [(e["lam_index"], e["outer_it"], e["screened"],
            e["kkt_violations"]) for e in pev]
    check(sorted(rounds) == list(range(len(lambdas))) and ctx_ok,
          f"trace path: lam_index rounds {dict(rounds)}, context "
          f"{ctx[:20]}")
    solver.set_convergence_stream(None)
    stream.close()
    all_spans = span_counts(save_shard(tdir, "fit"))

    # logical launches of one superstep, against the kernels' counts
    ops.reset_launch_counts()
    with ops.launch_trace() as lev:
        solver.fit(lam1=lam1, max_outer=1, tol=0.0)
    torch.cuda.synchronize()
    delta = ops.launch_counts()
    by = collections.Counter(lev)
    want = {"glm_stats": 1, "cd_tile_solve": nt, "tile_gram": nt,
            "alpha_search": 2}
    check({k: by.get(k, 0) for k in want} == {k: delta[k] for k in want}
          == want and set(by) <= set(want) | {"matvec"}
          and sum(delta.values()) == sum(want.values()),
          f"trace: launch_trace {dict(by)} against launch_counts {delta}")

    # overheads: traced and untraced superstep_s in turns (the traced fits
    # with a stream), then each part of the tracing alone
    turns = []
    with tempfile.TemporaryDirectory(prefix="trace-turns-") as td:
        for i, on in enumerate(TRACE_TURNS):
            with contextlib.ExitStack() as stack:
                if on:
                    trace.enable()
                    stack.callback(trace.disable)
                    st = stack.enter_context(convergence.ConvergenceStream(
                        pathlib.Path(td) / f"c{i}.jsonl"))
                    solver.set_convergence_stream(st)
                    stack.callback(solver.set_convergence_stream, None)
                r = solver.fit(lam1=lam1, max_outer=TRACE_STEPS, tol=0.0)
            turns.append({"traced": on, "superstep_s": r.history["step_s"]})
    steps_of = {on: [x for t in turns if t["traced"] == on
                     for x in t["superstep_s"][1:]] for on in (False, True)}
    med = {on: float(np.median(v)) for on, v in steps_of.items()}
    parts = tracing_parts(torch, tdir)
    t0 = time.perf_counter()
    for _ in range(RECORD_LAUNCH_CALLS):
        ops.record_launch("glm_stats")
    record_us = (time.perf_counter() - t0) / RECORD_LAUNCH_CALLS * 1e6

    # the report over what the serve and trace phases wrote
    metrics.save_default(tdir)
    out_json = pathlib.Path(tdir) / "summary.json"
    with contextlib.redirect_stdout(sys.stderr):
        rc = trace_report.main([str(tdir), "--json", str(out_json)])
    check(rc == 0, f"trace_report exited {rc}")
    rep = json.loads(out_json.read_text())
    out_json.unlink()
    rep_counts = {r["span"]: r["count"] for r in rep["spans"]}
    check(all(rep_counts.get(k, 0) >= v for k, v in all_spans.items())
          and rep["convergence"]["n_events"] == len(
              convergence.read_events(conv_path)),
          f"trace_report: spans {rep_counts} for {all_spans}")
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "trace", "card": card, "phase_s": phase_s,
          "supersteps": TRACE_STEPS, "ckpt_every": TRACE_CKPT_EVERY,
          "traced_equals_untraced": True, "spans": all_spans,
          "stream_events": len(convergence.read_events(conv_path)),
          "span_us_vs_step_s": [
              {"span_us": e["step_us"], "step_s": s_}
              for e, s_ in zip(evs[:n_fit], traced.history["step_s"])],
          "profiled_superstep": {
              "span_us": prof_span_us, "step_s": pres.history["step_s"][0],
              "device_busy_ms": busy["busy_s"] * 1e3,
              "idle_share": busy["idle_share"],
              "k1_k4_records_launches_inside": held},
          "launches": {k: v for k, v in traced_counts.items() if v},
          "launch_trace": dict(by), "launch_counts_delta": {
              k: v for k, v in delta.items() if v},
          "path": {"lambdas": [float(x) for x in lambdas],
                   "n_iters": tpath.n_iters.tolist(),
                   "kkt_rounds": {str(k): v for k, v in rounds.items()},
                   "events": len(pev)},
          "overhead": {
              "turns": turns, "median_superstep_s_untraced": med[False],
              "median_superstep_s_traced": med[True],
              "traced_over_untraced": med[True] / med[False] - 1.0,
              "min_superstep_s_untraced": min(steps_of[False]),
              "min_superstep_s_traced": min(steps_of[True]),
              **parts,
              "record_launch_us_per_call": record_us,
              "record_launch_us_per_superstep": record_us * sum(by.values()),
              "logical_launches_per_superstep": sum(by.values())},
          "report": {"n_spans": rep["n_spans"], "top_spans": rep["spans"][:8],
                     "phase_attribution": rep["phase_attribution"],
                     "convergence": rep["convergence"],
                     "metrics_counters": (rep["metrics"] or {}).get(
                         "counters")}})


def multinomial_phase(np, torch, GLMSolver, DGLMNETConfig, ds, dev):
    """``MultinomialGLM`` on the sparse train split, 4 classes: labels the
    argmax of X B + 0.3 noise (B seeded, 50 nonzero rows a class, on
    frequent features, each class's margins scaled to std 2 as
    make_sparse plants its signal); lam1 0.05 of class 0's one-vs-rest
    logistic lambda_max on the session the estimator fits (standardized,
    with an intercept).  Each class visit is a full-width logistic fit
    through K1-K4.  The estimator's objective (the reference's) puts the
    penalty on the original-scale coefficients while each visit minimizes
    it on the standardized ones, so the objective held to never rise is
    the latter: the same loss with the penalty on coef / scale."""
    from repro_torch.glm import MultinomialGLM
    from repro_torch.kernels import ops

    X = ds.train.X
    n, p = X.shape
    rng = np.random.default_rng(SEED + 2)
    t0 = time.perf_counter()
    M = np.zeros((n, MN_CLASSES))
    for k in range(MN_CLASSES):
        b = np.zeros(p)
        b[rng.choice(min(p, 4000), MN_SUPPORT, replace=False)] = \
            rng.normal(size=MN_SUPPORT)
        m = np.bincount(X.rows, weights=X.vals * b[X.cols], minlength=n)
        M[:, k] = m / max(m.std(), 1e-6) * 2.0
    yk = np.argmax(M + 0.3 * rng.normal(size=M.shape), axis=1)
    labels_s = time.perf_counter() - t0
    del M
    majority = max(float(np.mean(yk == k)) for k in range(MN_CLASSES))
    cfg = DGLMNETConfig(tile_size=256, max_outer=50, tol=1e-6)
    t0 = time.perf_counter()
    s0 = GLMSolver(X, np.where(yk == 0, 1.0, -1.0), family="logistic",
                   config=cfg, fit_intercept=True, standardize=True,
                   device=dev)
    lam1 = 0.05 * s0.lambda_max()
    lmax_s = time.perf_counter() - t0
    del s0
    torch.cuda.empty_cache()

    est = MultinomialGLM(lam1=lam1, tile_size=256, standardize=True,
                         max_cycles=MN_CYCLES, max_outer=50, tol=1e-6,
                         device=dev)
    objs, std_objs, visits = [], [], []
    objective = est._objective

    def recorded(*a):
        """The estimator's objective, and beside it the standardized one."""
        f = objective(*a)
        scale = est.solver_._info.unpack_beta(
            est.solver_._scale_packed)[:est.coef_.shape[0]]
        objs.append(f)
        std_objs.append(f + lam1 * float(
            np.abs(est.coef_ / scale[:, None]).sum()
            - np.abs(est.coef_).sum()))
        return f

    est._objective = recorded
    fit = GLMSolver.fit

    def visit(self, *a, **k):
        t = time.perf_counter()
        r = fit(self, *a, **k)
        visits.append((r.n_iter, time.perf_counter() - t))
        return r

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    GLMSolver.fit = visit
    try:
        t0 = time.perf_counter()
        est.fit(X, yk)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        GLMSolver.fit = fit
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    S = est.solver_.launch_stats["supersteps"]
    nt = est.solver_.design.n_tiles
    check(S == sum(v[0] for v in visits)
          and len(visits) == MN_CLASSES * est.n_cycles_,
          f"multinomial: {S} supersteps, visits {visits}")
    want = {"glm_stats": S, "cd_tile_solve": nt * S, "tile_gram": nt * S,
            "alpha_search": 2 * S}
    check(counts == {k: want.get(k, 0) for k in counts},
          f"multinomial: launches {counts} != {want}")
    check(all(np.isfinite(std_objs)) and all(
        b <= a + 1e-6 * abs(a) for a, b in zip(std_objs, std_objs[1:])),
          f"multinomial: the objective rose {std_objs}")
    ops.reset_launch_counts()
    proba = est.predict_proba(X)
    pred_counts = ops.launch_counts()
    check(pred_counts["predict_tile"] > 0 and sum(pred_counts.values())
          == pred_counts["predict_tile"],
          f"multinomial: predict launches {pred_counts}")
    row_err = float(np.abs(proba.sum(axis=1) - 1.0).max())
    acc = float(np.mean(est.classes_[np.argmax(proba, axis=1)] == yk))
    check(proba.shape == (n, MN_CLASSES) and row_err <= 1e-5,
          f"multinomial: predict_proba rows off 1 by {row_err}")
    check(acc >= majority + 0.1,
          f"multinomial: training accuracy {acc}, majority {majority}")
    K = MN_CLASSES
    cycle_s = [sum(v[1] for v in visits[c * K:(c + 1) * K])
               for c in range(est.n_cycles_)]
    emit({"phase": "multinomial", "classes": K, "n": n, "p": p,
          "support_per_class": MN_SUPPORT, "labels_s": labels_s,
          "lam1": lam1, "lambda_max_s": lmax_s, "n_cycles": est.n_cycles_,
          "objective_per_cycle": objs,
          "standardized_objective_per_cycle": std_objs, "fit_s": fit_s,
          "cycle_s": cycle_s, "supersteps_per_visit": [v[0] for v in visits],
          "visit_s": [v[1] for v in visits], "supersteps": S,
          "superstep_ms_mean": 1e3 * sum(v[1] for v in visits) / S,
          "peak_mem_gb": peak, "launches": counts,
          "predict_launches": pred_counts, "train_accuracy": acc,
          "majority_share": majority, "proba_row_sum_err": row_err,
          "nnz_per_class": (est.coef_ != 0).sum(axis=0).tolist()})
    del est
    torch.cuda.empty_cache()
    return counts


def estimator_phase(np, torch, GLMSolver, DGLMNETConfig, synthetic, ds, dev,
                    lam1):
    """``LogisticRegressionCD`` on the sparse data ({0, 1} labels, the
    sparse fit's lam1, unstandardized like that fit): saved in fp32 and
    int8 and loaded; the loaded model's test-split predictions (SparseCOO,
    K7) against the fitted estimator's, int8 margins within the manifest's
    bound; ``serve_glm.main`` over the artifact; then a family registered
    under a new name with the squared formulas, fitted on the card (it
    must take the plain route) and held against the squared fit on the
    CPU."""
    import contextlib
    import io

    from repro_torch.core import glm
    from repro_torch.glm import LogisticRegressionCD
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_glm
    from repro_torch.serve import artifact_bytes, load_artifact

    y01 = (ds.train.y > 0).astype(np.int64)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    est = LogisticRegressionCD(lam1=lam1, tile_size=256, standardize=False,
                               max_outer=50, tol=1e-6, device=dev)
    est.fit(ds.train.X, y01)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = ops.launch_counts()
    S = est.solver_.launch_stats["supersteps"]
    nt = est.solver_.design.n_tiles
    want = {"glm_stats": S, "cd_tile_solve": nt * S, "tile_gram": nt * S,
            "alpha_search": 2 * S}
    check(fit_counts == {k: want.get(k, 0) for k in fit_counts},
          f"estimator: fit launches {fit_counts} != {want}")
    Xte = ds.test.X
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        est.save(tmp / "fp32")
        est.save(tmp / "int8", quantize="int8")
        save_s = time.perf_counter() - t0
        sizes = {q: artifact_bytes(tmp / q) for q in ("fp32", "int8")}
        ops.reset_launch_counts()
        loaded = LogisticRegressionCD.load(tmp / "fp32")
        quant = LogisticRegressionCD.load(tmp / "int8")
        m_fit = est.decision_function(Xte)
        m_load = loaded.decision_function(Xte)
        m_q = quant.decision_function(Xte)
        same_pred = bool(np.array_equal(est.predict(Xte),
                                        loaded.predict(Xte)))
        pred_counts = ops.launch_counts()
        per_l1 = load_artifact(tmp / "int8").quant["bound_per_l1"]
        row_l1 = np.bincount(Xte.rows, weights=np.abs(Xte.vals),
                             minlength=Xte.shape[0])
        q_over = float(np.max(np.abs(m_q - m_fit) - per_l1 * row_l1))
        e_load = float(np.abs(m_load - m_fit).max())
        check(same_pred and e_load <= 1e-6,
              f"estimator: loaded predictions differ ({e_load})")
        check(q_over <= 1e-5, f"estimator: int8 margins past their bound "
                              f"by {q_over}")
        check(pred_counts["predict_tile"] > 0 and sum(pred_counts.values())
              == pred_counts["predict_tile"],
              f"estimator: predict launches {pred_counts}")
        ops.reset_launch_counts()
        rec_path = tmp / "serve_glm.json"
        with contextlib.redirect_stdout(io.StringIO()):
            rc = serve_glm.main(["--artifact", str(tmp / "fp32"),
                                 "--requests", "2000",
                                 "--json", str(rec_path)])
        serve_counts = ops.launch_counts()
        rec = json.loads(rec_path.read_text())
    check(rc == 0 and all(rec.get(k) is not None
                          for k in ("p50_ms", "p99_ms", "rows_per_s"))
          and rec["n_requests"] == 2000
          and rec["compiled_shapes"] <= rec["shape_bucket_bound"],
          f"estimator: serve_glm rc {rc}, record {rec}")
    check(serve_counts["predict_tile"] > 0 and sum(serve_counts.values())
          == serve_counts["predict_tile"],
          f"estimator: serve_glm launches {serve_counts}")
    acc = float(np.mean(est.predict(Xte) == (ds.test.y > 0)))
    out.update(fit_s=fit_s, supersteps=S, fit_launches=fit_counts,
               save_s=save_s, artifact_bytes=sizes,
               loaded_margin_err=e_load, int8_past_bound=q_over,
               int8_bound_per_l1=per_l1, predict_launches=pred_counts,
               test_accuracy=acc, serve_glm=rec,
               serve_glm_launches=serve_counts)

    # a registered family: the plain route on the card, counted apart
    small = synthetic.make_dense(n=3000, p=300, k_true=20, seed=SEED + 1)
    name = "squared_registered"
    glm.register_family(glm.GLMFamily(name, glm.SQUARED.raw_stats,
                                      glm.SQUARED.predict, 1.0))
    registered = {}
    try:
        for coupling, cfg in (
                ("gauss-seidel", DGLMNETConfig(tile_size=256)),
                ("jacobi-fused", DGLMNETConfig(tile_size=256,
                                               coupling="jacobi"))):
            kw = dict(config=cfg, fit_intercept=True)
            cpu = GLMSolver(small.train.X, small.train.y, family="squared",
                            device="cpu", **kw)
            lam = 0.05 * cpu.lambda_max()
            rc_ = cpu.fit(lam1=lam, max_outer=8, tol=0.0)
            card = GLMSolver(small.train.X, small.train.y, family=name,
                             device=dev, **kw)
            ops.reset_launch_counts()
            rg = card.fit(lam1=lam, max_outer=8, tol=0.0)
            counts = ops.launch_counts()
            S = rg.n_iter
            want = ({"glm_stats/plain": S, "alpha_search/plain": 2 * S,
                     "cd_tile_solve": card.design.n_tiles * S}
                    if coupling == "gauss-seidel" else
                    {"stats_gram_solve/plain": S, "margin_ls/plain": S})
            # tol 0 stops a fit where f repeats to the last bit, which
            # sums in another order may reach a superstep apart: the f of
            # the supersteps both ran are compared
            k = min(rg.n_iter, rc_.n_iter)
            f_err = float(np.max(np.abs(np.array(rg.history["f"][:k])
                                        / np.array(rc_.history["f"][:k])
                                        - 1)))
            b_err = float(np.max(np.abs(rg.beta - rc_.beta)))
            registered[coupling] = {"f_rel_err": f_err, "beta_abs_err": b_err,
                                    "supersteps": S,
                                    "supersteps_cpu": rc_.n_iter,
                                    "launches": {k: v for k, v in
                                                 counts.items() if v}}
            check(counts == {k: want.get(k, 0) for k in counts},
                  f"registered family {coupling}: launches {counts} != "
                  f"{want}")
            check(f_err <= 1e-4 and b_err <= 1e-3,
                  f"registered family {coupling}: card vs CPU f {f_err} "
                  f"beta {b_err}")
    finally:
        del glm.FAMILIES[name]
    emit({"phase": "estimator", **out, "registered_family": registered,
          "tolerance": {"loaded_margin_abs": 1e-6, "f_rel": 1e-4,
                        "beta_abs": 1e-3}})
    del est, loaded, quant
    torch.cuda.empty_cache()
    return fit_counts, pred_counts, serve_counts


# stream: the dense train split as a host array streamed in chunks of
# STREAM_ROWS rows (49 chunks, the last ragged) with tiles of STREAM_TILE;
# the chunk-cursor checkpoint saves every STREAM_CKPT_CHUNKS chunks and the
# fit is cut at chunk STREAM_CUT_CHUNK + 1 of superstep STREAM_CUT_STEP
STREAM_ROWS, STREAM_TILE = 8192, 256
STREAM_CKPT_CHUNKS, STREAM_CUT_STEP, STREAM_CUT_CHUNK = 16, 3, 24
STREAM_PATH_LAMBDAS, STREAM_PATH_MAX_OUTER = 4, 8
# ingest: the first INGEST_ROWS rows of the sparse train split as libsvm
# text, fitted through the CLI (the whole split, 131,072 rows, ran past the
# phase's 90 s in a trial: parsing is host Python)
INGEST_ROWS = 65_536
INGEST_ARGS = ["--hash-dim", "4096", "--chunk-rows", "4096", "--tile",
               "256", "--steps", "3"]


class _Cut(Exception):
    """The chunk source's simulated crash."""


class CutSource:
    """A chunk source over a host array that raises when it is asked for
    chunk ``chunk + 1`` in the first pass of superstep ``step`` (pass 2 s
    - 1; it counts the passes by their chunk 0): a fit cut mid-pass, after
    the chunk ``chunk`` was made."""

    def __init__(self, X, rows: int, step: int, chunk: int):
        self.X, self.rows, self.passes = X, rows, 0
        self.cut_pass, self.cut_chunk = 2 * step - 1, chunk + 1

    def __call__(self, i):
        if i == 0:
            self.passes += 1
        if self.passes == self.cut_pass and i == self.cut_chunk:
            raise _Cut(f"chunk {i} of pass {self.passes}")
        return self.X[i * self.rows:(i + 1) * self.rows]


def device_idle(torch, prof, wall_s: float) -> dict:
    """The card's busy time in a profile as the union of its records'
    intervals (the copy stream overlaps the compute stream, so their sum
    would count that time twice), and the idle share of ``wall_s``."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("ProfilerStep"))
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy_s = busy * 1e-6
    return {"busy_s": busy_s, "wall_s": wall_s,
            "idle_share": 1.0 - busy_s / wall_s, "device_records": len(spans)}


def profiled_superstep(torch, solver, lam1) -> dict:
    """One superstep of ``solver`` under torch.profiler (the host idles
    PROFILE_EDGE_S at both edges of the window, outside the timed fit):
    the card's busy time and idle share over the fit's host seconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_EDGE_S)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.fit(lam1=lam1, max_outer=1, tol=0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_EDGE_S)
    return device_idle(torch, prof, wall)


def stream_phases(torch, solver, lam1, prefetch: bool):
    """One streaming superstep from the solver's fitted state, the card
    synchronized after each of its three parts: (host seconds of the
    statistics pass, the sweep and the line-search pass, the new beta)."""
    sd, fns = solver.design, solver._superstep
    state = solver._state
    p = sd.p_pad
    sd.prefetch = prefetch
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = (torch.zeros((p, p), device=sd.device),
               torch.zeros(p, device=sd.device),
               torch.zeros((), device=sd.device))
        for _, Xc, yc, wc, oc in solver._iter_row_chunks():
            acc = fns.stats_chunk(Xc, yc, wc, oc, state.beta, acc)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prep = fns.prepare(acc, state.beta, state.mu, (lam1, 0.0),
                           solver._penf, state.cursor)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        losses = torch.zeros(fns.n_candidates, device=sd.device)
        for _, Xc, yc, wc, oc in solver._iter_row_chunks():
            losses = fns.ls_chunk(Xc, yc, wc, oc, state.beta, prep["dbeta"],
                                  losses)
        new, _ = fns.finish(losses, prep, state, (lam1, 0.0), solver._penf)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        sd.prefetch = True
    return ({"stats_s": t1 - t0, "sweep_s": t2 - t1, "line_search_s": t3 - t2,
             "superstep_s": t3 - t0}, new.beta)


def stream_kernel_report(np, torch, solver, floors, floor_lib, parity):
    """K1 and K4 (over the 294 candidates of ``full_candidates``) at the
    chunk shapes of the streaming passes (n = STREAM_ROWS and the ingest
    phase's 4,096), against their plain versions, timed beside their
    launch floor and bound as at the fit's shapes; K2 on a diagonal block
    of the streaming solver's Gram (the Gauss-Seidel sweep's input)."""
    from repro_torch.core import linesearch
    from repro_torch.kernels import alpha_search as alpha_search_k
    from repro_torch.kernels import cd_tile_solve as cd_tile_solve_k
    from repro_torch.kernels import glm_stats as glm_stats_k
    from repro_torch.kernels import ops, ref

    dev = solver.device
    rng = np.random.default_rng(SEED + 7)
    cand = linesearch.full_candidates(1e-3, 13, 0.5, 20, device=dev)
    K = int(cand.shape[0])
    vec = lambda v: torch.from_numpy(v.astype(np.float32)).to(dev)
    k1, k4 = [], []
    for n in (STREAM_ROWS, 4096):
        y = vec(rng.choice([-1.0, 1.0], n))
        w, o = vec(rng.random(n)), vec(0.1 * rng.normal(size=n))
        xb, xdb = vec(1.5 * rng.normal(size=n)), vec(rng.normal(size=n))
        got = ops.glm_stats(y, xb, "logistic", weights=w, offset=o)
        want = ref.glm_stats(y, xb, w, "logistic", offset=o)
        e1 = max(errs(a, b)[1] for a, b in zip(got, want))
        parity[f"glm_stats/n={n}/stream"] = e1
        check(e1 <= 1e-5, f"glm_stats n={n}: error {e1}")
        got = ops.alpha_search(y, xb, xdb, cand, "logistic", weights=w,
                               offset=o)
        e4 = errs(got, ref.alpha_search(y, xb, xdb, w, cand, "logistic",
                                        offset=o))[1]
        parity[f"alpha_search/n={n}/K={K}/stream"] = e4
        check(e4 <= 1e-5, f"alpha_search n={n} K={K}: error {e4}")
        ms = time_ms(torch, lambda: glm_stats_k.launch(
            y, xb, w, "logistic", offset=o), 200)
        floor = launch_floor(torch, floor_lib,
                             [(glm_stats_k.grid(n), 1, glm_stats_k.THREADS)],
                             200)
        b_ms, b_by, _, _ = timed_bound(n * 4.0 * 7, n,
                                       floors["logistic"]["stats_ns"])
        k1.append(dict(n=n, ms=ms, plain_ms=time_ms(torch, lambda: ref.
                                                    glm_stats(y, xb, w,
                                                              "logistic",
                                                              offset=o), 50),
                       bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
                       launch_floor_ms=floor, max_rel_err=e1))
        ms = time_ms(torch, lambda: alpha_search_k.launch(
            y, xb, xdb, w, cand, "logistic", offset=o), 200)
        nb, threads = alpha_search_k.grid(n, K)
        floor = launch_floor(torch, floor_lib, [(nb, 1, threads)], 200)
        b_ms, b_by, _, _ = timed_bound(n * 4.0 * 5 + 8.0 * K, n * K,
                                       floors["logistic"]["loss_ns"])
        k4.append(dict(n=n, K=K, ms=ms, plain_ms=time_ms(
            torch, lambda: ref.alpha_search(y, xb, xdb, w, cand, "logistic",
                                            offset=o), 20),
            bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
            launch_floor_ms=floor, max_rel_err=e4))
    # K2 on the Gram of the solver's last superstep state: its first tile
    T = solver.config.tile_size
    p = solver.design.p_pad
    acc = (torch.zeros((p, p), device=dev), torch.zeros(p, device=dev),
           torch.zeros((), device=dev))
    beta = solver._state.beta
    for i, Xc, yc, wc, oc in solver._iter_row_chunks():
        acc = solver._superstep.stats_chunk(Xc, yc, wc, oc, beta, acc)
        if i == 3:
            break
    G = acc[0][:T, :T].contiguous()
    g = acc[1][:T].contiguous()
    params = ops.solve_params(1.0, 1e-6, 0.05 * float(g.abs().max()), 0.0, g)
    zeros = torch.zeros(T, device=dev)
    got = ops.cd_tile_solve(G, g, torch.diagonal(G), beta[:T], zeros, params)
    want = ref.cd_tile_solve(G, g, torch.diagonal(G), beta[:T], zeros,
                             *params.unbind())
    check(torch.equal(got, want), "cd_tile_solve on the stream Gram: not "
          "bit-exact")
    k2_ms = time_ms(torch, lambda: cd_tile_solve_k.launch(
        G, g, torch.diagonal(G), beta[:T], zeros, params, None), 200)
    return {"glm_stats": k1, "alpha_search": k4,
            "cd_tile_solve": dict(T=T, ms=k2_ms, bound_ms=k2_bound(T)[0],
                                  bit_exact=True)}


def stream_phase(np, torch, GLMSolver, DGLMNETConfig, dd, dev, gs_ref,
                 jacobi_ref, lmax, floors, floor_lib, parity, card, tdir):
    """The out-of-core mode at full width: the dense train split stays a
    host array and streams through ``streaming_design`` in chunks of
    STREAM_ROWS rows.  Its Gauss-Seidel fit against the in-memory fit of
    the same superstep count (``gs_ref`` = (lam1, result)), its Jacobi fit
    against the unfused in-memory Jacobi fit (``jacobi_ref``): the same
    alpha at every superstep, f within 1e-5 relative, beta within 1e-3;
    K1 and K4 once a chunk, K2 once a swept tile or once a Jacobi
    superstep.  Prefetch off against on: every chunk, and a superstep
    from the same state, bit for bit; each timed by part.  A chunk-cursor
    resume, a short screened path with the KKT test held, the copy rate,
    the idle share of one profiled superstep and the kernels at the chunk
    shapes.  One more superstep runs traced into ``tdir``: its stream
    event's ``phase_us`` holds the three passes and sums to its
    ``step_us``; then ``trace_report`` summarizes the whole directory."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.design import streaming_design
    from repro_torch.kernels import ops
    from repro_torch.launch import trace_report
    from repro_torch.obs import convergence, trace

    t_phase = time.perf_counter()
    X, y = dd.train.X, dd.train.y
    n, p_src = X.shape

    def session(config=None, source=None):
        sd, _ = streaming_design(X if source is None else source,
                                 STREAM_TILE, chunk_rows=STREAM_ROWS,
                                 n_rows=n, n_cols=p_src, device=dev)
        return GLMSolver(sd, y, family="logistic", fit_intercept=True,
                         device=dev, config=config)

    def fit_counted(tag, s, lam1, steps, want_per_step, **kw):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = s.fit(lam1=lam1, max_outer=steps, tol=0.0, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = {k: res.n_iter * want_per_step.get(k, 0) for k in counts}
        check(counts == want, f"{tag}: launches {counts} != {want}")
        return res, counts, wall, torch.cuda.max_memory_allocated() / 1e9

    def against(tag, res, ref):
        f, fr = np.asarray(res.history["f"]), np.asarray(ref.history["f"])
        f_err = float(np.max(np.abs(f / fr - 1))) if len(f) == len(fr) \
            else np.inf
        b_err = float(np.max(np.abs(res.beta - ref.beta)))
        check(res.n_iter == ref.n_iter
              and res.history["alpha"] == ref.history["alpha"]
              and f_err <= 1e-5 and b_err <= 1e-3,
              f"{tag}: against the in-memory fit: n_iter {res.n_iter} / "
              f"{ref.n_iter}, alpha {res.history['alpha']} / "
              f"{ref.history['alpha']}, f {f_err}, beta {b_err}")
        return {"f_rel_err": f_err, "beta_abs_err": b_err,
                "alpha": res.history["alpha"]}

    t0 = time.perf_counter()
    s = session()
    setup_s = time.perf_counter() - t0
    sd = s.design
    nc, nt = sd.n_chunks, sd.n_tiles
    last = sd.n_rows_data - (nc - 1) * STREAM_ROWS
    check((nc, sd.p_pad, nt, last) == (49, 2048, 8, 6784),
          f"stream: layout {(nc, sd.p_pad, nt, last)}")
    lam1, gs_res = gs_ref
    steps = gs_res.n_iter
    res, gs_counts, gs_wall, peak = fit_counted(
        "stream", s, lam1, steps,
        {"glm_stats": nc, "alpha_search": nc, "cd_tile_solve": nt})
    gs_vs = against("stream", res, gs_res)

    # prefetch on against off: the chunks, then a superstep from the same
    # state, timed by part (on, off, on)
    same_chunks = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        sd.iter_chunks(prefetch=True), sd.iter_chunks(prefetch=False)))
    check(same_chunks, "stream: double-buffered chunks differ from serial")
    timing, betas = [], []
    for prefetch in (True, False, True):
        parts, beta = stream_phases(torch, s, lam1, prefetch)
        timing.append(dict(prefetch=prefetch, **parts))
        betas.append(beta)
    check(all(torch.equal(b, betas[0]) for b in betas),
          "stream: a superstep with prefetch off differs from on")
    del betas

    # one superstep traced: the pass spans and the stream's phase split
    tr = trace.enable(tdir)
    conv_path = pathlib.Path(tdir) / f"convergence_{tr.pid}.jsonl"
    with convergence.ConvergenceStream(conv_path) as cs:
        s.set_convergence_stream(cs)
        s.fit(lam1=lam1, max_outer=1, tol=0.0)
        s.set_convergence_stream(None)
    ev = convergence.read_events(conv_path)[-1]
    tspans = span_counts(save_shard(tdir, "stream"))
    parts = ev["phase_us"] or {}
    check(set(parts) == {"stats", "sweep", "line_search"}
          and abs(sum(parts.values()) - ev["step_us"]) <= 1e-6 * ev["step_us"]
          and tspans == {"solver/stream_stats": 1, "solver/stream_sweep": 1,
                         "solver/stream_line_search": 1},
          f"stream traced: event {ev}, spans {tspans}")
    summary = trace_report.summarize(tdir)
    traced_step = {"phase_us": parts, "step_us": ev["step_us"],
                   "spans": tspans,
                   "report_phase_attribution": summary["phase_attribution"],
                   "report_spans": summary["spans"][:8]}
    idle = profiled_superstep(torch, s, lam1)
    kernels = stream_kernel_report(np, torch, s, floors, floor_lib, parity)

    # the host-to-device copy of one chunk from pinned memory, and the
    # bytes a superstep copies (two passes); the chunk Gram's float32 work
    pinned = torch.zeros((STREAM_ROWS, sd.p_pad), pin_memory=True)
    dst = torch.empty((STREAM_ROWS, sd.p_pad), device=dev)
    copy_ms = time_ms(torch, lambda: dst.copy_(pinned, non_blocking=True),
                      20)
    chunk_bytes = STREAM_ROWS * sd.p_pad * 4
    # the host's part of a chunk: its rows written into a pinned buffer
    t0 = time.perf_counter()
    for i in range(8):
        sd._fill(pinned, i)
    fill_ms = (time.perf_counter() - t0) / 8 * 1e3
    del pinned, dst
    bytes_step = 2 * nc * chunk_bytes
    gram_flops = nc * 2.0 * STREAM_ROWS * sd.p_pad ** 2

    # the Jacobi fit against the unfused in-memory one
    lam1_j, j_res = jacobi_ref
    sj = session(DGLMNETConfig(coupling="jacobi"))
    jres, j_counts, j_wall, _ = fit_counted(
        "stream_jacobi", sj, lam1_j, j_res.n_iter,
        {"glm_stats": nc, "alpha_search": nc, "cd_tile_solve": 1})
    j_vs = against("stream_jacobi", jres, j_res)
    del sj

    # chunk-cursor resume: two fits run through, then one cut mid-pass
    # (saves every STREAM_CKPT_CHUNKS chunks) and resumed in a fresh session
    ck_steps = STREAM_CUT_STEP + 1
    through = [session().fit(lam1=lam1, max_outer=ck_steps, tol=0.0)
               for _ in range(2)]
    same_bits = np.array_equal(through[0].beta, through[1].beta) and \
        through[0].history["f"] == through[1].history["f"]
    with tempfile.TemporaryDirectory(prefix="stream-ckpt-") as td:
        mgr = CheckpointManager(td)
        save_ms = []
        orig = mgr.save

        def timed_save(step, tree, **kw):
            t = time.perf_counter()
            orig(step, tree, **kw)
            save_ms.append((time.perf_counter() - t) * 1e3)

        mgr.save = timed_save
        cut = session(source=CutSource(X, STREAM_ROWS, STREAM_CUT_STEP,
                                       STREAM_CUT_CHUNK))
        try:
            cut.fit(lam1=lam1, max_outer=ck_steps, tol=0.0, ckpt_manager=mgr,
                    ckpt_every_chunks=STREAM_CKPT_CHUNKS)
            fail("stream: the cut fit ran through")
        except _Cut:
            pass
        del cut
        md = mgr.read_metadata()
        saved = STREAM_CUT_CHUNK // STREAM_CKPT_CHUNKS * STREAM_CKPT_CHUNKS
        check(md.get("stream_chunk") == saved
              and md.get("next_it") == STREAM_CUT_STEP,
              f"stream: the last save before the cut is {md}")
        ck_dir = pathlib.Path(td) / f"ckpt_{mgr.latest_step()}"
        ck_bytes = sum(f.stat().st_size for f in ck_dir.iterdir())
        p = sd.p_pad
        like = {"beta": torch.zeros(p, device=dev),
                "mu": torch.zeros((), device=dev),
                "G": torch.zeros((p, p), device=dev),
                "g0": torch.zeros(p, device=dev),
                "L": torch.zeros((), device=dev)}
        restore_ms = host_ms(torch, lambda: CheckpointManager(td).restore(
            like), 1)
        del like
        resumed = session().fit(lam1=lam1, max_outer=ck_steps, tol=0.0,
                                ckpt_manager=CheckpointManager(td),
                                ckpt_every_chunks=STREAM_CKPT_CHUNKS)
    want = through[0]
    k = STREAM_CUT_STEP - 1
    gap = float(np.max(np.abs(resumed.beta - want.beta)))
    if same_bits:
        check(np.array_equal(resumed.beta, want.beta)
              and resumed.history["f"] == want.history["f"][k:]
              and resumed.history["alpha"] == want.history["alpha"][k:],
              f"stream resume: not the fit run through (beta gap {gap})")
    else:
        check(gap <= 1e-6 and resumed.history["alpha"]
              == want.history["alpha"][k:],
              f"stream resume: beta gap {gap}")
    del through, resumed

    # a short screened path below the in-memory lambda_max: gradient
    # checks by chunk pass, the KKT test held after each lambda
    sp = session()
    lambdas = lmax * np.geomspace(0.5, LAM1_FRACTION * 2,
                                  STREAM_PATH_LAMBDAS)
    events = path_probe(torch, sp)
    sp.launch_stats.update(dict.fromkeys(sp.launch_stats, 0))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    path = sp.fit_path(lambdas, max_outer=STREAM_PATH_MAX_OUTER,
                       tol=PATH_TOL)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts, st = ops.launch_counts(), dict(sp.launch_stats)
    release(sp)
    n_grad = sum("grad" in ev for ev in events)
    kkt = kkt_rounds(np, events, sp._penf_host, STREAM_TILE)
    bad = {lam: v for lam, v in kkt.items() if v[2]}
    check(np.isfinite(path.f).all() and len(kkt) == len(lambdas)
          and not bad, f"stream path: f {path.f}, KKT violated at {bad}")
    want_p = {"glm_stats": nc * (st["supersteps"] + n_grad),
              "alpha_search": nc * st["supersteps"],
              "cd_tile_solve": st["sweep_tile_launches"]}
    check(counts == {k: want_p.get(k, 0) for k in counts},
          f"stream path: launches {counts} != {want_p}")
    del sp

    emit({"phase": "stream", "card": card,
          "phase_s": time.perf_counter() - t_phase,
          "train_shape": [n, p_src], "chunk_rows": STREAM_ROWS,
          "n_chunks": nc, "last_chunk_rows": last, "p_pad": sd.p_pad,
          "n_tiles": nt, "session_setup_s": setup_s,
          "gauss_seidel": dict(gs_vs, supersteps=steps, fit_s=gs_wall,
                               superstep_s=res.history["step_s"],
                               launches=gs_counts, peak_mem_gb=peak),
          "jacobi": dict(j_vs, supersteps=jres.n_iter, fit_s=j_wall,
                         superstep_s=jres.history["step_s"],
                         launches=j_counts),
          "prefetch_same_bits": True, "superstep_parts": timing,
          "bytes_copied_per_superstep": bytes_step,
          "chunk_copy_ms": copy_ms, "host_fill_ms_per_chunk": fill_ms,
          "host_fill_s_per_superstep": 2 * nc * fill_ms / 1e3,
          "host_threads": torch.get_num_threads(),
          "pinned_copy_gb_per_s": chunk_bytes / copy_ms / 1e6,
          "copy_bound_s_per_superstep": bytes_step / chunk_bytes * copy_ms
          / 1e3,
          "gram_flops_per_superstep": gram_flops,
          "gram_fp32_bound_s": gram_flops / H100_FP32_FLOPS,
          "profiled_superstep": idle,
          "checkpoint": {"two_runs_same_bits": same_bits,
                         "stream_chunk": md["stream_chunk"],
                         "next_it": md["next_it"], "bytes": ck_bytes,
                         "save_ms": save_ms, "restore_ms": restore_ms,
                         "resumed_beta_gap": gap},
          "path": {"lambdas": lambdas.tolist(), "f": path.f.tolist(),
                   "nnz": path.nnz.tolist(),
                   "n_iters": path.n_iters.tolist(), "wall_s": path_s,
                   "n_grad": n_grad, "stats": st, "launches": counts,
                   "kkt_rounds": {str(lam): v[0] for lam, v in kkt.items()}},
          "kernels_at_chunk_shapes": kernels, "traced": traced_step})
    return {"counts": gs_counts, "jacobi_counts": j_counts,
            "kernels": kernels}


def ingest_phase(np, torch, coo, y, dev, card):
    """The file path at the sparse fit's width: the first INGEST_ROWS rows
    of its train split written once as plain libsvm text, then
    ``repro_torch.launch.ingest_train.main`` in process (hashed into 4,096
    columns, chunks of 4,096 rows, 3 supersteps on the card), then its
    ``--smoke``.  Parsing is host Python: this phase measures the host."""
    from repro_torch import io as io_lib
    from repro_torch.core.solver import GLMSolver
    from repro_torch.kernels import ops
    from repro_torch.launch import ingest_train

    t_phase = time.perf_counter()
    n = min(INGEST_ROWS, coo.shape[0])
    coo, y = coo.take_rows(np.arange(n)), y[:n]
    with tempfile.TemporaryDirectory(prefix="ingest-") as td:
        path = pathlib.Path(td) / "train.libsvm"
        t0 = time.perf_counter()
        io_lib.write_libsvm(path, coo, y)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reader = io_lib.LibsvmReader(path, chunk_rows=4096)
        scan_s = time.perf_counter() - t0
        probe = min(8, reader.n_chunks)    # chunks parsed and hashed alone
        t0 = time.perf_counter()
        for i in range(probe):
            reader.chunk(i)
        parse_s = time.perf_counter() - t0
        hasher = io_lib.FeatureHasher(4096, tile_size=256)
        fn = reader.hashed_chunk_fn(hasher)
        t0 = time.perf_counter()
        for i in range(probe):
            fn(i)
        hashed_s = time.perf_counter() - t0
        probe_rows = min(probe * 4096, n)
        rec_path = pathlib.Path(td) / "record.json"
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc = ingest_train.main(["--data", str(path), *INGEST_ARGS,
                                "--json", str(rec_path)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        check(rc == 0, f"ingest: ingest_train exited {rc}")
        rec = json.loads(rec_path.read_text())
        f = np.asarray(rec["f_history"])
        check(np.isfinite(f).all() and bool(np.all(np.diff(f) <= 1e-6
                                                   * np.abs(f[:-1]))),
              f"ingest: f {f.tolist()}")
        nc = rec["chunks"]
        tiles = -(-(rec["design_cols"] + 1) // 256)     # the intercept too
        want = {"glm_stats": nc * rec["n_iter"],
                "alpha_search": nc * rec["n_iter"],
                "cd_tile_solve": rec["n_iter"] * tiles}
        check(counts == {k: want.get(k, 0) for k in counts},
              f"ingest: launches {counts} != {want}")
        # one superstep of the same design, profiled
        design, labels, _ = io_lib.open_design(
            str(path), tile_size=256, chunk_rows=4096, hasher=hasher,
            prefetch_chunks=2, device=dev)
        s = GLMSolver(design, labels, family="logistic", fit_intercept=True,
                      device=dev)
        idle = profiled_superstep(torch, s, 0.01)
        del s, design
        smoke_path = pathlib.Path(td) / "smoke.json"
        rc = ingest_train.main(["--smoke", "--json", str(smoke_path)])
        smoke = json.loads(smoke_path.read_text())
        check(rc == 0 and smoke["beta_max_err"] <= 1e-5
              and smoke["device"].startswith("cuda"),
              f"ingest --smoke: rc {rc}, record {smoke}")
        file_bytes = path.stat().st_size
    emit({"phase": "ingest", "card": card,
          "phase_s": time.perf_counter() - t_phase, "rows": n,
          "features": coo.shape[1], "nnz": int(coo.nnz),
          "file_bytes": file_bytes, "write_s": write_s,
          "write_rows_per_s": n / write_s, "scan_s": scan_s,
          "scan_rows_per_s": n / scan_s,
          "parse_rows_per_s": probe_rows / parse_s,
          "parse_and_hash_rows_per_s": probe_rows / hashed_s,
          "cli_s": cli_s, "record": rec, "launches": counts,
          "profiled_superstep": idle, "smoke": smoke})
    return counts


# ---------------------------------------------------------------------------
# dist: the mesh on torch.distributed (this script is also the worker)
# ---------------------------------------------------------------------------

def small_problem(np, kind: str, n: int = 600, p: int = 300):
    """A small logistic problem whose rows and features pad on a (2, 2)
    mesh; ``kind="block"`` is sparse (a SparseCOO is built from it)."""
    rng = np.random.default_rng(SEED + 3)
    X = rng.normal(size=(n, p)).astype(np.float32)
    if kind == "block":
        X = np.where(rng.random((n, p)) < 0.1, X, 0.0).astype(np.float32)
    beta = np.zeros((p,), np.float32)
    beta[: p // 6] = rng.normal(size=p // 6).astype(np.float32)
    y = np.where(X @ beta + 0.5 * rng.normal(size=n) > 0, 1.0,
                 -1.0).astype(np.float32)
    return X, y


def dist_task(np, torch, task: dict, mesh, dev) -> dict:
    """One task of a dist worker on its mesh; returns its JSON record."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.core.solver import GLMSolver
    from repro_torch.data import sparse, synthetic
    from repro_torch.kernels import ops
    from repro_torch.sharding import collectives

    def sync():
        if torch.cuda.is_available():     # the CPU worlds of (c) too
            torch.cuda.synchronize()

    kind = task["kind"]
    if kind == "full":
        t0 = time.perf_counter()
        ds = full_size_data(synthetic, "sparse") if "size" not in task \
            else synthetic.make_sparse(**task["size"])
        solver = full_size_solver(GLMSolver, ds, dev, mesh=mesh)
        sync()
        setup_s = time.perf_counter() - t0
        out = {"setup_s": setup_s, "n_tiles_local": solver.design.n_tiles,
               "local_shape": list(solver.design.shape)}
        for name, steps, tol in task["fits"]:
            ops.reset_launch_counts()
            collectives.reset_stats()
            t0 = time.perf_counter()
            res = solver.fit(lam1=task["lam1"], max_outer=steps, tol=tol)
            sync()
            fit_s = time.perf_counter() - t0
            st = collectives.stats()
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            out[name] = {
                "n_iter": res.n_iter, "converged": res.converged,
                "f": res.history["f"], "alpha": res.history["alpha"],
                "nnz": res.history["nnz"], "step_s": res.history["step_s"],
                "fit_s": fit_s, "collective_s": st["seconds"],
                "collective_calls": st["calls"],
                "collective_mb": st["bytes"] / 1e6, "launches": counts,
                "budget_tiles": solver.design.n_tiles * res.n_iter}
            if task.get("beta"):
                np.save(pathlib.Path(task["out"]) / f"{name}_beta.npy",
                        res.beta)
        if task.get("collectives"):
            # the analysis phase's collective sequence: two sharded
            # unfused Jacobi supersteps of this session
            from repro_torch.analysis import audit
            t0 = time.perf_counter()
            r = audit.audit_collective_sequence(solver=solver)
            out["collectives"] = {"status": r.status, **r.details,
                                  "s": time.perf_counter() - t0}
        return out
    if kind == "small":
        out = {}
        for design in ("dense", "block"):
            X, y = small_problem(np, design)
            Xin = X
            if design == "block":
                r, c = np.nonzero(X)
                Xin = sparse.SparseCOO(r.astype(np.int32), c.astype(np.int32),
                                       X[r, c], X.shape)
            for coup in ("gauss-seidel", "jacobi"):
                s = GLMSolver(Xin, y, config=DGLMNETConfig(
                    tile_size=64, coupling=coup), mesh=mesh, row_block=64,
                    device=dev)
                res = s.fit(lam1=0.01, max_outer=DIST_SMALL_STEPS, tol=0.0)
                out[f"{design}/{coup}"] = {
                    "alpha": res.history["alpha"], "n_iter": res.n_iter,
                    "f": res.history["f"],
                    "beta": s._host_beta(s._state.beta).tolist()}
        return out
    if kind == "ckpt":
        # a dense fit: uninterrupted, cut at 4 supersteps (saves at 2 and
        # 4), or resumed from the cut; an elastic source saved after 12
        # supersteps and its uninterrupted run to convergence
        X, y = small_problem(np, "dense")
        cfg = DGLMNETConfig(tile_size=64, max_outer=12, tol=0.0)
        d = pathlib.Path(task["dir"])
        out = {}
        for name in task["fits"]:
            s = GLMSolver(X, y, config=cfg, mesh=mesh, device=dev)
            if name == "full":
                res = s.fit(lam1=0.01)
            elif name == "cut":
                res = s.fit(lam1=0.01, max_outer=4, ckpt_every=2,
                            ckpt_manager=CheckpointManager(d / "cut"))
            else:
                res = s.fit(lam1=0.01, ckpt_every=2,
                            ckpt_manager=CheckpointManager(d / "cut"))
            out[name] = {"n_iter": res.n_iter, "n_hist": len(
                res.history["f"]), "beta": s._host_beta(
                s._state.beta).tolist()}
        ds = synthetic.make_dense(n=4000, p=256, seed=11)
        ecfg = DGLMNETConfig(lam1=0.5, lam2=0.5, tile_size=64,
                             max_outer=12, tol=1e-13)
        if "elastic_src" in task:
            s = GLMSolver(ds.train.X, ds.train.y, config=ecfg, mesh=mesh,
                          device=dev)
            s.fit(ckpt_every=4, ckpt_manager=CheckpointManager(
                d / "elastic", keep_last=2))
            s = GLMSolver(ds.train.X, ds.train.y, config=ecfg, mesh=mesh,
                          device=dev)
            res = s.fit(max_outer=200)
            out["elastic_ref"] = {"f": res.history["f"][-1],
                                  "n_iter": res.n_iter}
        if "elastic" in task:
            from repro_torch.dist import bootstrap
            mesh21 = bootstrap.make_dist_mesh(2, 1)
            s = GLMSolver(ds.train.X, ds.train.y, config=ecfg, mesh=mesh21,
                          device=dev)
            res = s.fit(max_outer=200, ckpt_every=500,
                        ckpt_manager=CheckpointManager(d / "elastic",
                                                       keep_last=2))
            out["elastic"] = {"f": res.history["f"][-1],
                              "n_hist": len(res.history["f"]),
                              "n_iter": res.n_iter}
        return out
    raise ValueError(f"unknown dist task {kind!r}")


def dist_worker(spec_path: str) -> None:
    """One rank of a dist-phase world: the spec's tasks on its mesh, its
    record in ``<out>/rank<r>.json``."""
    sys.path.insert(0, str(REPO / "src"))
    import numpy as np
    import torch

    from repro_torch.dist import bootstrap, faults
    spec = json.loads(pathlib.Path(spec_path).read_text())
    ctx = bootstrap.initialize(backend=spec["backend"],
                               device=spec["device"], timeout_s=120)
    ready = time.time()     # lint: allow SYNC001 — read by another process
    mesh = bootstrap.make_dist_mesh(*spec["mesh"])
    dev = None if spec["device"] is None else spec["device"]
    rec = {"ready_at": ready, "backend": ctx.backend, "device": ctx.device}
    if ctx.device == "cpu":
        torch.set_num_threads(2)
    for task in spec["tasks"]:
        rec[task["name"]] = dist_task(np, torch, task, mesh, dev)
    out = pathlib.Path(spec["out"])
    (out / f"rank{ctx.process_id}.json").write_text(json.dumps(rec))
    faults.guarded_barrier("chip-smoke-dist-exit", timeout_s=120)
    bootstrap.shutdown()


def dist_world(tdir: pathlib.Path, tag: str, n: int, mesh, tasks,
               backend="gloo", device=None):
    """Run one world of the dist phase; (every rank's record, seconds from
    launch to the last rank's process group, the world's wall seconds)."""
    from repro_torch.dist import launcher
    out = tdir / tag
    out.mkdir(parents=True, exist_ok=True)
    spec = out / "spec.json"
    spec.write_text(json.dumps({"backend": backend, "device": device,
                                "mesh": list(mesh), "tasks": tasks,
                                "out": str(out)}))
    t0 = time.time()        # lint: allow SYNC001 — against ranks' ready_at
    res = launcher.run_local(n, REPO / "chip_smoke.py",
                             args=["--dist-worker", str(spec)],
                             timeout_s=DIST_TIMEOUT_S, grace_s=10)
    check(res.ok, f"dist world {tag} failed:\n{res.summary(3000)}")
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(n)]
    return ranks, max(r["ready_at"] for r in ranks) - t0, res.seconds


def dist_run_cli(tdir: pathlib.Path, tag: str, n: int, args) -> dict:
    """``python -m repro_torch.launch.dist_run`` as a user runs it; the
    coordinator's record."""
    out = tdir / f"{tag}.json"
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dist_run", "--nprocs",
         str(n), "--timeout", str(DIST_TIMEOUT_S), "--out", str(out),
         *map(str, args)], capture_output=True, text=True,
        timeout=DIST_TIMEOUT_S + 60, cwd=str(REPO),
        env={**__import__("os").environ,
             "PYTHONPATH": str(REPO / "src")})
    check(r.returncode == 0 and out.exists(),
          f"dist_run {tag} failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    row = json.loads(out.read_text())
    row["cli_s"] = time.perf_counter() - t0
    return row


def same_ranks(np, ranks, task, keys=("f", "alpha", "nnz", "n_iter")):
    """Every rank reports the same values of each fit of ``task``."""
    for name, fit in ranks[0][task].items():
        if not isinstance(fit, dict):
            continue
        for r in ranks[1:]:
            for k in keys:
                if k in fit:
                    check(r[task][name][k] == fit[k],
                          f"ranks disagree on {task}/{name}/{k}")


# ------------------------------------------------------------- analysis


def analysis_launches(solver, lmax) -> dict:
    """The analysis phase's launch audit on a full-size session's design:
    fused and unfused Jacobi supersteps built on it (2 and 5 logical
    units; on a dense design 2 and 4 kernel launches), each held to the
    profiler's records of one superstep (``audit.record_check``)."""
    from repro_torch.analysis import audit
    t0 = time.perf_counter()
    res = audit.audit_superstep_launches(prob=audit.solver_problem(
        solver, lams=(LAM1_FRACTION * lmax, 0.0)))
    out = {r.name: {"status": r.status, **{
        k: r.details.get(k) for k in ("units", "kernel_launches",
                                      "kernel_target", "records_off",
                                      "device_records")}} for r in res}
    out["s"] = time.perf_counter() - t0
    return out


def analysis_steady_state(solver, lmax) -> dict:
    """A warm 3-lambda path of a full-size session (the reference's audit,
    at 0.5, 0.25 and 0.1 of lambda_max): 0 builds of its superstep, 0 nvcc
    builds, 0 library loads."""
    from repro_torch.analysis import audit
    t0 = time.perf_counter()
    res = audit.steady_state(solver, [f * lmax for f in (0.5, 0.25, 0.1)],
                             lam2=0.0)
    return {"status": res.status, **res.details,
            "s": time.perf_counter() - t0}


def analysis_kernel_smem(dev) -> dict:
    """Every kernel of the twelve sources within the card's shared-memory
    and register limits, each source launched at least once (this run's
    largest requests), registers and static shared memory as ptxas
    reported them; the kernels that spill, named."""
    from repro_torch.analysis import audit
    t0 = time.perf_counter()
    res = audit.kernel_smem_audit(dev, all_sources=True)
    out = {"status": res.status,
           **{k: v for k, v in res.details.items() if not k.startswith("_")},
           "spills": res.details.get("_spills")}
    out["s"] = time.perf_counter() - t0
    return out


def analysis_lint() -> dict:
    """``python -m repro_torch.analysis --check`` of this checkout: 0 new
    findings and 0 stale baseline entries."""
    from repro_torch.analysis import lint
    t0 = time.perf_counter()
    violations, n_files = lint.lint_paths(
        [lint.REPO_ROOT / t for t in lint.DEFAULT_TARGETS])
    new, old, stale = lint.reconcile(
        violations, lint.load_baseline(lint.DEFAULT_BASELINE))
    return {"status": "ok" if not new and not stale else "fail",
            "files": n_files, "findings": len(violations),
            "baselined": len(old), "new": [v.render() for v in new],
            "stale": stale, "s": time.perf_counter() - t0}


def analysis_phase(analysis: dict, card) -> None:
    """The analysis phase's line, from the parts run beside the sparse,
    dense, baselines and dist phases; any part not ``ok`` (a ``skip`` too)
    fails it."""
    analysis["lint"] = analysis_lint()
    parts = {k: v for k, v in analysis.items() if isinstance(v, dict)}
    statuses = {}
    for k, v in parts.items():
        if "status" in v:
            statuses[k] = v["status"]
        else:
            statuses.update({f"{k}/{n}": r["status"] for n, r in v.items()
                             if isinstance(r, dict)})
    emit({"phase": "analysis", "card": card, **analysis,
          "statuses": statuses,
          "phase_s": sum(v["s"] for v in parts.values())})
    check(set(statuses.values()) == {"ok"} and len(statuses) == 8,
          f"analysis: {statuses}")


def dist_phase(np, torch, sparse_res, lam1, dense_npy, lam1_dense, card,
               size=None, analysis=None):
    """The dist phase (module docstring): worlds (a)-(f); returns the
    per-rank K1-K4 launches of the sharded fits.  ``size`` (the
    make_sparse arguments) replaces the full-size sparse data in a
    rehearsal on the CPU.  ``analysis`` (the analysis phase's parts) gets
    the collective sequence of the (1, 2) gloo world's sparse session,
    the same on both ranks."""
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-dist-")
    tdir = pathlib.Path(tmp.name)
    steps5 = sparse_res.n_iter

    def full(name, fits, beta=False):
        return {"name": name, "kind": "full", "lam1": lam1, "fits": fits,
                "beta": beta, "out": str(tdir),
                **({"size": size} if size else {})}

    # (a) NCCL, a world of one: the single-device fit's supersteps, then
    # to tol
    ra, start_a, wall_a = dist_world(
        tdir, "a_nccl_1x1", 1, (1, 1),
        [full("full", [["parity", steps5, 0.0], ["to_tol", 200, 1e-8]],
              beta=True)], backend=None)
    pa = ra[0]["full"]["parity"]
    beta_a = np.load(tdir / "parity_beta.npy")
    d_beta = float(np.max(np.abs(beta_a - sparse_res.beta)))
    check(pa["alpha"] == sparse_res.history["alpha"]
          and pa["n_iter"] == sparse_res.n_iter and d_beta <= 1e-6,
          f"(a) NCCL (1, 1) vs single device: alphas {pa['alpha']} vs "
          f"{sparse_res.history['alpha']}, beta {d_beta}")
    tol_a = ra[0]["full"]["to_tol"]
    check(tol_a["converged"], "(a) the (1, 1) fit did not reach tol")
    f_single = tol_a["f"][-1]
    nt_a = ra[0]["full"]["n_tiles_local"]

    def launches_hold(tag, rk, fit):
        c = rk["full"][fit]["launches"]
        it = rk["full"][fit]["n_iter"]
        tiles = rk["full"][fit]["budget_tiles"]
        want = {"glm_stats": it, "tile_gram": tiles, "cd_tile_solve": tiles,
                "alpha_search": 2 * it}
        check(c == want, f"{tag}: launches {c} != {want}")
        return c

    launches_hold("(a)", ra[0], "parity")
    report = {"phase": "dist", "card": card,
              "a_nccl_1x1": {
                  "alpha_equal": True, "n_iter": pa["n_iter"],
                  "beta_max_abs_diff": d_beta,
                  "beta_bits_equal": bool(np.array_equal(beta_a,
                                                          sparse_res.beta)),
                  "to_tol_n_iter": tol_a["n_iter"], "f_to_tol": f_single,
                  "superstep_s_median": float(np.median(
                      tol_a["step_s"][1:])),
                  "collective_share": tol_a["collective_s"]
                  / tol_a["fit_s"], "startup_s": start_a,
                  "world_s": wall_a, "setup_s": ra[0]["full"]["setup_s"]}}

    # (b) gloo worlds of 2 and 4 on the one card (+ (c)'s card side, and
    # (e)'s sources in the world of 2)
    per_rank = {}
    worlds = {}
    backends = [("gloo", "gloo")]
    if torch.cuda.device_count() >= 2:
        backends.append(("nccl", None))
    for bname, backend in backends:
        for n, mesh in ((2, (1, 2)), (4, (2, 2))):
            if bname == "nccl" and n > torch.cuda.device_count():
                continue
            tag = f"b_{bname}_{mesh[0]}x{mesh[1]}"
            tasks = [full("full", [["to_tol", 200, 1e-8]])]
            collective_world = analysis is not None and tag == "b_gloo_1x2"
            if collective_world:
                tasks[0]["collectives"] = True
            if bname == "gloo":
                tasks.append({"name": "small", "kind": "small"})
                if n == 2:
                    tasks.append({"name": "ckpt", "kind": "ckpt",
                                  "dir": str(tdir / "ckpt"),
                                  "fits": ["full", "cut"],
                                  "elastic_src": True})
            ranks, start, wall = dist_world(tdir, tag, n, mesh, tasks,
                                            backend=backend)
            same_ranks(np, ranks, "full")
            fit = ranks[0]["full"]["to_tol"]
            check(fit["converged"], f"{tag}: did not reach tol")
            f = fit["f"][-1]
            check(f <= f_single + 2e-3 * abs(f_single),
                  f"{tag}: f {f} vs the (1, 1) fit's {f_single}")
            counts = [launches_hold(f"{tag} rank {r}", rk, "to_tol")
                      for r, rk in enumerate(ranks)]
            per_rank[f"{mesh[0]}x{mesh[1]}_{bname}"] = counts
            worlds[tag] = ranks
            if collective_world:
                cs = [rk["full"]["collectives"] for rk in ranks]
                same = all(c["_records"] == cs[0]["_records"] for c in cs)
                analysis["collective_sequence"] = {
                    "status": "ok" if same and all(
                        c["status"] == "ok" and c["ranks"] == n
                        for c in cs) else "fail",
                    "world": tag, "records_equal_on_ranks": same,
                    **{k: cs[0][k] for k in ("signature", "n_collectives",
                                             "deterministic", "ranks",
                                             "same_on_every_rank")},
                    "records": cs[0]["_records"],
                    "s": max(c["s"] for c in cs)}
            report[tag] = {
                "n_iter": fit["n_iter"], "f": f,
                "f_rel_to_1x1": (f - f_single) / abs(f_single),
                "superstep_s_median": float(np.median(fit["step_s"][1:])),
                "superstep_s": fit["step_s"], "fit_s": fit["fit_s"],
                "collective_s": [rk["full"]["to_tol"]["collective_s"]
                                 for rk in ranks],
                "collective_share": [rk["full"]["to_tol"]["collective_s"]
                                     / rk["full"]["to_tol"]["fit_s"]
                                     for rk in ranks],
                "collective_calls": fit["collective_calls"],
                "collective_mb": fit["collective_mb"],
                "launches_per_rank": counts,
                "n_tiles_local": ranks[0]["full"]["n_tiles_local"],
                "local_shape": ranks[0]["full"]["local_shape"],
                "setup_s": max(rk["full"]["setup_s"] for rk in ranks),
                "startup_s": start, "world_s": wall,
                "backend": ranks[0]["backend"],
                "gloo_on_one_card": bname == "gloo"}
    if len(backends) == 1:
        report["nccl_across_cards"] = (
            f"not run: {torch.cuda.device_count()} card(s), NCCL needs a "
            "card per rank")

    # (c) the small fits on the card against the same worlds on the CPU
    small = {}
    for n, mesh in ((2, (1, 2)), (4, (2, 2))):
        cpu, _, _ = dist_world(tdir, f"c_cpu_{mesh[0]}x{mesh[1]}", n, mesh,
                               [{"name": "small", "kind": "small"}],
                               device="cpu")
        gpu = worlds[f"b_gloo_{mesh[0]}x{mesh[1]}"]
        same_ranks(np, gpu, "small")
        same_ranks(np, cpu, "small")
        for key, ref in cpu[0]["small"].items():
            got = gpu[0]["small"][key]
            db = float(np.max(np.abs(np.asarray(got["beta"])
                                     - np.asarray(ref["beta"]))))
            check(got["alpha"] == ref["alpha"] and got["n_iter"]
                  == ref["n_iter"] and db <= 1e-5,
                  f"(c) {mesh} {key}: card vs CPU alphas {got['alpha']} "
                  f"{ref['alpha']}, beta {db}")
            small[f"{mesh[0]}x{mesh[1]}/{key}"] = db
    report["c_card_vs_cpu_beta_max_abs"] = small

    # (d) ALB under a fault plan, through dist_run
    d = dist_run_cli(tdir, "d_alb", 2, [
        "--demo", "--backend", "gloo", "--faults", "1:4.0", "--telemetry",
        "--tile-cost-s", "0.002", "--steps", "8"])
    hist = d["budget_history"]
    check(d["budgets_agree"] and hist[0] == hist[1] and hist[0][0]
          == hist[0][1] and hist[-1][1] < hist[-1][0],
          f"(d) budgets {hist} (agree {d['budgets_agree']})")
    report["d_alb"] = {k: d[k] for k in ("budget_history", "budgets_agree",
                                         "speeds", "f", "n_iter", "fit_s",
                                         "collective_s", "cli_s")}

    # (e) restart and elastic resume in a fresh world of 2
    re_, _, _ = dist_world(tdir, "e_restart", 2, (1, 2), [
        {"name": "ckpt", "kind": "ckpt", "dir": str(tdir / "ckpt"),
         "fits": ["resume"], "elastic": True}])
    src = worlds["b_gloo_1x2"][0]["ckpt"]
    got = re_[0]["ckpt"]
    bits = got["resume"]["beta"] == src["full"]["beta"]
    db = float(np.max(np.abs(np.asarray(got["resume"]["beta"])
                             - np.asarray(src["full"]["beta"]))))
    check(got["resume"]["n_hist"] == 8 and got["resume"]["n_iter"]
          == src["full"]["n_iter"] and db <= 1e-6,
          f"(e) restart: beta {db}, {got['resume']}")
    f_ref = src["elastic_ref"]["f"]
    check(got["elastic"]["f"] <= f_ref + 2e-3 * abs(f_ref),
          f"(e) elastic {got['elastic']} vs {f_ref}")
    report["e_checkpoint"] = {"restart_bits_equal": bool(bits),
                              "restart_beta_max_abs": db,
                              "elastic_f": got["elastic"]["f"],
                              "elastic_supersteps": got["elastic"]["n_hist"],
                              "uninterrupted_f": f_ref}

    # (f) the dense split streamed by 2 processes against 1
    X_path, y_path = dense_npy
    common = ["--data", X_path, "--labels", y_path, "--chunk-rows", "8192",
              "--tile", "256", "--steps", "2", "--lam1", str(lam1_dense),
              "--tol", "0"]
    one = dist_run_cli(tdir, "f_stream_1", 1, common)
    two = dist_run_cli(tdir, "f_stream_2", 2, [*common, "--backend",
                                                "gloo"])
    df = max(abs(a - b) / abs(b) for a, b in zip(two["f"], one["f"]))
    dbeta = float(np.max(np.abs(np.asarray(two["beta"])
                                - np.asarray(one["beta"]))))
    check(df <= 1e-6 and dbeta <= 1e-6 and two["supersteps"] == 2,
          f"(f) streamed 2 vs 1: f {df}, beta {dbeta}")
    report["f_stream"] = {"f_rel": df, "beta_max_abs": dbeta,
                          "chunks_local": [two["chunks_local"],
                                           one["chunks_local"]],
                          "superstep_s": [two["wall_s"] / 2,
                                          one["wall_s"] / 2],
                          "cli_s": [two["cli_s"], one["cli_s"]],
                          "collective_s": two["collective_s"]}
    report["phase_s"] = time.perf_counter() - t_phase
    emit(report)
    tmp.cleanup()
    return per_rank


def plain_call(torch, fn):
    """(device ms of one call of ``fn``, its result): a plain version is
    run once, for its result and its time."""
    out = []
    return time_ms(torch, lambda: out.append(fn()), 1, 0, False), out[0]


def scan_kernels_report(np, torch, X, y, dev, report, parity, tol):
    """The two scans on the card at full width, each against its plain
    version: one ADMM x-update (the inputs of the third outer iteration at
    rho = 1) and one online epoch (from w = 0, the first of the L1 run's).
    Each is timed beside its bytes bound (every input read once; for ADMM
    also the passes' reads of A, which no cache holds) and its dependency
    floor: the same kernel on the same chain of steps with one row
    (ADMM) or one feature (online) a thread, where the bytes are
    negligible."""
    from repro_torch.baselines import admm as admm_lib
    from repro_torch.baselines.admm import ADMMConfig
    from repro_torch.kernels import admm_shooting as admm_k
    from repro_torch.kernels import online_tg as tg_k
    from repro_torch.kernels import ref

    n, p = X.shape
    # ---- ADMM x-update
    cfg = ADMMConfig(lam1=BASELINE_LAM1, rho=1.0)
    At = admm_lib.column_blocks(X, cfg.n_blocks)
    M, pb, _ = At.shape
    col_sq = torch.sum(At * At, dim=2)
    x = torch.zeros((M, pb), dtype=torch.float32, device=dev)
    zbar = torch.zeros(n, dtype=torch.float32, device=dev)
    u = torch.zeros_like(zbar)
    for _ in range(2):
        x, zbar, u, _, _ = admm_lib._admm_step(At, y, x, zbar, u, cfg,
                                               col_sq)
    Ax = admm_lib._block_margins(At, x)
    v = Ax + (zbar - torch.mean(Ax, dim=0) - u)[None, :]
    args = (At, x, v, col_sq, cfg.lam1 / cfg.rho, cfg.lam2 / cfg.rho,
            cfg.shooting_passes)
    got = admm_k.launch(*args)
    plain_ms, want = plain_call(torch, lambda: ref.shooting_pass(*args))
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    parity["admm_shooting"] = err / scale
    check(err <= tol["admm_shooting"] * scale,
          f"admm_shooting: error {err} (largest x {scale})")
    check(torch.equal(got, admm_k.launch(*args)),
          "admm_shooting: x differs from run to run")
    # the same x-update with the L2 term on (lam2 / rho = 1)
    args_l2 = args[:5] + (1.0,) + args[6:]
    want_l2 = ref.shooting_pass(*args_l2)
    err_l2 = float((admm_k.launch(*args_l2) - want_l2).abs().max())
    scale_l2 = max(1.0, float(want_l2.abs().max()))
    check(err_l2 <= tol["admm_shooting"] * scale_l2,
          f"admm_shooting (lam2 1): error {err_l2} (largest x {scale_l2})")
    # what a wrong kernel reads: one Shooting pass short
    short = float((admm_k.launch(*args[:6], args[6] - 1) - want).abs().max())
    check(short > tol["admm_shooting"] * scale,
          f"admm_shooting: a pass short reads {short}, inside the bar")
    nz = want[want != 0].abs()
    ms = time_ms(torch, lambda: admm_k.launch(*args), 10)
    cluster, r_in_smem = admm_k.plan(n)
    rows = cluster * 1024          # one row a thread, the same cluster
    At_s = At[:, :, :rows].contiguous()
    small = (At_s, x, v[:, :rows].contiguous(),
             torch.sum(At_s * At_s, dim=2)) + args[4:]
    check(admm_k.plan(rows)[0] == cluster, "admm_shooting: floor plan")
    floor = time_ms(torch, lambda: admm_k.launch(*small), 10)
    passes = cfg.shooting_passes
    a_bytes = At.numel() * 4
    bytes_once = a_bytes + v.numel() * 4 + 3 * col_sq.numel() * 4
    # r = A x - v (an FMA), the dot (an FMA), r += a delta (2): a pass
    flops = 6.0 * passes * At.numel()
    b_ms, b_by = bound_ms(bytes_once, flops)
    steps = passes * pb
    report["admm_shooting"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        share_of_bound=b_ms / ms, library_ms=None, max_abs_err=err,
        max_abs_err_lam2=err_l2, err_one_pass_short=short,
        x_abs={"max": float(want.abs().max()),
               "median_nonzero": float(nz.median()) if nz.numel() else 0.0,
               "nonzero": int(nz.numel()), "size": want.numel()},
        bytes_bound_passes_ms=passes * a_bytes / H100_BYTES_PER_S * 1e3,
        share_of_bytes_bound_passes=passes * a_bytes / H100_BYTES_PER_S
        * 1e3 / ms,
        dependency_floor_ms=floor, share_of_dependency_floor=floor / ms,
        dependency_steps=steps, step_us=ms * 1e3 / steps,
        floor_step_us=floor * 1e3 / steps, cluster=cluster,
        r_in_shared_memory=r_in_smem,
        shapes={"M": M, "p_block": pb, "n": n, "passes": passes})
    del At, At_s, small, args, args_l2, col_sq, x, v, Ax, zbar, u, got, \
        want, want_l2, nz

    # ---- online epoch
    M = 4
    n_per = n // M
    perm = torch.from_numpy(np.random.default_rng(0).permutation(n)
                            [: n_per * M]).to(dev)
    X_sh = X[perm].reshape(M, n_per, p)
    y_sh = y[perm].reshape(M, n_per)
    del perm
    w0 = torch.zeros(p, dtype=torch.float32, device=dev)
    kw = dict(lr=0.3, power=0.6, lam1=BASELINE_LAM1 / n, lam2=0.0)
    got = tg_k.launch(X_sh, y_sh, w0, 1.0, "logistic", **kw)
    plain_ms, want = plain_call(torch, lambda: ref.online_tg_epoch(
        X_sh, y_sh, w0, 1.0, "logistic", **kw))
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    parity["online_tg"] = err / scale
    check(err <= tol["online_tg"] * scale,
          f"online_tg: error {err} (largest w {scale})")
    check(torch.equal(got, tg_k.launch(X_sh, y_sh, w0, 1.0, "logistic",
                                       **kw)),
          "online_tg: w differs from run to run")
    ms = time_ms(torch, lambda: tg_k.launch(X_sh, y_sh, w0, 1.0, "logistic",
                                            **kw), 3, 1)
    narrow = X_sh[:, :, :256].contiguous()       # one feature a thread
    floor = time_ms(torch, lambda: tg_k.launch(narrow, y_sh, w0[:256], 1.0,
                                               "logistic", **kw), 3, 1)
    bytes_once = (X_sh.numel() + y_sh.numel() + p + M * p) * 4
    # the dot (an FMA), w + (eta s) x (2), the shrink, the threshold (2)
    flops = 6.0 * X_sh.numel()
    b_ms, b_by = bound_ms(bytes_once, flops)
    report["online_tg"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        share_of_bound=b_ms / ms, library_ms=None, max_abs_err=err,
        w_abs={"max": float(want.abs().max()),
               "median": float(want.abs().median())},
        dependency_floor_ms=floor, share_of_dependency_floor=floor / ms,
        dependency_steps=n_per, step_us=ms * 1e3 / n_per,
        floor_step_us=floor * 1e3 / n_per,
        w_in_shared_memory=p <= tg_k.smem_features(),
        shapes={"M": M, "n_per": n_per, "p": p})
    del X_sh, y_sh, narrow, got, want


def counted_fit(torch, ops, fn):
    """(result, wall s, the launch counts) of ``fn()`` with every count set
    to 0 just before it."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, ops.launch_counts()


def method_row(np, f, nnz, wall_s, iters, counts, f_star):
    """What the phase prints of one method: f by iteration, suboptimality
    at 10 (the reference's index 9) and at the end, nnz, seconds, and the
    launches an iteration."""
    f = [float(v) for v in f]
    so = [(v - f_star) / abs(f_star) for v in f]
    check(bool(np.isfinite(f).all()), f"non-finite f {f}")
    return {"f": f, "subopt_at_10": so[min(9, len(so) - 1)],
            "subopt": so[-1], "nnz": int(nnz), "iters": iters,
            "wall_s": wall_s, "s_per_iter": wall_s / max(iters, 1),
            "launches_per_iter": {k: v / max(iters, 1)
                                  for k, v in counts.items() if v}}


def dglmnet_rows(np, torch, ops, objective, f_star, lam1, lam2, solver):
    """d-GLMNET in the figures' protocol (the solver's config: 30 or 25
    supersteps, tol 0), then the same solver run on to
    BASELINE_GATE_SUPERSTEPS and held to FISTA's f* by the bar of
    tests/test_dglmnet.py (a converged fit): f <= f* + 1e-3 max(1,
    |f*|)."""
    res, wall, counts = counted_fit(torch, ops, lambda: solver.fit(lam1,
                                                                   lam2))
    row = method_row(np, res.history["f"], res.history["nnz"][-1], wall,
                     res.n_iter, counts, f_star)
    row["f_objective"] = objective(res.beta, lam1, lam2)
    long, wall, counts = counted_fit(torch, ops, lambda: solver.fit(
        lam1, lam2, max_outer=BASELINE_GATE_SUPERSTEPS))
    f_long = [float(v) for v in long.history["f"]]
    f_d = objective(long.beta, lam1, lam2)
    k = len(res.history["f"])
    row["run_on"] = {
        "supersteps": long.n_iter, "f_objective": f_d,
        "subopt": (f_d - f_star) / abs(f_star), "wall_s": wall,
        "s_per_superstep": wall / long.n_iter,
        "f_at": {str(i): f_long[i - 1] for i in (50, 100, 200, 400, 600)
                 if i <= len(f_long)},
        "prefix_max_rel_diff": float(np.max(np.abs(
            np.array(f_long[:k]) / np.array(res.history["f"]) - 1))),
        "launches_per_superstep": {kk: v / long.n_iter
                                   for kk, v in counts.items() if v}}
    check(bool(np.isfinite(f_long).all()), "d-GLMNET: non-finite f")
    check(f_d <= f_star + 1e-3 * max(1.0, abs(f_star)),
          f"d-GLMNET ({lam1}, {lam2}) after {long.n_iter} supersteps: f "
          f"{f_d} above FISTA's f* {f_star}")
    return row


def baselines_phase(np, torch, dd, dev, report, parity, card):
    """The paper's comparison on the card at the epsilon shape (the dense
    train split, 400,000 x 2,000, logistic, no intercept column): L1 as
    benchmarks/fig2_4_l1.py (lam1 = 1: FISTA's f*, d-GLMNET fused Jacobi
    30 supersteps, ADMM with rho tuned over 4^k at 10 iterations then 30,
    online truncated gradient 30 epochs) and L2 as fig5_6_l2.py (lam2 =
    1: f*, d-GLMNET with a fixed mu 25 supersteps, online-warmstarted and
    plain L-BFGS 25 iterations).  Gates: each scan kernel against its
    plain version, small fits card against CPU, d-GLMNET run on to 800
    supersteps within 1e-3 max(1, |f*|) of f* at L1 and L2 (this split is
    nearly separable: 30 supersteps leave f 60% above f*, and the
    reference's fit does the same on a 40,000-row cut, which
    tests/test_torch_protocol_witness.py runs and this phase runs on the
    card), both L-BFGS runs within 1e-3 |f*| at L2, every f finite.
    ADMM's and online TG's suboptimality are reported, not gated.
    Returns the launch counts of the ADMM and online TG fits of the L1
    run."""
    from repro_torch.baselines import (fit_admm, fit_lbfgs, fit_online_tg,
                                       fit_online_warmstart_lbfgs)
    from repro_torch.baselines.admm import ADMMConfig
    from repro_torch.baselines.lbfgs import LBFGSConfig
    from repro_torch.baselines.online_tg import OnlineTGConfig
    from repro_torch.core import glm as glm_lib
    from repro_torch.core import prox_ref
    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.core.solver import GLMSolver
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    Xh = np.ascontiguousarray(dd.train.X, np.float32)
    yh = np.asarray(dd.train.y, np.float32)
    X = torch.from_numpy(Xh).to(dev)
    y = torch.from_numpy(yh).to(dev)
    n, p = X.shape
    # kernel against plain, of max(1, the largest entry): one x-update is 3
    # passes of 500 dependent steps, each a float32 dot over 100,000 rows a
    # block in another order (measured 1.5e-8 on an H100; 1e-6, and a
    # kernel a pass short must read more); an epoch is 100,000 dependent
    # rows a shard, each a dot over 2,000 features in another order
    # (measured 3.6e-7; 1e-5)
    tol = {"admm_shooting": 1e-6, "online_tg": 1e-5}
    scan_kernels_report(np, torch, X, y, dev, report, parity, tol)
    emit({"phase": "baselines_kernels", "card": card, "tolerance": tol,
          "max_rel_err": {k: parity[k] for k in tol},
          "admm_shooting": report["admm_shooting"],
          "online_tg": report["online_tg"]})

    def objective(beta, lam1, lam2):
        return float(glm_lib.objective(
            "logistic", y, X, torch.from_numpy(np.asarray(beta, np.float32))
            .to(dev), lam1, lam2))

    out = {"phase": "baselines", "card": card, "train_shape": [n, p],
           "fista_max_iter": BASELINE_FISTA_CAP}
    # ---------------------------------------------------------- L1, lam1 = 1
    lam1 = BASELINE_LAM1
    (_, h_star), fista_s, _ = counted_fit(torch, ops, lambda: prox_ref
                                          .fit_fista(X, y, lam1=lam1,
                                                     lam2=0.0, max_iter=
                                                     BASELINE_FISTA_CAP,
                                                     device=dev))
    f_star = h_star[-1]
    l1 = {"f_star": f_star, "fista_iters": len(h_star) - 1,
          "fista_s": fista_s,
          "fista_stopped_by_tol": len(h_star) - 1 < BASELINE_FISTA_CAP}
    l1["d-GLMNET"] = dglmnet_rows(
        np, torch, ops, objective, f_star, lam1, 0.0, GLMSolver(
            Xh, yh, config=DGLMNETConfig(tile_size=256, coupling="jacobi",
                                         max_outer=BASELINE_ITERS, tol=0.0),
            device=dev))
    rhos = {}
    for k in range(-3, 4):
        _, h = fit_admm(X, y, ADMMConfig(lam1=lam1, rho=4.0 ** k,
                                         n_blocks=4, max_outer=10),
                        device=dev)
        rhos[4.0 ** k] = h["f"][-1]
    rho = min(rhos, key=lambda r: (rhos[r], r))
    (_, h), wall, admm_counts = counted_fit(torch, ops, lambda: fit_admm(
        X, y, ADMMConfig(lam1=lam1, rho=rho, n_blocks=4,
                         max_outer=BASELINE_ITERS), device=dev))
    l1["ADMM"] = method_row(np, h["f"], h["nnz"][-1], wall, BASELINE_ITERS,
                            admm_counts, f_star)
    l1["ADMM"].update(rho=rho, f_at_10_by_rho={str(r): f for r, f in
                                               rhos.items()})
    (_, h), wall, tg_counts = counted_fit(torch, ops, lambda: fit_online_tg(
        X, y, OnlineTGConfig(lam1=lam1 / n, lam2=0.0, epochs=BASELINE_ITERS,
                             lr=0.3, n_shards=4), device=dev))
    l1["online-TG"] = method_row(np, h["f"], h["nnz"][-1], wall,
                                 BASELINE_ITERS, tg_counts, f_star)
    check(admm_counts["admm_shooting"] == BASELINE_ITERS
          and tg_counts["online_tg"] == BASELINE_ITERS
          and admm_counts["glm_stats"] == BASELINE_ITERS * 13
          and tg_counts["glm_stats"] == BASELINE_ITERS + 1,
          f"baselines launches: ADMM {admm_counts}, online {tg_counts}")
    out["L1"] = l1

    # ---------------------------------------------------------- L2, lam2 = 1
    lam2 = BASELINE_LAM2
    (_, h_star), fista_s, _ = counted_fit(torch, ops, lambda: prox_ref
                                          .fit_fista(X, y, lam1=0.0,
                                                     lam2=lam2, max_iter=
                                                     BASELINE_FISTA_CAP,
                                                     device=dev))
    f_star = h_star[-1]
    l2 = {"f_star": f_star, "fista_iters": len(h_star) - 1,
          "fista_s": fista_s,
          "fista_stopped_by_tol": len(h_star) - 1 < BASELINE_FISTA_CAP}
    l2["d-GLMNET"] = dglmnet_rows(
        np, torch, ops, objective, f_star, 0.0, lam2, GLMSolver(
            Xh, yh, config=DGLMNETConfig(lam1=0.0, lam2=lam2, tile_size=256,
                                         coupling="jacobi", adaptive_mu=False,
                                         max_outer=BASELINE_L2_ITERS,
                                         tol=0.0), device=dev))
    lc = LBFGSConfig(lam2=lam2, max_iter=BASELINE_L2_ITERS)
    (_, h), wall, counts = counted_fit(torch, ops, lambda:
                                       fit_online_warmstart_lbfgs(
        X, y, lc, OnlineTGConfig(lam1=0.0, lam2=lam2, epochs=2, lr=0.3),
        device=dev))
    # 2 epochs, then L-BFGS (f at w = 0 and at its start, then one a step)
    l2["online+L-BFGS"] = method_row(np, h["f"], h["nnz"][-1], wall,
                                     len(h["f"]) - 2, counts, f_star)
    check(h["f"][-1] <= f_star + 1e-3 * abs(f_star),
          f"online+L-BFGS L2 f {h['f'][-1]} above FISTA's f* {f_star}")
    (_, h), wall, counts = counted_fit(torch, ops, lambda: fit_lbfgs(
        X, y, lc, device=dev))
    l2["L-BFGS"] = method_row(np, h["f"], h["nnz"][-1], wall,
                              len(h["f"]) - 1, counts, f_star)
    check(h["f"][-1] <= f_star + 1e-3 * abs(f_star),
          f"L-BFGS L2 f {h['f'][-1]} above FISTA's f* {f_star}")
    out["L2"] = l2
    del X, y, Xh, yh
    torch.cuda.empty_cache()

    # --------------------------------------- small fits: card against CPU
    from repro_torch.data import synthetic
    small = {}
    ds = synthetic.make_dense(n=500, p=61, seed=21)
    Xs, ys = ds.train.X, ds.train.y
    oc = OnlineTGConfig(lam1=0.2, lam2=0.1, epochs=5, lr=0.3)
    calls = {
        "admm": lambda d: fit_admm(Xs, ys, ADMMConfig(lam1=0.5, lam2=0.1,
                                                      max_outer=10),
                                   device=d),
        "online_tg": lambda d: fit_online_tg(Xs, ys, oc, device=d),
        "lbfgs": lambda d: fit_lbfgs(Xs, ys, LBFGSConfig(lam2=0.8,
                                                         max_iter=12),
                                     device=d),
        "warmstart": lambda d: fit_online_warmstart_lbfgs(
            Xs, ys, LBFGSConfig(lam2=0.5, max_iter=5),
            OnlineTGConfig(lam1=0.0, lam2=0.5, epochs=3, lr=0.3), device=d),
        "fista": lambda d: prox_ref.fit_fista(Xs, ys, lam1=0.7, lam2=0.4,
                                              max_iter=20, tol=0.0,
                                              device=d)}
    for name, call in calls.items():
        (b_g, h_g), (b_c, h_c) = call(dev), call("cpu")
        f_g = np.array(h_g["f"] if isinstance(h_g, dict) else h_g)
        f_c = np.array(h_c["f"] if isinstance(h_c, dict) else h_c)
        check(len(f_g) == len(f_c), f"{name} small fit: {len(f_g)} "
              f"iterations on the card, {len(f_c)} on the CPU")
        small[name] = {"f_rel_err": float(np.max(np.abs(f_g / f_c - 1))),
                       "beta_abs_err": float(np.max(np.abs(b_g - b_c)))}
        check(small[name]["f_rel_err"] <= 1e-5
              and small[name]["beta_abs_err"] <= 1e-4,
              f"{name} small fit: card vs CPU {small[name]}")
    out["small_card_vs_cpu"] = small
    out["small_tolerance"] = {"f_rel": 1e-5, "beta_abs": 1e-4}

    # ---- the L1 protocol on the cut that tests/test_torch_protocol_witness.py
    # runs in both packages on the CPU (reported: its f at 10 and 30)
    ds = synthetic.make_dense(n=BASELINE_WITNESS_ROWS * 5 // 4, p=p,
                              k_true=p // 10, seed=SEED)
    Xc, yc = ds.train.X, ds.train.y
    _, h_c = prox_ref.fit_fista(Xc, yc, lam1=BASELINE_LAM1, max_iter=500,
                                device=dev)
    f_c = [float(v) for v in GLMSolver(Xc, yc, config=DGLMNETConfig(
        tile_size=256, coupling="jacobi", max_outer=BASELINE_ITERS, tol=0.0),
        device=dev).fit(BASELINE_LAM1, 0.0).history["f"]]
    check(bool(np.isfinite(f_c).all()), f"witness cut: non-finite f {f_c}")
    fs_c = float(h_c[-1])
    out["witness_cut"] = {
        "shape": list(Xc.shape), "f_star": fs_c, "fista_iters": len(h_c) - 1,
        **{f"at_{k}": {"f": f_c[k - 1],
                       "subopt": (f_c[k - 1] - fs_c) / abs(fs_c)}
           for k in (10, BASELINE_ITERS)}}
    del ds, Xc, yc
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return admm_counts, tg_counts


# the lm phase: gemma3-12b's full config (48 layers, d 3840, vocab 262,144)
# with float32 weights, a request batch whose prompt spans two 1,024-key
# attention chunks and the 1,024-token local window, and the head probe of
# examples/lm_head_probe.py on its pooled features
LM_ARCH = "gemma3-12b"
LM_PARAMS = 11_765_395_200          # the reference's count of the config
LM_BATCH, LM_PROMPT, LM_GEN = 2, 1536, 32
# Decode against the full forward, over the largest |logit|, held on
# one-layer cuts of the full-width weights (a local layer, a global one).
# Under the reference's init (wq's std 1/sqrt(H)) the attention logits
# have a std near 340 at full width, and float32 roundings grow about
# tenfold a layer: the forward itself, on one row alone or beside another
# (the same arithmetic in another GEMM shape), parts by 8e-5 of the
# largest logit at one layer, 1.2e-3 at three and 1.28 at 48 (an H100 at
# 700 W).  So the 48 layers' decode error is reported beside that floor,
# not held.  One layer keeps the decode error near 1e-4; 1e-3 is the
# reference's own bar (tests/test_models.py, 1e-3 on logits of about 4),
# and a decode at a position off by one (the fault control) must exceed
# it.
LM_DECODE_TOL = 1e-3
LM_DEPTHS = (2, 3, 6, 12)           # the depth profile's cuts (gen 8)
PROBE_N, PROBE_SEQ, PROBE_TRAIN, PROBE_BATCH = 2048, 32, 1600, 128
PROBE_BETA_TOL = 1e-5


def probe_agreement(np, r_card, r_cpu) -> dict:
    """The card's probe fit against the CPU's: equal alphas and n_iter and
    beta within 1e-5; or, where a float32 near-tie parts them (ROADMAP
    Queue 3 item 4), the step where the alphas part, with f equal there
    within 1e-6 relative on both."""
    a_card, a_cpu = r_card.history["alpha"], r_cpu.history["alpha"]
    f_card = np.array(r_card.history["f"])
    f_cpu = np.array(r_cpu.history["f"])
    beta_err = float(np.max(np.abs(r_card.beta - r_cpu.beta)))
    out = {"n_iter_card": r_card.n_iter, "n_iter_cpu": r_cpu.n_iter,
           "beta_abs_err": beta_err, "alpha_card": a_card,
           "alpha_cpu": a_cpu}
    if a_card == a_cpu:
        check(r_card.n_iter == r_cpu.n_iter
              and beta_err <= PROBE_BETA_TOL,
              f"lm: probe card vs CPU: n_iter {r_card.n_iter} / "
              f"{r_cpu.n_iter}, beta {beta_err}")
        return {**out, "parted_at": None}
    k = next(i for i, (a, b) in enumerate(zip(a_card, a_cpu)) if a != b)
    f_rel = float(np.max(np.abs(f_card[:k + 1] - f_cpu[:k + 1])
                         / np.abs(f_cpu[:k + 1])))
    print(f"lm: probe card and CPU part at superstep {k} (alpha "
          f"{a_card[k]} / {a_cpu[k]}, f {f_card[k]!r} / {f_cpu[k]!r})",
          flush=True)
    check(f_rel <= 1e-6, f"lm: probe fits part at superstep {k} with f "
          f"{f_rel} apart: not a float32 tie")
    return {**out, "parted_at": k, "f_rel_err_to_part": f_rel}


def lm_cut(model, layers, **replace):
    """A model over the given layers of ``model`` (the same tensors, no
    copy), its config replaced by ``replace``."""
    from repro_torch.models.transformer import DecoderModel
    state = model.state_dict()
    sub = {k: v for k, v in state.items() if not k.startswith("layers.")}
    for i, src in enumerate(layers):
        pre = f"layers.{src}."
        sub.update({f"layers.{i}.{k[len(pre):]}": v
                    for k, v in state.items() if k.startswith(pre)})
    return DecoderModel(model.cfg.replace(n_layers=len(layers), **replace),
                        sub)


def decode_vs_forward(torch, serve, model, prompts, gen: int, *,
                      extra=None, whole: bool = False, bar=None) -> tuple:
    """(the serve record, the check) of ``serve.generate`` on ``prompts``
    against one full forward over the prompt and the generated tokens:
    the largest difference of the logits at the positions they share, over
    the largest |logit|; the forward's own floor (row 0 forwarded alone,
    the same arithmetic in another GEMM shape); the greedy tokens that
    differ from the forward's argmax, and which of those are ties (the
    forward's top two within the decode's difference).  ``extra``: the
    modality inputs; ``whole``: the forward takes the last generated token
    too (S + gen tokens a row, which an MoE's token groups divide);
    ``bar``: list the (row, step) pairs past max(bar, LMF_FLOOR_FACTOR x
    the floor), that bar as ``bar``."""
    S = prompts.shape[1]
    extra = extra or {}
    rec = serve.generate(model, prompts, gen, extra=extra, keep_logits=True)
    seq, got = rec.pop("seq"), rec.pop("logits")
    tail = seq if whole else seq[:, :-1]
    t0 = time.perf_counter()
    full, _ = model(torch.cat([prompts, tail], dim=1), **extra)
    want = full[:, S - 1:S - 1 + gen]
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    solo, _ = model(torch.cat([prompts[:1], tail[:1]], dim=1),
                    **{k: v[:1] for k, v in extra.items()})
    solo = solo[:, :S - 1 + gen]
    forward_tokens = full.shape[0] * full.shape[1]
    del full
    # positions where either side is not finite (the reference's init
    # overflows xlstm's sLSTM at full width) are compared by where they
    # fall, the others by value
    fin_got = torch.isfinite(got).all(dim=-1)            # (B, gen)
    fin_want = torch.isfinite(want).all(dim=-1)
    both = fin_got & fin_want
    zero = torch.zeros((), device=got.device)
    scale = float(torch.where(both[..., None], want.abs(), zero).max()) \
        if bool(both.any()) else float("nan")
    diff = torch.where(both, (got - want).abs().amax(dim=-1), zero)
    err = float(diff.max()) / scale if bool(both.any()) else float("nan")
    solo_ok = both[0] & torch.isfinite(solo[0, S - 1:]).all(dim=-1)
    floor = float(torch.where(solo_ok, (solo[0, S - 1:] - want[0]).abs()
                              .amax(dim=-1), zero).max()) / scale \
        if bool(solo_ok.any()) else float("nan")
    top2 = want.topk(2, dim=-1).values
    gap = torch.where(both, top2[..., 0] - top2[..., 1], float("inf"))
    differ = (want.argmax(dim=-1) != seq) & both
    ties = differ & (gap <= 2 * diff)
    out = {"decode_vs_forward_rel_err": err, "forward_floor_rel": floor,
           "max_abs_logit": scale, "min_top2_gap_rel":
           float(gap.min()) / scale, "forward_s": forward_s,
           "forward_tokens": forward_tokens,
           "greedy_differs": int(differ.sum()), "greedy_ties":
           int(ties.sum()), "greedy_differs_not_tie":
           (differ & ~ties).nonzero().tolist(),
           "nonfinite_decode": int((~fin_got).sum()),
           "nonfinite_forward": int((~fin_want).sum()),
           "nonfinite_same_positions": bool((fin_got == fin_want).all())}
    if bar is not None:      # the (row, step) pairs past the bar
        if floor == floor:                           # not NaN
            bar = max(bar, LMF_FLOOR_FACTOR * floor)
        out["bar"] = bar
        out["over_bar"] = (diff > bar * scale).nonzero().tolist()
    return rec, out


def attention_logit_std(torch, model, tokens) -> float:
    """The std of layer 0's attention logits (q k / sqrt(hd), before the
    rotation and the mask) over ``tokens``: the scale the reference's init
    gives them."""
    from repro_torch.models import attention, common
    cfg = model.cfg
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    h = torch.nn.functional.embedding(tokens, model.embed).to(dt)
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    lp = model.layers[0]
    q, k, _ = attention._qkv(
        lp["attn"], common.rms_norm(h, lp["ln1"], cfg.norm_eps), cfg)
    k = k.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) \
        / cfg.resolved_head_dim ** 0.5
    return float(logits.std())


def position_fault(torch, lm, model, prompts, want_last) -> dict:
    """The fault control: the prompt's last token decoded at its own
    position and at the next one (its cache entry left empty, its rotation
    off by one), each against the forward's logits there."""
    B, S = prompts.shape
    prefill, decode = lm.make_prefill_step(model), lm.make_decode_step(model)
    scale = float(want_last.abs().max())
    out = {}
    for tag, pos in (("right", S - 1), ("off_by_one", S)):
        caches = lm.init_cache(model.cfg, B, S + 1, device=prompts.device)
        _, caches = prefill(caches, {"tokens": prompts[:, :-1]})
        logits, _ = decode(caches, prompts[:, -1:], pos)
        out[tag] = float((logits - want_last).abs().max()) / scale
    return out


def lm_phase(np, torch, dev, card) -> dict:
    """gemma3-12b at full width on the card: ``launch/serve.py``'s
    ``generate`` (batched prefill and greedy decode) held against one full
    forward, then ``core/head_probe.py`` on mean-pooled features (K1, K2
    and K4 through the dense Gauss-Seidel fit) held against the same fit
    on the CPU.  Returns the probe's launch counts."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import head_probe
    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import common, lm
    from repro_torch.models.transformer import param_defs

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    free_b, total_b = torch.cuda.mem_get_info()
    cfg = get_arch(LM_ARCH)
    n_params = common.param_count(param_defs(cfg))
    check(n_params == LM_PARAMS, f"lm: {n_params} parameters, the "
          f"reference counts {LM_PARAMS}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.build_model(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = list(model.parameters())
    check(sum(p.numel() for p in params) == n_params
          and all(p.device == dev for p in params),
          "lm: the model's parameters are not the config's, on the card")
    weight_gb = sum(p.numel() * p.element_size() for p in params) / 1e9
    del params
    emit({"phase": "lm_setup", "arch": cfg.name, "card": card,
          "params": n_params, "weight_gb": weight_gb, "dtype": cfg.dtype,
          "weights_dtype": "float32", "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "free_gb_before": free_b / 1e9, "total_gb": total_b / 1e9,
          "init_s": init_s,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9})

    # ---- serve: prefill and greedy decode, then one full forward
    prompts = torch.randint(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.reset_peak_memory_stats()
    rec, full48 = decode_vs_forward(torch, serve, model, prompts, LM_GEN)
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    check(bool(np.isfinite([full48["decode_vs_forward_rel_err"],
                            full48["max_abs_logit"]]).all()),
          f"lm: non-finite logits {full48}")
    emit({"phase": "lm_serve", "card": card,
          **{k: v for k, v in rec.items() if k != "tokens"},
          "first_tokens": rec["tokens"][0][:8], "peak_gb": serve_peak,
          "check_48_layers": full48})
    # the check: one local and one global layer at full width, held to
    # LM_DECODE_TOL, greedy tokens equal but for ties; then the fault
    # control and the depth profile (reported)
    cuts = {"local_layer_0": lm_cut(model, [0]),
            "global_layer_5": lm_cut(model, [5], local_global_ratio=0,
                                     sliding_window=None)}
    checks = {}
    for tag, cut in cuts.items():
        _, checks[tag] = decode_vs_forward(torch, serve, cut, prompts,
                                           LM_GEN)
        c = checks[tag]
        check(c["decode_vs_forward_rel_err"] <= LM_DECODE_TOL,
              f"lm: {tag}: decode logits {c['decode_vs_forward_rel_err']} "
              f"of the largest |logit| off the full forward (tolerance "
              f"{LM_DECODE_TOL})")
        check(not c["greedy_differs_not_tie"],
              f"lm: {tag}: greedy tokens differ from the forward's argmax "
              f"at (row, step) {c['greedy_differs_not_tie']}")
    local = cuts["local_layer_0"]
    want_last = local(prompts)[0][:, -1]
    fault = position_fault(torch, lm, local, prompts, want_last)
    check(fault["right"] <= LM_DECODE_TOL < fault["off_by_one"],
          f"lm: the position fault control does not separate: {fault}")
    depths = {}
    for d in LM_DEPTHS:
        _, c = decode_vs_forward(torch, serve, lm_cut(model, range(d)),
                                 prompts, 8)
        depths[d] = {k: c[k] for k in ("decode_vs_forward_rel_err",
                                       "forward_floor_rel",
                                       "greedy_differs")}
    emit({"phase": "lm_decode_check", "card": card,
          "layer0_attention_logit_std": attention_logit_std(
              torch, model, prompts[:, :256]),
          "tolerance": LM_DECODE_TOL, "cuts": checks,
          "position_fault": fault, "depth_profile": depths,
          "depth_48": {k: full48[k] for k in ("decode_vs_forward_rel_err",
                                              "forward_floor_rel",
                                              "greedy_differs")}})
    del rec, prompts, cuts, local, want_last
    torch.cuda.empty_cache()

    # ---- the head probe: examples/lm_head_probe.py's task at full width
    rng = np.random.default_rng(SEED)
    V = cfg.vocab_size
    labels = rng.choice([-1.0, 1.0], PROBE_N).astype(np.float32)
    tokens = np.where(labels[:, None] > 0,
                      rng.integers(0, V // 2, (PROBE_N, PROBE_SEQ)),
                      rng.integers(V // 2, V, (PROBE_N, PROBE_SEQ)))
    tok = torch.from_numpy(tokens).to(dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    feats = head_probe.extract_features(
        lambda m, t: m(t, return_hidden=True)[0], model,
        tok.split(PROBE_BATCH))
    torch.cuda.synchronize()
    feature_s = time.perf_counter() - t0
    feature_peak = torch.cuda.max_memory_allocated() / 1e9
    check(tuple(feats.shape) == (PROBE_N, cfg.d_model)
          and feats.device == dev and bool(torch.isfinite(feats).all()),
          f"lm: features {tuple(feats.shape)} on {feats.device}: not "
          "finite, or not on the card")
    del model, tok
    torch.cuda.empty_cache()
    n_tr = PROBE_TRAIN
    config = DGLMNETConfig(lam1=0.05, lam2=0.05, tile_size=256,
                           max_outer=40)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = head_probe.fit_probe(feats[:n_tr], labels[:n_tr], config)
    fit_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    probe_counts = {k: counts[k] for k in ("glm_stats", "cd_tile_solve",
                                           "alpha_search")}
    check(all(v > 0 for v in probe_counts.values()),
          f"lm: the probe fit did not launch K1, K2 and K4: {counts}")
    check(not any(v for k, v in counts.items() if k.endswith("/plain")),
          f"lm: the probe fit took a plain route: {counts}")
    p = head_probe.predict_proba(feats[n_tr:], res.beta).cpu().numpy()
    y_te = labels[n_tr:]
    acc = float(((p > 0.5) == (y_te > 0)).mean())
    t0 = time.perf_counter()
    res_cpu = head_probe.fit_probe(feats[:n_tr].cpu(), labels[:n_tr],
                                   config, device="cpu")
    cpu_fit_s = time.perf_counter() - t0
    agree = probe_agreement(np, res, res_cpu)
    probe_s = feature_s + fit_s + cpu_fit_s
    emit({"phase": "lm_probe", "card": card, "n": PROBE_N,
          "seq": PROBE_SEQ, "train": n_tr, "features_shape":
          list(feats.shape), "feature_s": feature_s,
          "feature_tok_per_s": PROBE_N * PROBE_SEQ / feature_s,
          "feature_peak_gb": feature_peak, "fit_s": fit_s,
          "n_iter": res.n_iter, "f": res.history["f"][-1],
          "nnz": int((res.beta != 0).sum()), "p": int(res.beta.size),
          "test_accuracy": acc, "test_au_prc": float(
              synthetic.au_prc(y_te, p)),
          "launches": probe_counts, "cpu_fit_s": cpu_fit_s,
          "card_vs_cpu": agree, "probe_s": probe_s,
          "phase_s": time.perf_counter() - t_phase})
    del feats
    torch.cuda.empty_cache()
    return probe_counts


# the lm_families phase: the LM template's other five families at full
# width, one model at a time (built, served, checked, freed), and the head
# probe's fused Jacobi fit (K5, K6) on deepseek-v2-lite's features.
# mixtral-8x7b is 186.81 GB in float32, over one 80 GB card: 8 of its 32
# layers, full width.  Batch 2 with 1,408- and 1,536-token rows keeps B x S
# a multiple of the 256-token MoE group for the prefill and the checking
# forward (which takes the last generated token too); the prompt crosses
# the 1,024-key attention chunk; whisper stays within its 448 learned
# positions (320 + 128).  The recurrent models (zamba2, xlstm) take half
# the prompt: their plain scans launch a few kernels a time step, and at
# 1,408 tokens the phase took 234-292 s on an H100 (700 W) host, past its
# 240 s budget.
LMF_BATCH, LMF_PROMPT, LMF_GEN = 2, 1408, 128
LMF_RECURRENT_PROMPT = LMF_PROMPT // 2
# why a model of LMF_MODELS is cut in depth
LMF_REDUCED_WHY = {
    "deepseek-v2-lite-16b": "the whole run's 900 s, once train_dist trains "
                            "the six families too (27 layers took 35.8 s "
                            "here)",
    "mixtral-8x7b": "186.81 GB of float32 weights do not fit one 80 GB card"}
LMF_MODELS = (
    # arch, layers kept (None: all), the reference's parameter count,
    # prompt length, the stacks of the one-block-of-each-kind cut and its
    # config
    ("deepseek-v2-lite-16b", 9, 5_182_236_672, LMF_PROMPT,
     {"dense_layers": [0], "layers": [0]},
     dict(n_layers=2, first_dense_layers=1)),
    ("mixtral-8x7b", 8, 11_872_309_248, LMF_PROMPT, {"layers": [0]},
     dict(n_layers=1)),
    ("zamba2-1.2b", None, 1_170_138_240, LMF_RECURRENT_PROMPT,
     {"layers": [0]}, dict(n_layers=1)),
    ("xlstm-1.3b", None, 1_238_632_448, LMF_RECURRENT_PROMPT,
     {"layers": [0], "slstm": [0]}, dict(n_layers=2, slstm_period=2)),
    ("llama-3.2-vision-11b", None, 11_536_830_464, LMF_PROMPT,
     {"cross": [0], "layers": [0]}, dict(n_layers=1, cross_attn_period=1)),
    ("whisper-tiny", None, 37_203_072, 320,
     {"enc_layers": [0], "dec_layers": [0]},
     dict(n_layers=1, encoder_layers=1)),
)
# the cuts' bar: the reference's own _DECODE_TOL (tests/test_models.py),
# or twice the cut's own forward floor (row 0 forwarded alone: the same
# float32 arithmetic in another GEMM shape) where that is larger.  Under
# the reference's init llama-3.2-vision's cross block has attention logits
# with a std in the hundreds (its record's cross_attention_logit_std), and
# its one-cross-one-self cut parts from itself by 1.8e-3 of the largest
# logit (an H100 at 700 W): no float32 decode can come within 1e-3 of
# such a forward.  The fault controls exceed either bar by two orders or
# more.
LMF_TOL = {"zamba2-1.2b": 5e-3, "xlstm-1.3b": 2e-2}
LMF_DEFAULT_TOL = 1e-3
LMF_FLOOR_FACTOR = 2.0
LMF_NO_DROP = 16.0            # moe.CAPACITY_FACTOR for the checks
LMF_PROBE_N, LMF_PROBE_SEQ, LMF_PROBE_TRAIN = 1024, 32, 800
# xlstm at full width: the reference's init draws the sLSTM's w_gates (d,
# 4, H, hd) with std 1/sqrt(H) = 0.5, so its input gates' pre-activations
# (the record's slstm_input_gate: std 22.07, up to 123.5 above their head
# mean on an H100 at 700 W) stray past float32 exp's range (88.7): exp
# overflows, c / n = inf / inf, and the model's logits turn NaN from the
# third token on, in the JAX package as here (tests/test_torch_families.py
# holds both on one full-width sLSTM layer; ROADMAP Queue 3 item 13).  So
# xlstm's blocks are held alone at full width: the mLSTM on the model's
# normed embeddings, the sLSTM on them scaled by this factor (a tenth of
# the gates' spread, finite).
LMF_SLSTM_INPUT_SCALE = 0.1


def family_cut(lm, model, keep: dict, **replace):
    """A model over the layers ``keep`` ({stack: [layer, ...]}) of
    ``model``'s stacks (the same tensors, no copy) and its other
    parameters, its config replaced by ``replace``."""
    state = model.state_dict()
    stacks = {k.split(".", 1)[0] for k in state if k.split(".")[1:2]
              and k.split(".")[1].isdigit()}
    sub = {k: v for k, v in state.items() if k.split(".", 1)[0] not in
           stacks}
    for stack, layers in keep.items():
        for i, src in enumerate(layers):
            pre = f"{stack}.{src}."
            sub.update({f"{stack}.{i}.{k[len(pre):]}": v
                        for k, v in state.items() if k.startswith(pre)})
    return lm.build_model(model.cfg.replace(**replace), state=sub)


def family_fault(torch, lm, model, prompts, extra, want, p0: int) -> dict:
    """The fault control of a cut: the prompt's first ``p0`` tokens
    prefilled, then token ``p0`` decoded at its own position (``right``)
    and at the next one (``off_by_one``: its rotation and learned
    position off, its cache entry left empty).  Each against the
    forward's logits at ``p0`` (``want``), over their largest |logit|."""
    B = prompts.shape[0]
    prefill, decode = lm.make_prefill_step(model), lm.make_decode_step(model)
    scale = float(want.abs().max())
    out = {}
    for tag, pos in (("right", p0), ("off_by_one", p0 + 1)):
        caches = lm.init_cache(model.cfg, B, p0 + 2, device=prompts.device)
        _, caches = prefill(caches, {"tokens": prompts[:, :p0], **extra})
        logits, _ = decode(caches, prompts[:, p0:p0 + 1], pos, extra)
        out[tag] = float((logits - want).abs().max()) / scale
    return out


class RouterLog:
    """The top-k expert sets the MoE router picks, call by call
    (``moe.route`` wrapped while it is installed): where a cut's decode
    parts from its forward at one position, whether a float32 tie in the
    router moved an expert there."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        self._route = route = self.moe.route

        def logged(p, x, cfg):
            out = route(p, x, cfg)
            self.calls.append((tuple(x.shape[:2]), out[1]))
            return out
        self.moe.route = logged
        return self

    def __exit__(self, *exc):
        self.moe.route = self._route

    def sets_differ(self, n_moe: int, prompt: int, row: int, step: int):
        """For the logits of (row, step) of a ``decode_vs_forward`` run
        logged as [prefill, decode steps..., forward, solo forward]: the
        MoE layers whose top-k set differs between the decode and the
        forward at that position."""
        pre = self.calls[:n_moe]
        steps = self.calls[n_moe:-2 * n_moe]
        fwd = self.calls[-2 * n_moe:-n_moe]
        (_, T), t = fwd[0][0], prompt - 1 + step
        layers = []
        for layer in range(n_moe):
            f_idx = fwd[layer][1].reshape(-1, fwd[layer][1].shape[-1])
            want = set(f_idx[row * T + t].tolist())
            if step == 0:
                (_, S), d_idx = pre[layer]
                got = d_idx.reshape(-1, d_idx.shape[-1])[row * S + S - 1]
            else:
                _, d_idx = steps[(step - 1) * n_moe + layer]
                got = d_idx.reshape(-1, d_idx.shape[-1])[row]
            if set(got.tolist()) != want:
                layers.append(layer)
        return layers


# the recurrences' scans (ops entries), the steps of a call from its args
SCAN_NAMES = ("ssm_scan", "mlstm_scan", "slstm_scan")
# the recurrences' plain loops at the same cells, before the scan kernels
# (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W): prefill seconds, decode ms
# a step
PLAIN_LOOP_RECURRENT = {"zamba2-1.2b": {"prefill_s": 5.96},
                  "xlstm-1.3b": {"prefill_s": 15.15},
                  "decode_ms_per_step_range": [46.5, 77.3]}


def scan_steps(name: str, args) -> int:
    """The time steps of one call of ``ops.<name>``."""
    return args[3] if name == "slstm_scan" else args[0].shape[1]


class ScanWatch:
    """The recurrences' scan entries of ``kernels.ops`` wrapped while
    installed: the calls on the card by name (``card_calls``, counted
    here, apart from ops' own launch counts), with ``capture`` the
    arguments of each entry's first call (``args``: (positional,
    keyword)), and with ``timed`` CUDA events around each call over more
    than one time step, by its steps, read once at the end
    (``seconds``).  The models call
    ``ops.<name>`` by attribute, so they go through the wrapper."""

    def __init__(self, torch, ops, timed: bool = False,
                 capture: bool = False):
        self.torch, self.ops, self.timed = torch, ops, timed
        self.capture = capture
        self.events, self.saved, self.args = [], {}, {}
        self.card_calls = dict.fromkeys(SCAN_NAMES, 0)

    def __enter__(self):
        torch = self.torch
        for name in SCAN_NAMES:
            inner = self.saved[name] = getattr(self.ops, name)

            def wrapper(*a, _inner=inner, _name=name, **k):
                if self.capture:
                    self.args.setdefault(_name, (a, dict(k)))
                if a[0].is_cuda:
                    self.card_calls[_name] += 1
                # a decode step (one time step) is counted, not timed
                if not self.timed or scan_steps(_name, a) == 1:
                    return _inner(*a, **k)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _inner(*a, **k)
                end.record()
                self.events.append((scan_steps(_name, a), start, end))
                return out
            setattr(self.ops, name, wrapper)
        return self

    def __exit__(self, *exc):
        for name, inner in self.saved.items():
            setattr(self.ops, name, inner)

    def seconds(self, steps: int) -> tuple:
        """(device seconds, calls) of the scans over ``steps`` steps."""
        self.torch.cuda.synchronize()
        ev = [(a, b) for n, a, b in self.events if n == steps]
        return sum(a.elapsed_time(b) for a, b in ev) / 1e3, len(ev)


def scan_gates(tag: str, counts: dict, card_calls: dict, training: bool,
               want=None) -> dict:
    """The scans' launch gates of one run, from ops' counts and the card
    calls that ``ScanWatch`` saw: training, every card call ran the plain
    loop (``"<name>/plain"`` equal to the calls, no kernel launched);
    serving, every card call launched its kernel (no ``/plain``).  With
    ``want`` ({name: calls}), the calls must be those too.  The GLM
    kernels launch nowhere on these paths."""
    glm = {k: v for k, v in counts.items()
           if v and k.split("/")[0] not in SCAN_NAMES}
    check(not glm, f"{tag}: GLM kernels launched {glm}")
    rec = {}
    for name in SCAN_NAMES:
        calls, k, plain = (card_calls[name], counts.get(name, 0),
                           counts.get(f"{name}/plain", 0))
        rec[name] = {"card_calls": calls, "launches": k, "plain": plain}
        if training:
            check(k == 0 and plain == calls,
                  f"{tag}: {name} launched {k} times in training, ran "
                  f"the plain loop {plain} times for {calls} calls")
        else:
            check(plain == 0 and k == calls,
                  f"{tag}: {name} launched {k} times for {calls} calls, "
                  f"the plain loop {plain} times")
        if want is not None:
            rec[name]["want"] = want.get(name, 0)
            check(calls == want.get(name, 0),
                  f"{tag}: {name} called {calls} times on the card, the "
                  f"recurrent layers need {want.get(name, 0)}")
    return rec


def xlstm_block_checks(torch, xlstm, common, model, prompts, gen: int,
                       tol: float) -> dict:
    """xlstm's mLSTM and sLSTM blocks alone at full width (layer 0 of each
    stack): the full form over S + gen positions against a prefill of S
    and ``gen`` decode steps from the cache it leaves, over the largest
    |output|; and the fault control, a decode from a state one token
    short.  The mLSTM reads the model's normed embeddings of the tokens,
    the sLSTM the same scaled by ``LMF_SLSTM_INPUT_SCALE`` (its own
    inputs overflow it, in the reference as here)."""
    cfg = model.cfg
    B, S = prompts.shape
    tokens = torch.cat([prompts, prompts[:, :gen].flip(0)], dim=1)
    emb = torch.nn.functional.embedding(tokens, model.embed)
    out = {}
    blocks = (("mlstm", xlstm.mlstm_apply, model.layers[0], 1.0),
              ("slstm", xlstm.slstm_apply, model.slstm[0],
               LMF_SLSTM_INPUT_SCALE))
    for tag, apply_fn, lp, input_scale in blocks:
        x = common.rms_norm(emb, lp["ln"], cfg.norm_eps) * input_scale
        defs = (xlstm.mlstm_cache_defs if tag == "mlstm"
                else xlstm.slstm_cache_defs)(cfg, B)

        def fresh():
            return {k: torch.full(d.shape, -1e30 if k == "m" else 0.0,
                                  device=prompts.device)
                    for k, d in defs.items()}

        full, _ = apply_fn(lp["mixer"], x, cfg)
        check(bool(torch.isfinite(full).all()),
              f"lm_families: xlstm {tag} block: non-finite output")
        scale = float(full.abs().max())
        cache = fresh()
        apply_fn(lp["mixer"], x[:, :S], cfg, cache=cache)
        steps = []
        for i in range(S, S + gen):
            y, cache = apply_fn(lp["mixer"], x[:, i:i + 1], cfg, cache=cache,
                                decode=True)
            steps.append(y)
        err = float((torch.cat(steps, dim=1) - full[:, S:]).abs().max()) \
            / scale
        short = fresh()
        apply_fn(lp["mixer"], x[:, :S - 1], cfg, cache=short)
        y, _ = apply_fn(lp["mixer"], x[:, S:S + 1], cfg, cache=short,
                        decode=True)
        fault = float((y[:, 0] - full[:, S]).abs().max()) / scale
        check(err <= tol < fault,
              f"lm_families: xlstm {tag} block: decode {err} off the full "
              f"form, state one token short {fault} (tolerance {tol})")
        out[tag] = {"decode_vs_full_rel_err": err, "max_abs_output": scale,
                    "state_short": fault, "input_scale": input_scale,
                    "positions": S + gen}
    # why the model's own inputs overflow the sLSTM: its input gates'
    # pre-activations on the normed embeddings, against exp's range
    lp = model.slstm[0]
    x = common.rms_norm(emb, lp["ln"], cfg.norm_eps)
    H = cfg.n_heads
    gates = common.matmul(x, lp["mixer"]["w_gates"].reshape(cfg.d_model, -1))
    i_pre = gates.reshape(B, -1, 4, H, cfg.d_model // H)[:, :, 1]
    out["slstm_input_gate"] = {
        "std": float(i_pre.std()),
        "max_above_head_mean": float(
            (i_pre - i_pre.mean(dim=-1, keepdim=True)).max()),
        "float32_exp_overflows_past": 88.72}
    return out


def cross_logit_std(torch, model, prompts, image_embeds) -> float:
    """The std of the first cross block's attention logits (q k /
    sqrt(hd)) between ``prompts``' embeddings and the projected image
    tokens: the scale the reference's init gives them."""
    from repro_torch.models import attention, common
    cfg = model.cfg
    cp = model.cross[0]
    h = torch.nn.functional.embedding(prompts, model.embed)
    q = attention._proj(common.rms_norm(h, cp["ln1"], cfg.norm_eps),
                        cp["attn"]["wq"])
    img = common.matmul(image_embeds, model.img_proj)
    k = attention._proj(img, cp["attn"]["wk"]).repeat_interleave(
        cfg.n_heads // cfg.n_kv_heads, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) \
        / cfg.resolved_head_dim ** 0.5
    return float(logits.std())


def family_check(torch, serve, lm, moe, model, cut_spec, prompts, extra,
                 gen: int, tol: float) -> dict:
    """The cut of one block of each kind (the same tensors), at capacity
    for every MoE token: decode against the forward held to the bar
    (``tol`` or ``LMF_FLOOR_FACTOR`` x the cut's forward floor, the
    larger), greedy tokens equal but for ties; where an MoE cut passes the
    bar at one position only, whether the router's top-k set differs
    there; the fault control past the bar.  The record is emitted before
    the checks.  xlstm's cut is reported (its sLSTM overflows at full
    width) and its blocks held alone."""
    keep, replace = cut_spec
    cut = family_cut(lm, model, keep, **replace)
    is_moe = cut.cfg.family == "moe"
    n_moe = len(cut.layers) if is_moe else 0
    with RouterLog(moe) as log:
        _, c = decode_vs_forward(torch, serve, cut, prompts, gen,
                                 extra=extra, whole=True, bar=tol)
    tag = cut.cfg.name
    out = {"stacks": keep, "config": replace, "tolerance": tol, "check": c}
    if cut.cfg.family == "vlm":
        out["cross_attention_logit_std"] = cross_logit_std(
            torch, cut, prompts[:, :256], extra["image_embeds"])
    over, bar = c.pop("over_bar"), c["bar"]
    if cut.cfg.family == "ssm":
        emit({"phase": "lm_families_cut", "arch": tag, **out})
        check(c["nonfinite_same_positions"],
              f"lm_families: {tag} cut: decode and forward are not finite "
              f"at different positions: {c}")
        return out
    if is_moe and len(over) == 1:
        row, step = over[0]
        c["router_sets_differ_at_worst"] = log.sets_differ(
            n_moe, prompts.shape[1], row, step)
    del log
    tie = len(over) == 1 and bool(c.get("router_sets_differ_at_worst"))
    p0 = prompts.shape[1] - gen     # B x p0 tokens fill whole MoE groups
    want = cut(prompts, **extra)[0][:, p0]
    out["fault_control"] = fault = family_fault(torch, lm, cut, prompts,
                                                extra, want, p0)
    emit({"phase": "lm_families_cut", "arch": tag, **out})
    check(c["nonfinite_decode"] == c["nonfinite_forward"] == 0,
          f"lm_families: {tag} cut: non-finite logits {c}")
    check(c["decode_vs_forward_rel_err"] <= bar or tie,
          f"lm_families: {tag} cut: decode logits "
          f"{c['decode_vs_forward_rel_err']} of the largest |logit| off the "
          f"full forward at (row, step) {over} (bar {bar}; router sets "
          f"differ there: {c.get('router_sets_differ_at_worst')})")
    check(not c["greedy_differs_not_tie"],
          f"lm_families: {tag} cut: greedy tokens differ from the "
          f"forward's argmax at (row, step) {c['greedy_differs_not_tie']}")
    check(fault["right"] <= bar < fault["off_by_one"],
          f"lm_families: {tag}: the fault control does not separate: "
          f"{fault} (bar {bar})")
    return out


def lm_families_phase(np, torch, dev, card, report, parity) -> tuple:
    """The LM template's moe (deepseek-v2-lite-16b at full width, 9 of its
    27 layers, mixtral-8x7b at 8 of its 32 layers), hybrid (zamba2-1.2b), ssm
    (xlstm-1.3b), vlm (llama-3.2-vision-11b) and audio (whisper-tiny)
    families at full width on the card, one at a time: built from a seed,
    served through ``launch/serve.py``'s ``generate`` (prefill and greedy
    decode, the modality stubs drawn on the card), held against one full
    forward at full depth (reported beside the forward's own floor) and
    on a cut of one block of each kind (held, with a fault control), and
    freed.  While deepseek is on the card, the head probe of
    ``examples/lm_head_probe.py`` on its pooled features through the
    fused Jacobi fit (K5, K6), held against the CPU's.  The hybrid and
    ssm models' serve checks go through the scan kernels (each launched
    once a recurrent layer a call, no plain route), and on each the scans
    part holds its kernels against their plain versions at full width
    (``lmf_scans``).  Returns (the probe's launch counts, the scans'
    launches of the serve checks)."""
    import gc

    t_phase = time.perf_counter()
    probe_counts, names, scan_counts = None, [], {}
    for spec in LMF_MODELS:
        gc.collect()
        torch.cuda.empty_cache()
        rec, counts = lmf_model(np, torch, dev, card, report, parity,
                                scan_counts, *spec)
        emit(rec)
        names.append(spec[0])
        probe_counts = counts or probe_counts
    gc.collect()
    torch.cuda.empty_cache()
    check(sorted(scan_counts) == sorted(SCAN_NAMES),
          f"lm_families: scan kernels launched {scan_counts}")
    emit({"phase": "lm_families", "card": card, "models": names,
          "scan_launches": scan_counts,
          "phase_s": time.perf_counter() - t_phase})
    return probe_counts, scan_counts


# the scans part: each recurrence's kernel against its plain version on
# one layer's call at full width, within 1e-5 of the largest |value| of
# each output and final state (float32, the sums in another order) where
# both are finite, the non-finite positions equal; or, where the plain
# version's own float32 result is further than that from the same
# formulas in float64 on the same inputs (its floor), within twice that
# floor, with the kernel no further from float64 than the plain version
# (or 1e-5).  The mLSTM's readout at xlstm's layer 0 has such a floor:
# h up to 3.9e4 from q.C / max(|q.n|, e^-m), the plain version 3.2e-5 of
# the largest off float64 on an H100 (700 W), its state bit for bit
SCAN_TOL = 1e-5
SCAN_FLOOR_FACTOR = 2.0
SCAN_REPS = 5
# the reference's scans each kernel replaces (no Pallas kernel)
SCAN_SRC = {"ssm_scan": "src/repro/models/ssm.py:48",
            "mlstm_scan": "src/repro/models/xlstm.py:69",
            "slstm_scan": "src/repro/models/xlstm.py:242"}


def scan_cost(name: str, a) -> tuple:
    """(bytes, flops) one call of the scan ``name`` on args ``a`` needs:
    every input read once and every output written once; the flops of
    its formulas (a product, a sum, an exp or a division one each)."""
    if name == "ssm_scan":
        xh, Bm, Cm, dt, A, D, s0 = a[:7]
        B, S, H, hd = xh.shape
        ds = Bm.shape[-1]
        n_in = sum(t.numel() for t in (xh, Bm, Cm, dt, A, D, s0))
        n_out = xh.numel() + s0.numel()
        # per (b, h, t): the decay (2), x dt (hd), (x dt) B, h decay, the
        # sum, y's product and sum (5 hd ds), D x and its sum (2 hd)
        flops = B * H * S * (2 + 3 * hd + 5 * hd * ds)
    elif name == "mlstm_scan":
        q, k, v, i_pre, f_pre, (C, n, m) = a[:6]
        B, S, H, hd_k = q.shape
        hd_v = v.shape[-1]
        n_in = sum(t.numel() for t in (q, k, v, i_pre, f_pre, C, n, m))
        n_out = B * S * H * hd_v + C.numel() + n.numel() + m.numel()
        # per (b, h, t): C's update (4 hd_k hd_v) and readout (2), n's
        # update (4 hd_k) and q.n (2), the gates (~10), h (hd_v)
        flops = B * H * S * (6 * hd_k * hd_v + 6 * hd_k + hd_v + 10)
    else:
        r, (c, n, h, m), gates, steps = a[:4]
        B, _, _, H, hd_v = gates.shape
        hd_k = r.shape[2]
        n_in = r.numel() + B * steps * 4 * H * hd_v + sum(
            t.numel() for t in (c, n, h, m))
        n_out = B * steps * H * hd_v + 3 * B * H * hd_v + m.numel()
        # per (b, h, t): h r (8 hd_k hd_v), the gates' sums (4 hd_v), the
        # means (2 hd_v), the cell's elementwise work (~14 hd_v)
        flops = B * H * steps * (8 * hd_k * hd_v + 20 * hd_v)
    return 4.0 * (n_in + n_out), float(flops)


def scan_one_chain(name: str, a) -> tuple:
    """The args of the same call cut to one (batch row, head): one chain
    of the scan's steps, alone on the card."""
    def c(t):
        return t.contiguous()
    if name == "ssm_scan":
        xh, Bm, Cm, dt, A, D, s0 = a[:7]
        return (c(xh[:1, :, :1]), c(Bm[:1]), c(Cm[:1]), c(dt[:1, :, :1]),
                c(A[:1]), c(D[:1]), c(s0[:1, :1]))
    if name == "mlstm_scan":
        q, k, v, i_pre, f_pre, st = a[:6]
        return (c(q[:1, :, :1]), c(k[:1, :, :1]), c(v[:1, :, :1]),
                c(i_pre[:1, :, :1]), c(f_pre[:1, :, :1]),
                tuple(c(t[:1, :1]) for t in st))
    r, st, gates, steps = a[:4]
    return (c(r[:1]), tuple(c(t[:1, :1]) for t in st),
            c(gates[:1, :, :, :1]), steps)


def scan_outputs(out) -> list:
    """An ops scan's result flattened: the outputs, then the final
    state's leaves."""
    y, st = out
    return [y, *(st if isinstance(st, tuple) else (st,))]


def scan_err(torch, got, want) -> tuple:
    """(the largest |difference| over the positions where both are
    finite, the same over each tensor's largest finite |value|, the
    largest of those relative errors, whether the non-finite positions
    are equal) of two flattened results."""
    worst_abs, worst_rel, same = 0.0, 0.0, True
    for g, w in zip(got, want):
        fin_g, fin_w = torch.isfinite(g), torch.isfinite(w)
        same = same and bool(torch.equal(fin_g, fin_w))
        both = fin_g & fin_w
        if not bool(both.any()):
            continue
        d = float((g - w).abs()[both].max())
        worst_abs = max(worst_abs, d)
        worst_rel = max(worst_rel, d / max(float(w.abs()[both].max()),
                                           1e-30))
    return worst_abs, worst_rel, same


def scan_float64(torch, x):
    """``x`` (a tensor, a tuple of them, or anything else) in float64."""
    if isinstance(x, tuple):
        return tuple(scan_float64(torch, t) for t in x)
    return x.double() if torch.is_tensor(x) and x.is_floating_point() else x


def scan_off_float64(torch, got, want64) -> float:
    """The largest |got - want64| over each tensor's largest |want64|,
    where both are finite (float64 overflows nowhere float32 does)."""
    worst = 0.0
    for g, w in zip(got, want64):
        g = g.double()
        both = torch.isfinite(g) & torch.isfinite(w)
        if bool(both.any()):
            worst = max(worst, float((g - w).abs()[both].max()
                                     / w.abs()[both].max().clamp_min(1e-300)))
    return worst


def lmf_scans(np, torch, model, cfg, prompts, report, parity) -> dict:
    """The scans part, on the model on the card: layer 0's recurrent
    mixers on the model's normed embeddings of the prompts (the sLSTM's
    scaled by ``LMF_SLSTM_INPUT_SCALE``: its own inputs overflow it, as in
    the reference), their scans' arguments captured; each kernel (its
    wrapper's ``launch``) against its plain version on the card at those
    arguments, timed beside its bound and beside the same kernel on one
    (batch row, head), its dependency chain alone on the card."""
    from repro_torch.kernels import mlstm_scan as mlstm_k
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import slstm_scan as slstm_k
    from repro_torch.kernels import ssm_scan as ssm_k
    from repro_torch.models import common, ssm, xlstm

    emb = torch.nn.functional.embedding(prompts, model.embed)
    if cfg.family == "hybrid":
        lp = model.layers[0]
        blocks = (("ssm_scan", ssm.mamba_full, lp, 1.0),)
    else:
        blocks = (("mlstm_scan", xlstm.mlstm_apply, model.layers[0], 1.0),
                  ("slstm_scan", xlstm.slstm_apply, model.slstm[0],
                   LMF_SLSTM_INPUT_SCALE))
    kern = {"ssm_scan": ssm_k.launch, "mlstm_scan": mlstm_k.launch,
            "slstm_scan": slstm_k.launch}
    plain = {"ssm_scan": ref.ssm_scan, "mlstm_scan": ref.mlstm_scan,
             "slstm_scan": ref.slstm_scan}
    out = {}
    for name, apply_fn, lp, scale in blocks:
        x = common.rms_norm(emb, lp["ln"], cfg.norm_eps) * scale
        with torch.no_grad(), ScanWatch(torch, ops, capture=True) as cap:
            apply_fn(lp["mixer"], x, cfg)
        a, kw = cap.args[name]
        kw = {k: v for k, v in kw.items() if k != "out"}
        del x
        got = scan_outputs(kern[name](*a, **kw))
        torch.cuda.synchronize()
        plain_ms, want = plain_call(torch, lambda: plain[name](*a, **kw))
        want = scan_outputs(want)
        err, rel, same = scan_err(torch, got, want)
        # the plain version's own float32 floor, against its formulas in
        # float64 on the same inputs
        want64 = scan_outputs(plain[name](*scan_float64(torch, a), **{
            k: scan_float64(torch, v) for k, v in kw.items()}))
        floor64 = scan_off_float64(torch, want, want64)
        kern64 = scan_off_float64(torch, got, want64)
        del want64
        bar = max(SCAN_TOL, SCAN_FLOOR_FACTOR * floor64)
        parity[name] = rel
        nonfinite = sum(int((~torch.isfinite(w)).sum()) for w in want)
        check(same and rel <= bar and kern64 <= max(SCAN_TOL, floor64),
              f"scans: {name}: kernel {rel} of the largest |value| off its "
              f"plain version (bar {bar}), {kern64} off float64 (the plain "
              f"version {floor64}), non-finite positions equal: {same}")
        ms = time_ms(torch, lambda: kern[name](*a, **kw), SCAN_REPS)
        one = scan_one_chain(name, a)
        floor = time_ms(torch, lambda: kern[name](*one, **kw), SCAN_REPS)
        by, fl = scan_cost(name, a)
        b_ms, b_by = bound_ms(by, fl)
        steps = scan_steps(name, a)
        shapes = {k: list(t.shape) for k, t in zip(
            ("x", "B", "C", "dt") if name == "ssm_scan" else
            ("q", "k", "v", "i") if name == "mlstm_scan" else
            ("r", "state", "gates"), a) if torch.is_tensor(t)}
        rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   share_of_bound=b_ms / ms, library_ms=None,
                   max_abs_err=err, max_rel_err=rel, bar=bar,
                   plain_off_float64=floor64, kernel_off_float64=kern64,
                   nonfinite_same_positions=same, nonfinite_plain=nonfinite,
                   bytes=by, flops=fl,
                   bytes_bound_ms=by / H100_BYTES_PER_S * 1e3,
                   flops_bound_ms=fl / H100_FP32_FLOPS * 1e3,
                   dependency_floor_ms=floor,
                   share_of_dependency_floor=floor / ms,
                   dependency_steps=steps, step_us=ms * 1e3 / steps,
                   floor_step_us=floor * 1e3 / steps,
                   plain_over_kernel=plain_ms / ms, shapes=shapes,
                   input_scale=scale)
        if name == "slstm_scan":
            rec["cluster"] = dict(zip(("columns", "blocks"),
                                      slstm_k.plan(a[2].shape[-1])))
        report[name] = out[name] = rec
        del got, want, a, kw, one, cap
        torch.cuda.empty_cache()
    return out


def recurrent_layers(cfg) -> dict:
    """{scan: the layers of ``cfg`` that call it once a forward}."""
    if cfg.family == "hybrid":
        return {"ssm_scan": cfg.n_layers}
    if cfg.family == "ssm":
        groups = cfg.n_layers // cfg.slstm_period
        return {"mlstm_scan": groups * (cfg.slstm_period - 1),
                "slstm_scan": groups}
    return {}


def lmf_model(np, torch, dev, card, report, parity, scan_counts, name,
              keep_layers, n_ref, prompt_len, keep, replace) -> tuple:
    """One model of the ``lm_families`` phase: (its record, the probe's
    launch counts or None).  The scans' launches of its serve check go
    into ``scan_counts``, the scans part's records into ``report`` and
    ``parity``.  Everything it put on the card is freed when it
    returns."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import common, lm, moe, xlstm

    t_model = time.perf_counter()
    free_b, total_b = torch.cuda.mem_get_info()
    full_cfg = get_arch(name)
    cfg = full_cfg if keep_layers is None \
        else full_cfg.replace(n_layers=keep_layers)
    n_params = common.param_count(lm.param_defs(cfg))
    check(n_params == n_ref, f"lm_families: {name}: {n_params} "
          f"parameters, the reference counts {n_ref}")
    print(f"lm_families: {name}: {free_b / 1e9:.2f} of "
          f"{total_b / 1e9:.2f} GB free before the build", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.build_model(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = list(model.parameters())
    check(sum(p.numel() for p in params) == n_params
          and all(p.device == dev for p in params),
          f"lm_families: {name}: the model's parameters are not the "
          "config's, on the card")
    weight_gb = sum(p.numel() * p.element_size() for p in params) / 1e9
    del params
    rec = {"phase": "lm_families_model", "arch": name, "card": card,
           "family": cfg.family, "params": n_params,
           "weight_gb": weight_gb, "weights_dtype": "float32",
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "free_gb_before": free_b / 1e9, "init_s": init_s,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "batch": LMF_BATCH, "prompt_len": prompt_len, "gen": LMF_GEN}
    if keep_layers is not None:
        rec["reduced"] = {"n_layers": [full_cfg.n_layers, keep_layers],
                          "full_params": common.param_count(
                              lm.param_defs(full_cfg)),
                          "why": LMF_REDUCED_WHY[name]}
    gen_t = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab_size, (LMF_BATCH, prompt_len),
                            device=dev, generator=gen_t)
    extra = serve.modality_inputs(cfg, LMF_BATCH, gen_t)
    tol = LMF_TOL.get(name, LMF_DEFAULT_TOL)
    keys = ("prefill_s", "prefill_tok_per_s", "decode_s", "decode_steps",
            "decode_ms_per_step", "decode_tok_per_s")

    # ---- serve at the default capacity (MoE: tokens may drop)
    if cfg.family == "moe":
        torch.cuda.reset_peak_memory_stats()
        served = serve.generate(model, prompts, LMF_GEN, extra=extra)
        rec["serve"] = {k: served[k] for k in keys}
        rec["serve"].update(
            first_tokens=served["tokens"][0][:8],
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            capacity_factor=moe.CAPACITY_FACTOR)
    # ---- the check at full depth, at capacity for every token (for the
    # other families its generate is the serve record too, with the scan
    # kernels' seconds inside its prefill)
    old_cap = moe.CAPACITY_FACTOR
    moe.CAPACITY_FACTOR = LMF_NO_DROP
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with ScanWatch(torch, ops, timed=True) as scans:
            served, full = decode_vs_forward(
                torch, serve, model, prompts, LMF_GEN, extra=extra,
                whole=True)
        launched = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        if cfg.family != "moe":
            rec["serve"] = {k: served[k] for k in keys}
            rec["serve"].update(first_tokens=served["tokens"][0][:8],
                                peak_gb_with_check=peak)
        if cfg.family in ("hybrid", "ssm"):
            scan_s, n_scans = scans.seconds(prompt_len)
            rec["serve"]["prefill_scans"] = {
                "scan_s": scan_s, "scans": n_scans,
                "share_of_prefill": scan_s / served["prefill_s"],
                "steps_a_scan": prompt_len, "route": "kernels"}
            rec["serve"]["plain_loops_before"] = {
                "prefill_s": PLAIN_LOOP_RECURRENT[name]["prefill_s"],
                "decode_ms_per_step_range":
                    PLAIN_LOOP_RECURRENT["decode_ms_per_step_range"]}
            # a prefill, the decode steps, the forward and row 0's
            calls = 1 + served["decode_steps"] + 2
            rec["scan_launches"] = scan_gates(
                f"lm_families: {name}", launched, scans.card_calls, False,
                {k: n * calls for k, n in recurrent_layers(cfg).items()})
            scan_counts.update({k: launched[k] for k in SCAN_NAMES
                                if launched[k]})
        del scans
        check(full["nonfinite_same_positions"],
              f"lm_families: {name}: decode and forward are not finite at "
              f"different positions: {full}")
        check(cfg.family == "ssm" or (
            full["nonfinite_decode"] == 0 and bool(np.isfinite(
                [full["decode_vs_forward_rel_err"],
                 full["max_abs_logit"]]).all())),
              f"lm_families: {name}: non-finite logits {full}")
        rec["full_depth"] = full
        rec["cut"] = family_check(torch, serve, lm, moe, model,
                                  (keep, replace), prompts, extra,
                                  LMF_GEN, tol)
        if cfg.family == "ssm":
            rec["blocks"] = xlstm_block_checks(torch, xlstm, common, model,
                                               prompts, LMF_GEN, tol)
        if cfg.family in ("hybrid", "ssm"):
            rec["scans"] = lmf_scans(np, torch, model, cfg, prompts, report,
                                     parity)
            emit({"phase": "scans", "arch": name, "card": card,
                  "tolerance": SCAN_TOL, **rec["scans"]})
    finally:
        moe.CAPACITY_FACTOR = old_cap
    counts = None
    if name == "deepseek-v2-lite-16b":
        counts, rec["probe"] = lmf_probe(np, torch, dev, model, cfg)
    rec["model_s"] = time.perf_counter() - t_model
    return rec, counts


def lmf_probe(np, torch, dev, model, cfg) -> tuple:
    """examples/lm_head_probe.py's class-conditional token task on the
    model's mean-pooled features, fitted by the fused Jacobi superstep
    (K5 ``stats_gram_solve``, K6 ``margin_ls``) on the card and on the
    CPU."""
    from repro_torch.core import head_probe
    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.kernels import ops

    rng = np.random.default_rng(SEED)
    V = cfg.vocab_size
    labels = rng.choice([-1.0, 1.0], LMF_PROBE_N).astype(np.float32)
    tokens = np.where(
        labels[:, None] > 0,
        rng.integers(0, V // 2, (LMF_PROBE_N, LMF_PROBE_SEQ)),
        rng.integers(V // 2, V, (LMF_PROBE_N, LMF_PROBE_SEQ)))
    tok = torch.from_numpy(tokens).to(dev)
    t0 = time.perf_counter()
    feats = head_probe.extract_features(
        lambda m, t: m(t, return_hidden=True)[0], model,
        tok.split(PROBE_BATCH))
    torch.cuda.synchronize()
    feature_s = time.perf_counter() - t0
    check(tuple(feats.shape) == (LMF_PROBE_N, cfg.d_model)
          and feats.device == dev and bool(torch.isfinite(feats).all()),
          f"lm_families: probe features {tuple(feats.shape)} on "
          f"{feats.device}: not finite, or not on the card")
    n_tr = LMF_PROBE_TRAIN
    config = DGLMNETConfig(lam1=0.05, lam2=0.05, tile_size=256,
                           coupling="jacobi", fuse_superstep=True,
                           max_outer=40)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = head_probe.fit_probe(feats[:n_tr], labels[:n_tr], config)
    fit_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    probe_counts = {k: counts[k] for k in ("stats_gram_solve",
                                           "margin_ls")}
    check(all(v > 0 for v in probe_counts.values()),
          f"lm_families: the probe fit did not launch K5 and K6: {counts}")
    check(not any(v for k, v in counts.items() if k.endswith("/plain")),
          f"lm_families: the probe fit took a plain route: {counts}")
    p = head_probe.predict_proba(feats[n_tr:], res.beta).cpu().numpy()
    acc = float(((p > 0.5) == (labels[n_tr:] > 0)).mean())
    t0 = time.perf_counter()
    res_cpu = head_probe.fit_probe(feats[:n_tr].cpu(), labels[:n_tr],
                                   config, device="cpu")
    cpu_fit_s = time.perf_counter() - t0
    agree = probe_agreement(np, res, res_cpu)
    for k in ("alpha_card", "alpha_cpu"):
        agree.pop(k)
    return probe_counts, {
        "n": LMF_PROBE_N, "seq": LMF_PROBE_SEQ, "train": n_tr,
        "features_shape": list(feats.shape), "feature_s": feature_s,
        "feature_tok_per_s": LMF_PROBE_N * LMF_PROBE_SEQ / feature_s,
        "config": "tile 256, jacobi, fused", "fit_s": fit_s,
        "n_iter": res.n_iter, "f": res.history["f"][-1],
        "nnz": int((res.beta != 0).sum()), "p": int(res.beta.size),
        "launches": probe_counts, "all_launches": {
            k: v for k, v in counts.items() if v},
        "test_accuracy": acc, "cpu_fit_s": cpu_fit_s,
        "card_vs_cpu": agree}


# ---------------------------------------------------------------- train

TRAIN_ARCH = "phi4-mini-3.8b"
TRAIN_LAYERS = 4                  # of 32: 71.2 GB of state do not fit,
#                                   and 16 layers' save, then 8 layers'
#                                   beside train_dist's six families, kept
#                                   the run past its 900 s
TRAIN_LAYERS_SMALL_DISK = 2       # if the disk cannot hold the checkpoint
TRAIN_PARAMS = 1_631_874_048      # the reference's count at 4 layers
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 6
FLASH_BWD_TOL = 1e-4              # of each gradient's largest |entry|
# examples/train_lm.py's config and the reference's bars
LEARN_REPLACE = dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
                     head_dim=32, d_ff=512, vocab_size=2048)
LEARN_BATCH, LEARN_SEQ, LEARN_STEPS, LEARN_CUT = 8, 128, 200, 100
LEARN_DROP = 0.1                  # tests/test_system.py: mean of the last
#                                   (here 10) below the first by 0.1
RESUME_RTOL, RESUME_ATOL = 2e-4, 2e-5   # tests/test_checkpoint.py
# card against CPU: tests/test_torch_train_archs.py's bars
STEP_LOSS_TOL, STEP_GNORM_TOL, STEP_GRAD_TOL = 1e-5, 1e-4, 1e-4
STEP_PARAM_ATOL, STEP_FLOOR = 1e-7, 1e-5


def leaf_prints(torch, params: dict) -> dict:
    """{name: (float64 sum, float64 norm)} of each parameter: a leaf whose
    print changes has moved."""
    with torch.no_grad():
        return {k: torch.stack([p.sum(dtype=torch.float64),
                                torch.linalg.vector_norm(
                                    p, dtype=torch.float64)])
                for k, p in params.items()}


def states_equal(torch, a: tuple, b: tuple) -> dict:
    """Bit-for-bit comparison of two (params, opt_state) pairs: the count
    of leaves that differ in each part."""
    pa, oa = a
    pb, ob = b
    return {"params": sum(not torch.equal(pa[k], pb[k]) for k in pa),
            "m": sum(not torch.equal(oa.m[k], ob.m[k]) for k in pa),
            "v": sum(not torch.equal(oa.v[k], ob.v[k]) for k in pa),
            "count": int(not torch.equal(oa.count, ob.count)),
            "leaves": len(pa)}


def train_full_width(np, torch, dev, card) -> dict:
    """phi4-mini-3.8b at full width (4 of 32 layers, float32, remat) for
    6 steps through ``runtime.trainer.Trainer``, its checkpoint restored
    in a fresh trainer bit for bit, one more step from each state."""
    import shutil

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import common, lm
    from repro_torch.optim import adamw
    from repro_torch.roofline import model as roof
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.timing import timed

    ckpt_root = tempfile.mkdtemp(prefix="chip-smoke-train-")
    free_disk = shutil.disk_usage(ckpt_root).free
    full = get_arch(TRAIN_ARCH)
    layers = TRAIN_LAYERS
    state_bytes = 3 * 4 * common.param_count(lm.param_defs(
        full.replace(n_layers=layers)))
    if free_disk < 1.2 * state_bytes:
        layers = TRAIN_LAYERS_SMALL_DISK
    cfg = full.replace(n_layers=layers, dtype="float32", remat=True,
                       attn_impl="flash")
    n_params = common.param_count(lm.param_defs(cfg))
    check(layers != TRAIN_LAYERS or n_params == TRAIN_PARAMS,
          f"train: {n_params} parameters at {layers} layers, the reference "
          f"counts {TRAIN_PARAMS}")
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=1,
                                total_steps=TRAIN_STEPS)
    log_path = pathlib.Path(ckpt_root) / "train.jsonl"
    tcfg = TrainerConfig(steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
                         ckpt_dir=ckpt_root, keep_last=1, async_save=True,
                         log_path=str(log_path), seed=SEED,
                         batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    rec = {"arch": cfg.name, "card": card, "n_layers": layers,
           "reduced": {"n_layers": [full.n_layers, layers],
                       "why": "32 layers' parameters, gradients and AdamW "
                              "moments in float32 take 71.2 GB, and 16 "
                              "layers' save, then 8 layers' beside "
                              "train_dist's six families, kept "
                              "chip_smoke.py past 900 s"
                              + ("" if layers == TRAIN_LAYERS else
                                 "; the disk held too little for 4 "
                                 "layers' checkpoint")},
           "params": n_params, "dtype": "float32", "remat": True,
           "attn_impl": "flash", "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "free_disk_gb": free_disk / 1e9}

    trainer = Trainer(cfg, opt_cfg, tcfg, device=dev)
    params0, _, _ = trainer.init_state()
    before = leaf_prints(torch, params0)
    del params0
    trainer.model = trainer.train_step = None
    # the save's two parts: the copy to the host (save) and the write
    saves = {}
    mgr = trainer.ckpt
    for part in ("save", "wait"):
        def wrapped(*a, _fn=getattr(mgr, part), _part=part, **k):
            out, s = timed(_fn, *a, **k)
            saves[_part] = saves.get(_part, 0.0) + s
            return out
        setattr(mgr, part, wrapped)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (params, opt_state, losses), run_s = timed(trainer.run)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = [json.loads(ln) for ln in log_path.read_text().splitlines()]
    for r in hist:
        check(bool(np.isfinite([r["loss"], r["grad_norm"]]).all()),
              f"train: step {r['step']}: loss or grad norm not finite {r}")
    after = leaf_prints(torch, params)
    still = [k for k in params if torch.equal(before[k], after[k])]
    check(not still, f"train: leaves that did not move: {still[:8]}")
    step_s = [r["step_s"] for r in hist]
    warm = float(np.median(step_s[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = roof.model_flops(cfg, ShapeSpec("train", TRAIN_SEQ,
                                            TRAIN_BATCH, "train"))
    ckpt_dir = pathlib.Path(ckpt_root) / f"ckpt_{TRAIN_STEPS}"
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.iterdir())
    save_s = saves.get("save", 0.0) + saves.get("wait", 0.0)
    rec.update(
        steps=hist, run_s=run_s, step_s_median_after_first=warm,
        first_step_s=step_s[0], tokens_per_s=tokens / warm,
        model_flops_per_step=flops, model_tflops_per_s=flops / warm / 1e12,
        share_of_fp32_peak=flops / warm / H100_FP32_FLOPS,
        peak_named="PEAK_FLOPS_FP32 (launch/mesh.py), 67 TFLOP/s",
        peak_gb=peak_gb, leaves=len(params), leaves_moved=len(params),
        save={"host_copy_s": saves.get("save"),
              "write_wait_s": saves.get("wait"), "total_s": save_s,
              "bytes": ckpt_bytes, "gb_per_s": ckpt_bytes / save_s / 1e9})

    # ---- a fresh trainer on the same directory
    torch.cuda.empty_cache()
    fresh = Trainer(cfg, opt_cfg, tcfg, device=dev)
    (restored, restore_s) = timed(fresh.restore_or_init)
    p2, o2, start = restored
    check(start == TRAIN_STEPS, f"train: restored next_step {start}")
    diff = states_equal(torch, (params, opt_state), (p2, o2))
    check(not any(v for k, v in diff.items() if k != "leaves"),
          f"train: the restored state differs from the saved one: {diff}")
    # one more step from each state; the first trainer's moments wait on
    # the host meanwhile (both states and a step do not fit the card)
    batch = trainer.pipeline.batch_at(TRAIN_STEPS)
    host_m = {k: t.cpu() for k, t in opt_state.m.items()}
    host_v = {k: t.cpu() for k, t in opt_state.v.items()}
    for k in host_m:
        opt_state.m[k] = opt_state.v[k] = None
    torch.cuda.empty_cache()
    _, m_restored = fresh.train_step(o2, batch)
    loss_restored = float(m_restored["loss"])
    del fresh, p2, o2, restored
    torch.cuda.empty_cache()
    for k in host_m:
        opt_state.m[k] = host_m[k].to(dev)
        opt_state.v[k] = host_v[k].to(dev)
    del host_m, host_v
    (_, m_first), step_mem = step_memory(
        torch, lambda: trainer.train_step(opt_state, batch),
        card_bytes_of(torch, params, opt_state))
    loss_first = float(m_first["loss"])
    # that step against its traced dry-run on one card
    traced = traced_train_step(cfg, TRAIN_BATCH, TRAIN_SEQ, (1, 1))
    rec["traced_peak"] = peak_against_trace("train", step_mem, traced)
    rec["traced_peak"]["trace_s"] = traced["trace_s"]
    emit({"phase": "train_traced", **rec["traced_peak"]})
    check(abs(loss_restored - loss_first) <= RESUME_RTOL * abs(loss_first),
          f"train: the step after the restore gives {loss_restored}, the "
          f"first trainer's {loss_first}")
    rec["restore"] = {"restore_s": restore_s, "next_step": start,
                      "leaves_differing": diff,
                      "loss_step7_restored": loss_restored,
                      "loss_step7_first": loss_first,
                      "bits_equal": loss_restored == loss_first}
    del trainer, params, opt_state
    shutil.rmtree(ckpt_root, ignore_errors=True)
    return rec


def flash_case(np, torch, common, dev, *, B, S, H, Hkv, hd, window=None,
               softcap=None, chunk=1024, seed=0) -> dict:
    """dq, dk, dv of ``FlashAttention`` against autograd through the plain
    chunked forward on the card; the fault control feeds the backward the
    log-sum-exp one chunk stale (the running one before the last chunk)."""
    import math

    from repro_torch.timing import timed

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g, device=dev)
    k = torch.randn((B, S, Hkv, hd), generator=g, device=dev)
    v = torch.randn((B, S, Hkv, hd), generator=g, device=dev)
    dout = torch.randn((B, H, S, hd), generator=g, device=dev)
    scale = 1.0 / math.sqrt(hd)
    win = common._BIG_WINDOW if window is None else window
    args = (True, 0, chunk, softcap, scale)

    def function_grads():
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        out = common.FlashAttention.apply(qq, kk, vv, *args, win)
        return torch.autograd.grad(out, (qq, kk, vv), dout)

    def plain_grads():
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        out, _ = common._flash_fwd(*args, qq, kk, vv, win)
        return torch.autograd.grad(out, (qq, kk, vv), dout)

    got, fn_s = timed(function_grads)
    got, fn_s = timed(function_grads)
    want, plain_s = timed(plain_grads)
    want, plain_s = timed(plain_grads)
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(got, want)]
    with torch.no_grad():
        out, _ = common._flash_fwd(*args, q, k, v, win)
        _, stale = common._flash_fwd(*args, q, k[:, :-chunk], v[:, :-chunk],
                                     win)
        bad = common._flash_bwd(*args, q, k, v, win, dout, out, stale)
    # a stale lse can leave a query no key of its chunks: inf and NaN
    # there, which exceed any bar
    fault = [float((a - b).abs().max() / b.abs().max())
             for a, b in zip(bad, want)]
    fault = [x if np.isfinite(x) else "non-finite" for x in fault]
    return {"shape": {"B": B, "S": S, "H": H, "Hkv": Hkv, "hd": hd,
                      "window": window, "softcap": softcap, "chunk": chunk},
            "rel_err_dq_dk_dv": errs, "fault_stale_lse": fault,
            "function_fwd_bwd_ms": fn_s * 1e3,
            "plain_autograd_ms": plain_s * 1e3}


def train_flash(np, torch, dev, card) -> dict:
    """The flash backward at phi4-mini's and gemma3-12b's head shapes."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import common

    phi, gem = get_arch(TRAIN_ARCH), get_arch("gemma3-12b")
    cases = {
        "phi4_causal": dict(H=phi.n_heads, Hkv=phi.n_kv_heads,
                            hd=phi.resolved_head_dim),
        "gemma3_local_window": dict(H=gem.n_heads, Hkv=gem.n_kv_heads,
                                    hd=gem.resolved_head_dim,
                                    window=gem.sliding_window,
                                    softcap=gem.attn_softcap),
        # no config of the registry sets a softcap: gemma2's 50 on
        # gemma3's heads, so the (1 - t^2) factor runs on the card
        "gemma3_heads_softcap_50": dict(H=gem.n_heads, Hkv=gem.n_kv_heads,
                                        hd=gem.resolved_head_dim,
                                        softcap=50.0),
    }
    out = {"card": card, "bar": FLASH_BWD_TOL}
    for i, (tag, kw) in enumerate(cases.items()):
        r = flash_case(np, torch, common, dev, B=TRAIN_BATCH, S=TRAIN_SEQ,
                       seed=SEED + i, **kw)
        check(max(r["rel_err_dq_dk_dv"]) <= FLASH_BWD_TOL,
              f"train: flash backward {tag}: {r['rel_err_dq_dk_dv']} of the "
              f"largest entry (bar {FLASH_BWD_TOL})")
        check(all(x == "non-finite" or x > FLASH_BWD_TOL
                  for x in r["fault_stale_lse"]),
              f"train: flash backward {tag}: a stale lse passes the bar "
              f"{r['fault_stale_lse']}")
        out[tag] = r
        torch.cuda.empty_cache()
    return out


def train_learning(np, torch, dev, card) -> dict:
    """examples/train_lm.py's config: 200 steps learn; the straight run's
    checkpoint at step 100, resumed by a fresh trainer, gives the straight
    run's last 100 losses."""
    import shutil

    from repro_torch.configs.registry import smoke_variant
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.timing import timed

    cfg = smoke_variant(TRAIN_ARCH).replace(**LEARN_REPLACE)
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20,
                                total_steps=LEARN_STEPS)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-learn-") as d:
        def run(sub, steps):
            t = Trainer(cfg, opt_cfg, TrainerConfig(
                steps=steps, ckpt_every=50, ckpt_dir=f"{d}/{sub}",
                keep_last=LEARN_STEPS // 50, batch=LEARN_BATCH,
                seq_len=LEARN_SEQ, seed=SEED), device=dev)
            return t.run()[2]

        straight, straight_s = timed(run, "straight", LEARN_STEPS)
        # the cut: a directory holding the straight run's step-100 save
        shutil.copytree(f"{d}/straight/ckpt_{LEARN_CUT}",
                        f"{d}/cut/ckpt_{LEARN_CUT}")
        resumed, resumed_s = timed(run, "cut", LEARN_STEPS)
    first, last = float(np.mean(straight[:10])), float(np.mean(straight[-10:]))
    check(bool(np.isfinite(straight).all()) and last < first - LEARN_DROP,
          f"train: examples/train_lm.py's config did not learn: first 10 "
          f"{first}, last 10 {last}")
    want = np.asarray(straight[LEARN_CUT:])
    got = np.asarray(resumed)
    err = np.abs(got - want)
    check(len(got) == len(want) and bool(
        (err <= RESUME_ATOL + RESUME_RTOL * np.abs(want)).all()),
          f"train: the resumed run differs from the straight one by "
          f"{err.max()}")
    return {"card": card, "config": {**LEARN_REPLACE, "batch": LEARN_BATCH,
                                     "seq_len": LEARN_SEQ},
            "steps": LEARN_STEPS, "first10": first, "last10": last,
            "drop": first - last, "straight_s": straight_s,
            "ms_per_step": straight_s / LEARN_STEPS * 1e3,
            "resume_max_abs_diff": float(err.max()),
            "resume_bits_equal": bool((err == 0).all()),
            "resumed_s": resumed_s}


def smoke_weights(np, lm, common, cfg, seed: int) -> dict:
    """numpy weights in the reference's layout for ``cfg``: N(0, 0.02^2)
    matrices, N(0, 0.1^2) vectors (tests/test_torch_train_archs.py's)."""
    rng = np.random.default_rng(seed)
    return common.unflatten({
        k: (rng.normal(size=d.shape) * (0.1 if len(d.shape) < 2 else 0.02))
        .astype(np.float32)
        for k, d in common.flatten(lm.param_defs(cfg)).items()})


def one_step(np, torch, lm, convert, adamw, cfg, tree, batch, dev):
    """(loss, grad norm, {name: gradient}, {name: updated parameter}) of
    one ``make_train_step`` step on ``dev``, on the host."""
    model = lm.build_model(cfg, state=convert.lm_params_from_numpy(
        cfg, tree, device=dev))
    step = lm.make_train_step(model, adamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=8))
    params = lm.trainable_params(model)
    _, grads = lm.loss_and_grads(model, params,
                                 lm.batch_to_device(batch, dev))
    grads = {k: g.cpu().numpy() for k, g in grads.items()}
    _, m = step(adamw.adamw_init(params), batch)
    return (float(m["loss"]), float(m["grad_norm"]), grads,
            {k: p.detach().cpu().numpy() for k, p in params.items()})


def train_card_vs_cpu(np, torch, dev, card) -> dict:
    """One ``make_train_step`` step of every architecture of the registry
    at its smoke config (vlm and audio with their modality inputs), the
    card against the CPU, by the CPU tests' bars."""
    from repro_torch import convert
    from repro_torch.configs.registry import ARCHS, smoke_variant
    from repro_torch.models import common, lm
    from repro_torch.optim import adamw

    out = {"card": card, "bars": {
        "loss": STEP_LOSS_TOL, "grad_norm": STEP_GNORM_TOL,
        "grad_leaf": STEP_GRAD_TOL, "param_atol": STEP_PARAM_ATOL}}
    for i, name in enumerate(sorted(ARCHS)):
        cfg = smoke_variant(name)
        tree = smoke_weights(np, lm, common, cfg, SEED + i)
        rng = np.random.default_rng(SEED + i)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24))
                 .astype(np.int32),
                 "targets": rng.integers(0, cfg.vocab_size, (2, 24))
                 .astype(np.int32),
                 "loss_mask": np.ones((2, 24), np.float32)}
        if cfg.family == "vlm":
            batch["image_embeds"] = rng.normal(size=(
                2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            batch["audio_embeds"] = rng.normal(size=(
                2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
        lc, gnc, gradc, pc = one_step(np, torch, lm, convert, adamw, cfg,
                                      tree, batch, dev)
        lh, gh, gradh, ph = one_step(np, torch, lm, convert, adamw, cfg,
                                     tree, batch, "cpu")
        grad_err = max(float(np.abs(gradc[k] - gradh[k]).max()
                             / max(np.abs(gradh[k]).max(), 1e-30))
                       for k in gradh)
        scale = min(1.0, 1.0 / gh)
        n_out, n_in, p_err = 0, 0, 0.0
        for k, want in ph.items():
            g = np.abs(gradh[k])
            keep = ((g > STEP_GRAD_TOL * max(g.max(), 1e-30))
                    & (g * scale > STEP_FLOOR)) \
                | ((g == 0) & (gradc[k] == 0))
            n_out += int((~keep).sum())
            n_in += int(keep.sum())
            if keep.any():
                p_err = max(p_err, float(np.abs(pc[k] - want)[keep].max()))
        r = {"loss_rel": abs(lc - lh) / abs(lh),
             "grad_norm_rel": abs(gnc - gh) / gh, "grad_leaf_rel": grad_err,
             "param_max_abs": p_err, "params_compared": n_in,
             "params_near_sign_flip": n_out}
        check(r["loss_rel"] <= STEP_LOSS_TOL
              and r["grad_norm_rel"] <= STEP_GNORM_TOL
              and grad_err <= STEP_GRAD_TOL and p_err <= STEP_PARAM_ATOL,
              f"train: {name}: the card's step against the CPU's {r}")
        out[name] = r
    return out


def train_phase(np, torch, dev, card) -> dict:
    """LM training on the card (after every phase but train_dist, each of
    which freed its memory): the full-width trainer, the flash backward,
    learning and kill-and-restart, every architecture's step against the
    CPU.  No GLM kernel lies on this path (its launch counts stay 0), and
    the recurrences' scans run their plain loops (no backward kernel
    yet): the scan kernels stay at 0, their ``/plain`` counts equal to
    the calls on the card."""
    import gc

    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    recs = {}
    with ScanWatch(torch, ops) as watch:
        for part, fn in (("train_full_width", train_full_width),
                         ("train_flash", train_flash),
                         ("train_learning", train_learning),
                         ("train_card_vs_cpu", train_card_vs_cpu)):
            t0 = time.perf_counter()
            rec = fn(np, torch, dev, card)
            rec["part_s"] = time.perf_counter() - t0
            emit({"phase": part, **rec})
            recs[part] = rec
            gc.collect()
            torch.cuda.empty_cache()
    # the recurrent smoke models' steps (train_card_vs_cpu) call the scans
    # with gradients on: the plain loop, counted, every call
    scans = scan_gates("train", ops.launch_counts(), watch.card_calls, True)
    check(all(v["card_calls"] for v in scans.values()),
          f"train: a scan was never called on the card {scans}")
    emit({"phase": "train", "card": card, "glm_kernel_launches": 0,
          "scans": scans, "phase_s": time.perf_counter() - t_phase})
    return recs


# sharded training (train_dist): phi4-mini at full width, 2 of 32 layers
TRAIN_DIST_LAYERS = 2
TRAIN_DIST_BATCH, TRAIN_DIST_SEQ, TRAIN_DIST_STEPS = 2, 512, 3
TRAIN_DIST_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=8)
TRAIN_DIST_MEM_TOL = 0.01         # requested after placement / dry-run
# a step's peak on the card (max_memory_allocated over the step, less what
# the card held beside its arguments) against the traced dry-run's
# peak_bytes_est.  Both count the same tensors: max_memory_allocated counts
# requested blocks rounded to 512 B, not the allocator's 2 MB segments, and
# cuBLAS's workspace is made before the step.  The card has read 4.6-31.8
# KB below the trace (|rel| <= 8.7e-7: small host-made scalars and the
# int32 batch); the bar is a hundred times that, so that a trace missing
# one layer's activation (~50 MB at 2 x 2,048 x 3,072 float32) fails
TRAIN_PEAK_TOL = 1e-4
TRAIN_DIST_TIMEOUT_S = 600
# (b)'s other families at full width on (1, 2): {arch: (layers or None
# for all of them, sequence length, other config fields)}; batch 2, 2
# steps.  xlstm's mLSTM by its chunkwise form (ssm_chunk): the step scan
# costs 15 s a step there (host-bound autograd over 512 steps a layer),
# the chunkwise 2.3 s; the sLSTM steps either way
TRAIN_DIST_FAMILIES = {
    "deepseek-v2-lite-16b": (2, 512, {}),       # 1 dense and 1 MoE layer
    "mixtral-8x7b": (1, 512, {}),
    "zamba2-1.2b": (2, 512, {}),                # the shared block once
    "xlstm-1.3b": (8, 512, dict(ssm_chunk=64)),     # 7 mLSTM, 1 sLSTM
    "llama-3.2-vision-11b": (5, 512, {}),       # 1 cross block
    "whisper-tiny": (None, 256, {})}
TRAIN_DIST_FAM_STEPS = 2
# the first step's parameters (where AdamW's step is not near sign(g))
# within STEP_PARAM_ATOL but where a family's first gradient is float32-
# sensitive: xlstm-1.3b's at full width moves 3.7e-8-6.9e-8 under a 1e-7
# weight perturbation, its gradient leaves 7.6e-5-1.3e-4 of their largest
# entry, and the sharded run's 1.15e-7 / 2.2e-4 (PERF.md, tools/
# xlstm_first_step.py)
TRAIN_DIST_PARAM_ATOL = {"xlstm-1.3b": 2e-7}
# serve_dist (train_dist's world, before its training): batch 2 x the
# family's train_dist sequence (phi4-mini 512, whisper's decoder 256) and
# 16 greedy tokens from the parity weights, each arch on (1, 2) against
# its single-card run; then zamba2 at batch 1 on (2, 1), its shared
# block's KV cache split on the sequence over data
SERVE_DIST_GEN = 16
SERVE_DIST_LOGIT_TOL = 1e-5       # of the largest |logit|
# float32's own control: the single run again from weights times (1 +
# 1e-7 N(0, 1)), which moves full-width logits by 7.9e-7 (whisper) to
# 3.5e-5 (xlstm) of the largest (PERF.md); where 4x it exceeds the bar,
# the bar is 4x it
SERVE_DIST_CONTROL_X = 4.0
SERVE_DIST_B1 = "zamba2-1.2b"


def train_dist_trainer(cfg, mesh, dev, ckpt_dir):
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    return Trainer(cfg, adamw.AdamWConfig(**TRAIN_DIST_OPT), TrainerConfig(
        steps=TRAIN_DIST_STEPS, ckpt_dir=ckpt_dir, seed=SEED,
        batch=TRAIN_DIST_BATCH, seq_len=TRAIN_DIST_SEQ), mesh=mesh,
        device=dev)


def parity_weights(torch, cfg, params) -> None:
    """The trainer's draw rescaled in place to N(0, 0.02^2) matrices (its
    vectors are zeros): the tests' parity weights, as the reference's init
    is chaotic in float32 (ROADMAP Queue 3 item 14).  Every rank rescales
    its blocks of the same draw, so every mesh gets the same weights."""
    import math

    from repro_torch.models import common, lm, transformer
    defs = common.flatten(lm.param_defs(cfg))
    with torch.no_grad():
        for name, p in params.items():
            parts = name.split(".")
            if parts[0] in transformer.STACKED:
                del parts[1]
            d = defs[".".join(parts)]
            if p.dim() < 2 or d.init_scale == 0.0:
                continue
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            p.mul_(0.02 / (d.init_scale / math.sqrt(max(fan_in, 1))))


def train_dist_run(torch, trainer, capture: bool = False) -> dict:
    """Weights drawn and rescaled, then ``TRAIN_DIST_STEPS`` steps: each
    step's (loss, grad norm, lr) and seconds, the memory after placement,
    the collectives recorded; with ``capture``, copies on the card of the
    first step's gradients (before it) and parameters (after it)."""
    from repro_torch.models import lm
    from repro_torch.sharding import collectives
    from repro_torch.timing import timed
    torch.cuda.reset_peak_memory_stats()
    base = requested_bytes(torch)
    params, opt, _ = trainer.init_state()
    parity_weights(torch, trainer.cfg, params)
    torch.cuda.synchronize()
    placed = requested_bytes(torch) - base
    out = {}
    if capture and trainer.layout is None:
        batch = lm.batch_to_device(trainer.pipeline.batch_at(0),
                                   trainer.device)
        _, out["grads0"] = lm.loss_and_grads(trainer.model, params, batch)
        del batch
    metrics, secs, peaks = [], [], []
    with collectives.collective_trace() as ev:
        for step in range(TRAIN_DIST_STEPS):
            if step == 1:
                # the second step alone: its peak on the card and its
                # collectives, for the traced dry-run
                peaks.append(torch.cuda.max_memory_allocated())
                n_ev = len(ev)
                ((opt, host), s), mem = step_memory(
                    torch, lambda: timed(trainer.step_at, opt, step),
                    card_bytes_of(torch, params, opt))
                out["step_memory"] = mem
                out["step_collectives"] = [list(e) for e in ev[n_ev:]]
            else:
                (opt, host), s = timed(trainer.step_at, opt, step)
            metrics.append(host)
            secs.append(s)
            if capture and step == 0:
                out["params1"] = {k: p.detach().clone()
                                  for k, p in params.items()}
    out.update(params=params, metrics=metrics, step_s=secs,
               placed_bytes=placed,
               peak_bytes=max(peaks + [torch.cuda.max_memory_allocated()]),
               collectives=[list(e) for e in ev])
    return out


def serve_dist_archs() -> list:
    """serve_dist's arch keys: phi4-mini, the five other families, and
    ``"b1"`` (``SERVE_DIST_B1`` at batch 1 on (2, 1))."""
    return [TRAIN_ARCH, *TRAIN_DIST_FAMILIES, "b1"]


def serve_dist_case(key: str):
    """(config, batch, mesh shape) of a serve_dist key: train_dist's
    configs (full width, their depth cuts)."""
    if key == "b1":
        return train_dist_family_cfg(SERVE_DIST_B1), 1, (2, 1)
    cfg = train_dist_cfg() if key == TRAIN_ARCH \
        else train_dist_family_cfg(key)
    return cfg, TRAIN_DIST_BATCH, (1, 2)


def logits_rel(torch, got, want) -> list:
    """Each step's largest |difference| of logits (B, steps, V) over the
    largest |logit| of ``want``, on the host."""
    return [float((got[:, i] - want[:, i]).abs().max()
                  / want[:, i].abs().max()) for i in range(want.shape[1])]


def serve_dist_run(torch, cfg, layout, dev, batch: int, mesh_shape,
                   control: bool = False) -> dict:
    """One serving run of ``cfg`` (``layout``: this rank's place, None on
    one card): the model drawn from ``SEED`` and rescaled to the parity
    weights, the request (``batch`` prompts of the family's train_dist
    length drawn from ``SEED + 1``, its modality stubs), the bytes
    requested by the model and a cache of the request (this rank's
    blocks) against the dry-run's count for ``mesh_shape``, then
    ``launch.serve.generate`` of ``SERVE_DIST_GEN`` tokens: its seconds,
    tokens, the logits that chose them (on the card), the collectives.
    With ``control``, the request once more from weights times (1 + 1e-7
    N(0, 1)) (a draw from ``SEED + 2``): each step's logits against the
    first run's (``control_rel``), float32's own spread."""
    import gc

    from repro_torch.launch import dryrun, serve
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import common, lm
    from repro_torch.sharding import collectives
    gc.collect()
    torch.cuda.empty_cache()
    seq = TRAIN_DIST_SEQ if cfg.name == TRAIN_ARCH \
        else TRAIN_DIST_FAMILIES[cfg.name][1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                            device=dev)
    extra = serve.modality_inputs(cfg, batch, gen)
    s_max = seq + SERVE_DIST_GEN
    torch.cuda.synchronize()
    base = requested_bytes(torch)
    model = lm.build_model(cfg, generator=torch.Generator(
        device=dev).manual_seed(SEED), layout=layout)
    parity_weights(torch, cfg, lm.trainable_params(model))
    caches = lm.init_cache(cfg, batch, s_max, device=dev, layout=layout)
    torch.cuda.synchronize()
    placed = requested_bytes(torch) - base
    del caches
    mesh = AbstractMesh(mesh_shape)
    params_a, _ = lm.abstract_state(cfg, mesh, with_opt=False)
    want = dryrun.card_bytes(params_a, mesh) + dryrun.card_bytes(
        common.abstract_params(lm.cache_specs(cfg, batch, s_max, mesh), mesh,
                               dtype=torch.float32), mesh)
    with collectives.collective_trace() as ev, torch.no_grad():
        rec = serve.generate(model, prompts, SERVE_DIST_GEN, extra=extra,
                             keep_logits=True)
    out = {"placed_bytes": placed, "dryrun_bytes": want,
           "prefill_s": rec["prefill_s"],
           "decode_ms_per_step": rec["decode_ms_per_step"],
           "tokens": rec["tokens"], "logits": rec["logits"],
           "collectives": [list(e) for e in ev]}
    if control:
        noise = torch.Generator(device=dev).manual_seed(SEED + 2)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.0 + 1e-7 * torch.randn(p.shape, generator=noise,
                                                device=dev))
            again = serve.generate(model, prompts, SERVE_DIST_GEN,
                                   extra=extra, keep_logits=True)
        out["control_rel"] = logits_rel(torch, again["logits"],
                                        rec["logits"])
        del again
    del model, rec
    return out


def serve_dist_rank(torch, spec: dict, mesh) -> dict:
    """serve_dist's part of a train_dist rank, before its training: each
    key of ``serve_dist_archs`` on its mesh (the world's (1, 2), or (2, 1)
    of the same ranks), held against its single-card run's logits and
    tokens (``<serve_ref>/<key>.pt``, written by the phase): the largest
    |difference| over the largest |logit|, the tokens' equality, the
    launch counts."""
    import gc

    from repro_torch.device import resolve_device
    from repro_torch.dist import bootstrap
    from repro_torch.kernels import ops
    from repro_torch.sharding import tensor_parallel as tp
    dev = resolve_device(None)
    meshes = {(1, 2): mesh, (2, 1): bootstrap.make_dist_mesh(2, 1)}
    ref = pathlib.Path(spec["serve_ref"])
    out = {}
    for key in serve_dist_archs():
        cfg, batch, shape = serve_dist_case(key)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with ScanWatch(torch, ops) as watch:
            r = serve_dist_run(torch, cfg, tp.Layout(meshes[shape]), dev,
                               batch, shape)
        r["scan_calls"] = watch.card_calls
        want = torch.load(ref / f"{key}.pt")
        r["logits_rel"] = logits_rel(torch, r.pop("logits").cpu(),
                                     want["logits"])
        r["tokens_equal"] = r.pop("tokens") == want["tokens"]
        r["launched"] = {k: v for k, v in ops.launch_counts().items() if v}
        r["part_s"] = time.perf_counter() - t0
        out[key] = r
        del want
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_dist_worker(spec_path: str) -> None:
    """One rank of train_dist's gloo world on the one card: first
    serve_dist's runs (``serve_dist_rank``, its record under ``serve``),
    then its trainer on the spec's mesh; the metrics, memory, collectives and launch counts
    in ``<out>/rank<r>.json``, its parameter blocks after the first step
    in ``<out>/rank<r>/<name>.npy``; then each of the spec's other
    families (``train_dist_family_run``), its record under
    ``families``."""
    sys.path.insert(0, str(REPO / "src"))
    import gc

    import numpy as np
    import torch

    from repro_torch.dist import bootstrap, faults
    from repro_torch.kernels import ops
    spec = json.loads(pathlib.Path(spec_path).read_text())
    ctx = bootstrap.initialize(backend="gloo", device=None, timeout_s=120)
    mesh = bootstrap.make_dist_mesh(*spec["mesh"])
    cfg = train_dist_cfg()
    out = pathlib.Path(spec["out"])
    serve = serve_dist_rank(torch, spec, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    with ScanWatch(torch, ops) as watch:
        r = train_dist_run(torch, train_dist_trainer(
            cfg, mesh, None, str(out / "ckpt")), capture=True)
    r["scan_calls"] = watch.card_calls
    r["serve"] = serve
    blocks = out / f"rank{ctx.process_id}"
    blocks.mkdir()
    for k, t in r.pop("params1").items():
        np.save(blocks / f"{k}.npy", t.cpu().numpy())
    r.pop("params")
    r["launched"] = {k: v for k, v in ops.launch_counts().items() if v}
    del t
    # the other families in the same world, each freed before the next
    r["families"] = {}
    for arch in spec["families"]:
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fcfg = train_dist_family_cfg(arch)
        with ScanWatch(torch, ops) as watch:
            f = train_dist_family_run(
                torch, fcfg, mesh, None, str(out / f"ckpt_{arch}"),
                out / "kept" / arch)
        f["scan_calls"] = watch.card_calls
        f["part_s"] = time.perf_counter() - t0
        f["launched"] = {k: v for k, v in ops.launch_counts().items() if v}
        r["families"][arch] = f
        del f
    (out / f"rank{ctx.process_id}.json").write_text(json.dumps(r))
    faults.guarded_barrier("chip-smoke-train-dist-exit", timeout_s=120)
    bootstrap.shutdown()


def train_dist_cfg():
    from repro_torch.configs.registry import get_arch
    return get_arch(TRAIN_ARCH).replace(
        n_layers=TRAIN_DIST_LAYERS, dtype="float32", remat=True,
        attn_impl="flash", seq_shard=True, parallelism="tp")


def requested_bytes(torch) -> int:
    """Bytes the live tensors on the card asked for: the caching
    allocator's ``requested_bytes``, without its rounding of a block up
    to the cached one it lands in (up to 1 MB a tensor in a process whose
    cache earlier models fragmented): train_dist's one measure of the
    memory after placement.  Raises where the allocator does not keep
    it."""
    stats = torch.cuda.memory_stats()
    check("requested_bytes.all.current" in stats,
          "train_dist: the caching allocator keeps no requested_bytes")
    return stats["requested_bytes.all.current"]


def card_bytes_of(torch, *trees) -> int:
    """Bytes of the distinct storages of the tensors in ``trees`` (dicts,
    lists, tuples, named tuples)."""
    seen = {}

    def walk(t):
        if torch.is_tensor(t):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    for tree in trees:
        walk(tree)
    return sum(seen.values())


def step_memory(torch, step, args_card: int):
    """``step()`` once with the card's peak reset: (its result, {"before":
    bytes allocated before it, "peak": the most allocated during it,
    "args": ``args_card``, the bytes of the step's arguments, "step_peak":
    the peak less what the card held beside the arguments})."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return out, {"before": before, "peak": peak, "args": args_card,
                 "step_peak": peak - before + args_card}


def traced_train_step(cfg, batch: int, seq: int, mesh_shape) -> dict:
    """``launch.dryrun.lower_cell`` of ``cfg`` (its arch with ``cfg``'s
    depth, dtype, remat, attention and parallelism) at ``batch`` x
    ``seq`` tokens on rank 0 of ``mesh_shape``'s dry world, traced on the
    CPU: its memory, profile (the collectives by kind among them) and
    trace seconds."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    shape = ShapeSpec(f"train_{batch}x{seq}", seq, batch, "train")
    mesh = AbstractMesh(tuple(mesh_shape))
    over = {k: getattr(cfg, k) for k in (
        "n_layers", "dtype", "remat", "attn_impl", "seq_shard",
        "parallelism", "ssm_chunk")}
    rec = dryrun.lower_cell(cfg.name, shape, mesh, overrides=over)
    check(rec["status"] == "ok", f"the traced dry-run of {cfg.name} at "
          f"{mesh_shape}: {rec.get('error', rec['status'])}")
    return {k: rec[k] for k in ("memory", "profile", "trace_s")}


def peak_against_trace(what: str, card: dict, traced: dict) -> dict:
    """The card's step peak against the traced ``peak_bytes_est`` within
    ``TRAIN_PEAK_TOL``: the record, checked."""
    want = traced["memory"]["peak_bytes_est"]
    rel = (card["step_peak"] - want) / want
    out = {"card_step_peak": card["step_peak"], "traced_peak": want,
           "rel": rel, "bar": TRAIN_PEAK_TOL, "card": card,
           "traced_memory": traced["memory"]}
    check(abs(rel) <= TRAIN_PEAK_TOL,
          f"{what}: the card's step peak {card['step_peak']} against the "
          f"traced {want} ({rel:+.3g}, bar {TRAIN_PEAK_TOL})")
    return out


def train_dist_family_cfg(arch: str):
    """(b)'s config of ``arch``: full width, its depth cut, float32, remat,
    flash attention, tensor parallel with sequence parallelism, padded
    where the reference pads for a model axis of 2 (whisper-tiny's vocab
    of 51,865 to 51,866)."""
    from repro_torch.configs.base import tp_pad_config
    from repro_torch.configs.registry import get_arch
    layers, _, extra = TRAIN_DIST_FAMILIES[arch]
    cfg = get_arch(arch)
    cfg = cfg.replace(n_layers=layers or cfg.n_layers, dtype="float32",
                      remat=True, attn_impl="flash", seq_shard=True,
                      parallelism="tp", **extra)
    return tp_pad_config(cfg, 2)[0]


def train_dist_family_batch(torch, cfg, step: int, dev) -> dict:
    """Step ``step``'s batch of (b)'s family run: ``TokenPipeline``'s rows
    (batch 2 at the family's sequence length) and, for the vlm and audio
    families, N(0, 1) image or audio embeddings drawn on the card from
    ``SEED + step`` (the same bits in every process)."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import lm
    seq = TRAIN_DIST_FAMILIES[cfg.name][1]
    batch = lm.batch_to_device(TokenPipeline(
        cfg.vocab_size, TRAIN_DIST_BATCH, seq, seed=SEED).batch_at(step),
        dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + step)
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            (TRAIN_DIST_BATCH, cfg.n_image_tokens, cfg.d_model),
            generator=gen, device=dev)
    if cfg.family == "audio":
        batch["audio_embeds"] = torch.randn(
            (TRAIN_DIST_BATCH, cfg.n_audio_frames, cfg.d_model),
            generator=gen, device=dev)
    return batch


def router_margin(torch, model, batch) -> float | None:
    """The smallest gap between a token's k-th and (k+1)-th router logit
    over the MoE layers of one forward of ``batch`` (None without a
    router): how far the routing is from a float32 tie."""
    from repro_torch.models import common, moe
    if model.cfg.family != "moe":
        return None
    gaps = []
    route = moe.route

    def spy(p, x, cfg):
        logits = common.matmul(x, p["router"]).reshape(-1, cfg.n_experts)
        top = torch.topk(logits, cfg.top_k + 1, dim=-1).values
        gaps.append(top[:, -2] - top[:, -1])
        return route(p, x, cfg)
    moe.route = spy
    try:
        with torch.no_grad():
            model(batch["tokens"], mode="train", return_hidden=True)
    finally:
        moe.route = route
    return float(torch.cat(gaps).min())


def train_dist_family_run(torch, cfg, mesh, dev, ckpt_dir: str,
                          kept_dir: pathlib.Path) -> dict:
    """(b)'s run of a family: ``Trainer(mesh=)``'s model and train step
    (weights drawn from ``SEED`` and rescaled to the parity weights), then
    ``TRAIN_DIST_FAM_STEPS`` steps on ``train_dist_family_batch``: each
    step's (loss, grad norm, lr) and seconds, the memory after placement,
    the collectives.  The memory after placement is what the trainer's
    state adds to the bytes the live tensors requested
    (``requested_bytes``).

    The first step's parameters are split by the single-device run's
    clipped first gradient g (AdamW's first moment over (1 - b1): no extra
    backward): where AdamW's step is not near sign(g) the single run
    writes them into ``kept_dir`` (per leaf, flat indices and values:
    ``<leaf>.idx.npy``, ``<leaf>.val.npy``) and a rank holds its own
    against them (``train_dist_first_step``); the others, whose update
    float32's order of a sum decides (|g| near AdamW's eps), every run
    sets back to their initial values before the second step, so that
    the second step starts from the same state on every mesh up to the
    first step's compared entries.  The single run also reports the
    router's margin."""
    import numpy as np

    from repro_torch.sharding import collectives
    from repro_torch.timing import timed
    torch.cuda.reset_peak_memory_stats()
    base = requested_bytes(torch)
    trainer = train_dist_trainer(cfg, mesh, dev, ckpt_dir)
    params, opt, _ = trainer.init_state()
    parity_weights(torch, trainer.cfg, params)
    torch.cuda.synchronize()
    out = {"placed_bytes": requested_bytes(torch) - base,
           "resident_bytes": base}
    if mesh is None:
        out["router_margin"] = router_margin(torch, trainer.model,
                                             train_dist_family_batch(
                                                 torch, cfg, 0,
                                                 trainer.device))
    p0 = {k: p.detach().clone() for k, p in params.items()}

    def step(opt, i):
        batch = train_dist_family_batch(torch, cfg, i, trainer.device)
        opt, m = trainer.train_step(opt, batch)
        return opt, torch.stack([m[k].float() for k in
                                 ("loss", "grad_norm", "lr")]).tolist()
    metrics, secs = [], []
    with collectives.collective_trace() as ev:
        for i in range(TRAIN_DIST_FAM_STEPS):
            (opt, host), s_ = timed(step, opt, i)
            metrics.append(host)
            secs.append(s_)
            if i == 0 and mesh is not None:
                out["compare"] = train_dist_first_step(
                    torch, cfg, trainer.model.layout, params, p0, kept_dir)
            elif i == 0:
                # train_card_vs_cpu's rule on the clipped gradient g scale
                kept_dir.mkdir(parents=True)
                n_kept = 0
                b1 = trainer.opt_cfg.b1
                with torch.no_grad():
                    for k, p in params.items():
                        g = opt.m[k].abs() / (1.0 - b1)
                        keep = (g > STEP_GRAD_TOL * g.max().clamp_min(1e-30)) \
                            & (g > STEP_FLOOR)
                        idx = keep.flatten().nonzero()[:, 0]
                        np.save(kept_dir / f"{k}.idx.npy", idx.cpu().numpy())
                        np.save(kept_dir / f"{k}.val.npy",
                                p.detach().flatten()[idx].cpu().numpy())
                        n_kept += int(idx.numel())
                        p.copy_(torch.where(keep, p, p0[k]))
                        del g, keep, idx
                out["kept"] = n_kept
                out["entries"] = sum(p.numel() for p in params.values())
            if i == 0:
                del p0
    out.update(metrics=metrics, step_s=secs,
               peak_bytes=torch.cuda.max_memory_allocated(),
               collectives=[list(e) for e in ev])
    return out


def train_dist_leaf_spec(cfg, name: str) -> tuple:
    """(spec, shape) of the model state's leaf ``name`` (a stacked leaf's
    layer without its leading dim)."""
    from repro_torch.models import common, lm, transformer
    parts = name.split(".")
    stacked = parts[0] in transformer.STACKED
    if stacked:
        del parts[1]
    d = common.flatten(lm.param_defs(cfg))[".".join(parts)]
    return (d.spec[1:], d.shape[1:]) if stacked else (d.spec, d.shape)


def train_dist_first_step(torch, cfg, layout, params: dict, p0: dict,
                          kept_dir: pathlib.Path) -> dict:
    """This rank's blocks of the first step's parameters against the
    single-device run's kept entries (the largest difference, and the
    entries compared in split and in whole leaves); then the entries not
    kept set back to ``p0``, the blocks' initial values, in place."""
    import numpy as np
    err, n_split, n_whole = 0.0, 0, 0
    for k, p in params.items():
        spec, shape = train_dist_leaf_spec(cfg, k)
        idx = torch.from_numpy(np.load(kept_dir / f"{k}.idx.npy")).to(
            p.device)
        val = torch.from_numpy(np.load(kept_dir / f"{k}.val.npy")).to(
            p.device)
        blk = layout.block_index(spec, shape)
        inside = torch.ones_like(idx, dtype=torch.bool)
        local = torch.zeros_like(idx)
        rem = idx
        for dim in reversed(range(len(shape))):
            c = rem % shape[dim]
            rem = rem // shape[dim]
            lo, hi = blk[dim].start, blk[dim].stop
            inside &= (c >= lo) & (c < hi)
            local = local + (c - lo) * int(np.prod(
                [b.stop - b.start for b in blk[dim + 1:]], dtype=np.int64))
        n = int(inside.sum())
        flat = p.detach().flatten()
        keep = torch.zeros_like(flat, dtype=torch.bool)
        if n:
            keep[local[inside]] = True
            err = max(err, float((flat[local[inside]]
                                  - val[inside]).abs().max()))
        with torch.no_grad():
            p.copy_(torch.where(keep.view(p.shape), p, p0[k]))
        del flat
        if tuple(p.shape) == tuple(shape):
            n_whole += n
        else:
            n_split += n
        del idx, val, inside, local, rem, keep
    return {"param_max_abs": err, "compared_split": n_split,
            "compared_whole": n_whole}


def train_dist_dryrun(tdir: pathlib.Path) -> dict:
    """``launch.dryrun.main --no-compile`` in process over every
    architecture and dglmnet on the meshes of 1 and 4 cards (the
    arguments' records; the traced step is held against the card by
    ``traced_train_step``): the counts by status and the largest per-card
    bytes."""
    import contextlib
    import io

    from repro_torch.launch import dryrun
    out = tdir / "dryrun"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rcs = [dryrun.main(["--arch", arch, "--mesh", "both", "--no-compile",
                            "--out", str(out)]) for arch in ("all", "dglmnet")]
    recs = [json.loads(f.read_text()) for f in sorted(out.rglob("*.json"))]
    counts = {st: sum(r["status"] == st for r in recs)
              for st in ("lowered", "skipped", "failed")}
    ok = [r for r in recs if r["status"] == "lowered"]
    big = max(ok, key=lambda r: r["bytes_per_card"]["total"])
    return {"rcs": rcs, "cells": len(recs), **counts,
            "largest_per_card_bytes": big["bytes_per_card"]["total"],
            "largest_cell": f"{big['mesh']} {big['arch']} x {big['shape']}",
            "failed_cells": [f"{r['mesh']} {r['arch']} x {r['shape']}"
                             for r in recs if r["status"] == "failed"]}


def serve_dist_gates(single: dict, ranks: list) -> dict:
    """serve_dist's record and gates: for each key, both ranks' logits
    of every step within ``SERVE_DIST_LOGIT_TOL`` of the single run's
    largest |logit| (or ``SERVE_DIST_CONTROL_X`` times the single run's
    float32 control where that is the larger) and its tokens, the same
    collectives on both ranks (some), each rank's bytes after placement
    the dry-run's, no GLM kernel launched, and the recurrences' scan
    kernels launched once a call on the card (``serve_dist_scan_calls``),
    no plain route."""
    from repro_torch.configs.registry import get_arch
    out = {}
    for key, one in single.items():
        cfg, batch, shape = serve_dist_case(key)
        fr = [r[key] for r in ranks]
        same = fr[0]["collectives"] == fr[1]["collectives"]
        bar = max(SERVE_DIST_LOGIT_TOL,
                  SERVE_DIST_CONTROL_X * max(one["control_rel"]))
        frec = {"arch": cfg.name,
                "reduced": {"n_layers": [get_arch(cfg.name).n_layers,
                                         cfg.n_layers]},
                "vocab_size": cfg.vocab_size, "batch": batch,
                "mesh": list(shape), "single": one,
                "prefill_s": [f["prefill_s"] for f in fr],
                "decode_ms_per_step": [f["decode_ms_per_step"] for f in fr],
                "logits_rel": [max(f["logits_rel"]) for f in fr],
                "logits_rel_steps": fr[0]["logits_rel"],
                "control_rel": max(one["control_rel"]), "bar": bar,
                "tokens_equal": [f["tokens_equal"] for f in fr],
                "placed_bytes": [f["placed_bytes"] for f in fr],
                "dryrun_bytes": fr[0]["dryrun_bytes"],
                "collectives_per_rank": [len(f["collectives"]) for f in fr],
                "same_collectives": same,
                "launched": [f["launched"] for f in fr],
                "world_part_s": [f["part_s"] for f in fr]}
        out[key] = frec
        emit({"phase": "serve_dist", "key": key, **frec})
        check(all(e <= bar for e in frec["logits_rel"])
              and all(frec["tokens_equal"]),
              f"serve_dist {key}: {shape} against the single-card run "
              f"{frec['logits_rel']}, tokens {frec['tokens_equal']}")
        check(same and fr[0]["collectives"],
              f"serve_dist {key}: the ranks' collectives differ or none "
              "ran")
        check(all(f["placed_bytes"] == f["dryrun_bytes"] for f in fr),
              f"serve_dist {key}: bytes after placement "
              f"{frec['placed_bytes']} against {frec['dryrun_bytes']}")
        frec["scans"] = [scan_gates(
            f"serve_dist {key} rank {i}", f["launched"], f["scan_calls"],
            False, serve_dist_scan_calls(cfg, shape, 1))
            for i, f in enumerate(fr)]
        emit({"phase": "serve_dist_scans", "key": key,
              "scans": frec["scans"]})
    return out


def serve_dist_scan_calls(cfg, shape, runs: int) -> dict:
    """{scan: its calls on the card} of ``runs`` ``serve_dist_run``
    requests of ``cfg`` on a mesh of ``shape`` (None: one card): each
    recurrent layer once a call, the prefill's and each decode step's;
    the mLSTM's prefill not where its chunkwise form runs; on a model
    axis past 1 the sLSTM's once a time step (its h gathered over ranks
    every step)."""
    seq = TRAIN_DIST_SEQ if cfg.name == TRAIN_ARCH \
        else TRAIN_DIST_FAMILIES[cfg.name][1]
    decode = SERVE_DIST_GEN - 1
    chunk = getattr(cfg, "ssm_chunk", 0)
    prefill = {"ssm_scan": 1,
               "mlstm_scan": 0 if chunk and seq % chunk == 0
               and seq > chunk else 1,
               "slstm_scan": seq if shape is not None and shape[1] > 1
               else 1}
    return {k: n * (prefill[k] + decode) * runs
            for k, n in recurrent_layers(cfg).items()}


def train_dist_phase(np, torch, dev, card) -> dict:
    """Sharded LM training (after train): phi4-mini-3.8b at full width,
    2 of 32 layers, float32, remat, batch 2 x 512, 3 steps from the
    parity weights.  The single-device trainer first (its metrics on the
    host; its first gradients, and first and last parameters kept on the
    card); (a) a
    world of one over NCCL, mesh (1, 1), tp: the same bits; (b) a gloo
    world of 2 on the one card, (1, 2), tp with sequence parallelism:
    train_card_vs_cpu's STEP_* bars on every step's loss and grad norm
    and on the first step's parameters, the same collectives on both
    ranks, each rank's memory after placement
    within 1% of the dry-run's parameters + moments for (1, 2); then the
    other families in the same world (``TRAIN_DIST_FAMILIES``), each
    against its single-device run, all made before the world: the same
    bars on both steps (the second from the first step's state with its
    near-sign(g) entries set back, ``train_dist_family_run``; the first
    step's parameters by ``TRAIN_DIST_PARAM_ATOL`` where it names the
    family), the same collectives, memory within 1%, the requested bytes
    every time; before the training, serving in the same world
    (``serve_dist_rank``, ``serve_dist_gates``) against single-card runs
    made before it; (c) ``launch.dryrun`` over every cell: no failure.
    No GLM kernel launched; the scans' training calls ran their plain
    loops, counted, and their serving calls launched the kernels
    (``scan_gates``)."""
    import gc
    import math
    import shutil

    from repro_torch.dist import bootstrap, launcher
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import common, lm

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    tdir = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-train-dist-"))
    cfg = train_dist_cfg()
    n_params = common.param_count(lm.param_defs(cfg))
    rec = {"phase": "train_dist", "card": card, "arch": cfg.name,
           "n_layers": TRAIN_DIST_LAYERS, "params": n_params,
           "reduced": {"n_layers": [32, TRAIN_DIST_LAYERS],
                       "why": "the phase's time (90 s) and two ranks' "
                              "state on one card"},
           "batch": TRAIN_DIST_BATCH, "seq_len": TRAIN_DIST_SEQ,
           "steps": TRAIN_DIST_STEPS, "opt": TRAIN_DIST_OPT,
           "bars": {"loss": STEP_LOSS_TOL, "grad_norm": STEP_GNORM_TOL,
                    "step1_param_atol": STEP_PARAM_ATOL,
                    "memory": TRAIN_DIST_MEM_TOL}}

    # ---- the single-device reference
    t0 = time.perf_counter()
    r = train_dist_run(torch, train_dist_trainer(cfg, None, dev,
                                                 str(tdir / "ref")),
                       capture=True)
    ref_metrics = r["metrics"]
    ref_params = {k: p.detach().clone() for k, p in r.pop("params").items()}
    ref_grads0, ref_params1 = r.pop("grads0"), r.pop("params1")
    rec["single"] = {**{k: r[k] for k in ("metrics", "step_s")},
                     "peak_gb": r["peak_bytes"] / 1e9,
                     "part_s": time.perf_counter() - t0}
    traced11 = traced_train_step(cfg, TRAIN_DIST_BATCH, TRAIN_DIST_SEQ,
                                 (1, 1))
    rec["single"]["traced_peak"] = peak_against_trace(
        "train_dist single", r["step_memory"], traced11)
    emit({"phase": "train_dist_traced", "mesh": [1, 1],
          **rec["single"]["traced_peak"], "trace_s": traced11["trace_s"]})
    del r
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (a) a world of one over NCCL, mesh (1, 1)
    t0 = time.perf_counter()
    import torch.distributed as tdist
    check(not tdist.is_initialized(),
          "train_dist: a process group is already up in this process")
    ctx = bootstrap.initialize(coordinator=f"127.0.0.1:{launcher.free_port()}",
                               num_processes=1, process_id=0)
    r = train_dist_run(torch, train_dist_trainer(
        cfg, bootstrap.make_dist_mesh(1, 1), dev, str(tdir / "one")))
    differ = [k for k, p in r["params"].items()
              if not torch.equal(p.detach(), ref_params[k])]
    bootstrap.shutdown()
    rec["a_nccl_1x1"] = {"backend": ctx.backend, "metrics": r["metrics"],
                         "step_s": r["step_s"],
                         "metrics_bits_equal": r["metrics"] == ref_metrics,
                         "leaves_differing": len(differ),
                         "leaves": len(ref_params),
                         "part_s": time.perf_counter() - t0}
    check(r["metrics"] == ref_metrics and not differ,
          f"train_dist (a): (1, 1) over NCCL is not the single-device run's "
          f"bits: {rec['a_nccl_1x1']}, leaves {differ[:6]}")
    del r, ref_params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the other families' single-device runs, each freed before the
    # next and all before the world
    out = tdir / "b"
    out.mkdir()
    fam_single = {}
    ops.reset_launch_counts()
    for arch in TRAIN_DIST_FAMILIES:
        t0 = time.perf_counter()
        fcfg = train_dist_family_cfg(arch)
        with ScanWatch(torch, ops) as watch:
            r = train_dist_family_run(
                torch, fcfg, None, dev, str(tdir / f"single_{arch}"),
                out / "kept" / arch)
        r["scans"] = scan_gates(f"train_dist single {arch}",
                                ops.launch_counts(), watch.card_calls, True)
        check(bool(recurrent_layers(fcfg)) == any(
            v["card_calls"] for v in r["scans"].values()),
              f"train_dist single {arch}: scans called {r['scans']}")
        ops.reset_launch_counts()
        fam_single[arch] = {
            k: r[k] for k in ("metrics", "step_s", "placed_bytes",
                              "resident_bytes", "kept", "entries",
                              "router_margin", "scans")}
        fam_single[arch].update(
            params=common.param_count(lm.param_defs(fcfg)),
            peak_gb=r["peak_bytes"] / 1e9,
            part_s=time.perf_counter() - t0)
        del r
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "train_dist_single", "arch": arch,
              **fam_single[arch]})

    # ---- serve_dist's single-card runs, before the world
    serve_ref = tdir / "serve_ref"
    serve_ref.mkdir()
    serve_single = {}
    for key in serve_dist_archs():
        t0 = time.perf_counter()
        scfg, batch, _ = serve_dist_case(key)
        with ScanWatch(torch, ops) as watch:
            r = serve_dist_run(torch, scfg, None, dev, batch, (1, 1),
                               control=True)
        # serving: every scan call on the card launched its kernel (the
        # request and its float32 control: twice a layer a call)
        r["scans"] = scan_gates(f"serve_dist single {key}",
                                ops.launch_counts(), watch.card_calls, False,
                                serve_dist_scan_calls(scfg, None, 2))
        ops.reset_launch_counts()
        torch.save({"logits": r.pop("logits").cpu(),
                    "tokens": r.pop("tokens")}, serve_ref / f"{key}.pt")
        r.pop("collectives")
        serve_single[key] = {**r, "part_s": time.perf_counter() - t0}
        gc.collect()
        torch.cuda.empty_cache()
        check(r["placed_bytes"] == r["dryrun_bytes"],
              f"serve_dist {key}: single-card bytes after placement {r}")

    # ---- (b) a gloo world of 2 on the one card, (1, 2), tp + seq_shard:
    # serve_dist, then phi4-mini's training, then the other families'
    t0 = time.perf_counter()
    spec = out / "spec.json"
    spec.write_text(json.dumps({"mesh": [1, 2], "out": str(out),
                                "families": list(TRAIN_DIST_FAMILIES),
                                "serve_ref": str(serve_ref)}))
    res = launcher.run_local(2, REPO / "chip_smoke.py",
                             args=["--train-dist-worker", str(spec)],
                             timeout_s=TRAIN_DIST_TIMEOUT_S, grace_s=10)
    check(res.ok, f"train_dist (b) failed:\n{res.summary(3000)}")
    ranks = [json.loads((out / f"rank{i}.json").read_text())
             for i in range(2)]
    rec["serve_dist"] = serve_dist_gates(serve_single,
                                         [r.pop("serve") for r in ranks])
    mesh12 = AbstractMesh((1, 2))
    params_a, opt_a = lm.abstract_state(cfg, mesh12)
    want_bytes = dryrun.card_bytes(params_a, mesh12) \
        + dryrun.card_bytes(opt_a, mesh12)
    errs = {"loss": [], "grad_norm": []}
    for (lb, gb, _), (lr_, gr, _) in zip(ranks[0]["metrics"], ref_metrics):
        errs["loss"].append(abs(lb - lr_) / abs(lr_))
        errs["grad_norm"].append(abs(gb - gr) / gr)
    # the first step's parameters, the ranks' blocks against the single
    # run's where AdamW's step is not near sign(g) (train_card_vs_cpu's
    # rule, by the single run's gradients)
    split = lm.split_leaves(cfg)
    p_err, n_in, n_out = 0.0, 0, 0
    scale = min(1.0, 1.0 / ref_metrics[0][1])
    for k, want in ref_params1.items():
        blocks = [np.load(out / f"rank{i}" / f"{k}.npy", mmap_mode="c")
                  for i in range(2)]
        if k in split:
            d = [i for i in range(want.dim())
                 if want.shape[i] != blocks[0].shape[i]][0]
            got = torch.cat([torch.from_numpy(b).to(dev) for b in blocks],
                            dim=d)
        else:
            got = torch.from_numpy(blocks[0]).to(dev)
            check(np.array_equal(blocks[0], blocks[1]),
                  f"train_dist (b): the ranks' whole leaf {k} differs")
        g = ref_grads0[k].abs()
        keep = (g > STEP_GRAD_TOL * g.max().clamp_min(1e-30)) \
            & (g * scale > STEP_FLOOR)
        n = int(keep.sum())
        n_in += n
        n_out += keep.numel() - n
        if n:
            p_err = max(p_err, float((got - want).abs()[keep].max()))
        del got, g, keep, blocks
    del ref_grads0, ref_params1
    gc.collect()
    torch.cuda.empty_cache()
    mem_rel = [abs(r["placed_bytes"] - want_bytes) / want_bytes
               for r in ranks]
    same_seq = ranks[0]["collectives"] == ranks[1]["collectives"]
    # rank 0's second step against its traced step on the dry (1, 2)
    from repro_torch.roofline import hlo
    traced12 = traced_train_step(cfg, TRAIN_DIST_BATCH, TRAIN_DIST_SEQ,
                                 (1, 2))
    kinds = ("collective_bytes", "collective_counts",
             "collective_bytes_by_kind")
    card_stats = hlo.collective_stats(
        [tuple(e) for e in ranks[0]["step_collectives"]]).as_dict()
    card_coll = {k: card_stats[k] for k in kinds}
    trace_coll = {k: traced12["profile"][k] for k in kinds}
    traced_rec = {
        "peak": peak_against_trace("train_dist (b) rank 0",
                                   ranks[0]["step_memory"], traced12),
        "card_collectives": card_coll, "traced_collectives": trace_coll,
        "collectives_equal": card_coll == trace_coll,
        "traced_profile": traced12["profile"],
        "trace_s": traced12["trace_s"]}
    emit({"phase": "train_dist_traced", "mesh": [1, 2], **traced_rec})
    check(card_coll == trace_coll and card_coll["collective_counts"],
          f"train_dist (b): rank 0's step collectives {card_coll} against "
          f"the traced {trace_coll}")
    rec["b_gloo_1x2"] = {
        "metrics": ranks[0]["metrics"],
        "metrics_rank1_equal": ranks[0]["metrics"] == ranks[1]["metrics"],
        "loss_rel": errs["loss"], "grad_norm_rel": errs["grad_norm"],
        "step1_param_max_abs": p_err, "params_compared": n_in,
        "params_near_sign_flip": n_out,
        "step_s": [r["step_s"] for r in ranks],
        "step_s_median_after_first": float(np.median(
            ranks[0]["step_s"][1:])),
        "placed_bytes": [r["placed_bytes"] for r in ranks],
        "dryrun_params_moments_bytes": want_bytes,
        "memory_rel": mem_rel,
        "peak_gb": [r["peak_bytes"] / 1e9 for r in ranks],
        "traced": traced_rec,
        "collectives_per_rank": [len(r["collectives"]) for r in ranks],
        "same_collectives": same_seq,
        "launched": [r["launched"] for r in ranks],
        "world_s": res.seconds, "part_s": time.perf_counter() - t0}
    emit({"phase": "train_dist_b", **rec["b_gloo_1x2"]})
    check(max(errs["loss"]) <= STEP_LOSS_TOL
          and max(errs["grad_norm"]) <= STEP_GNORM_TOL
          and p_err <= STEP_PARAM_ATOL and n_in > 0,
          f"train_dist (b): (1, 2) against the single-device run "
          f"{errs}, parameters {p_err}")
    check(same_seq and ranks[0]["metrics"] == ranks[1]["metrics"],
          "train_dist (b): the ranks' collectives or metrics differ")
    check(max(mem_rel) <= TRAIN_DIST_MEM_TOL,
          f"train_dist (b): memory after placement {rec['b_gloo_1x2']}")
    for i, r in enumerate(ranks):
        scan_gates(f"train_dist (b) rank {i}", r["launched"],
                   r["scan_calls"], True, {})
    rec["b_families"] = {}
    for arch, single in fam_single.items():
        fcfg = train_dist_family_cfg(arch)
        fr = [r["families"][arch] for r in ranks]
        params_a, opt_a = lm.abstract_state(fcfg, mesh12)
        fwant = dryrun.card_bytes(params_a, mesh12) \
            + dryrun.card_bytes(opt_a, mesh12)
        ref = single["metrics"]
        ferr = {"loss": [abs(a[0] - b[0]) / abs(b[0])
                         for a, b in zip(fr[0]["metrics"], ref)],
                "grad_norm": [abs(a[1] - b[1]) / b[1]
                              for a, b in zip(fr[0]["metrics"], ref)]}
        # the first step's compared parameters; the second step from
        # the first step's state with its near-sign(g) entries set back
        # (train_dist_family_run)
        p_bar = TRAIN_DIST_PARAM_ATOL.get(arch, STEP_PARAM_ATOL)
        p_err = max(f["compare"]["param_max_abs"] for f in fr)
        n_cmp = sum(f["compare"]["compared_split"] for f in fr) \
            + fr[0]["compare"]["compared_whole"]
        mem = [abs(f["placed_bytes"] - fwant) / fwant for f in fr]
        same = fr[0]["collectives"] == fr[1]["collectives"]
        frec = {"arch": arch, "n_layers": fcfg.n_layers,
                "vocab_size": fcfg.vocab_size,
                "seq_len": TRAIN_DIST_FAMILIES[arch][1],
                "single": single, "metrics": fr[0]["metrics"],
                "metrics_rank1_equal": fr[0]["metrics"] == fr[1]["metrics"],
                "loss_rel": ferr["loss"], "grad_norm_rel": ferr["grad_norm"],
                "step1_param_max_abs": p_err, "step1_param_atol": p_bar,
                "params_compared": n_cmp,
                "step_s": [f["step_s"] for f in fr],
                "placed_bytes": [f["placed_bytes"] for f in fr],
                "dryrun_params_moments_bytes": fwant, "memory_rel": mem,
                "peak_gb": [f["peak_bytes"] / 1e9 for f in fr],
                "resident_bytes": [f["resident_bytes"] for f in fr],
                "world_part_s": [f["part_s"] for f in fr],
                "collectives_per_rank": [len(f["collectives"]) for f in fr],
                "same_collectives": same,
                "launched": [f["launched"] for f in fr]}
        rec["b_families"][arch] = frec
        emit({"phase": "train_dist_b_family", **frec})
        check(len(ferr["loss"]) == TRAIN_DIST_FAM_STEPS
              and max(ferr["loss"]) <= STEP_LOSS_TOL
              and max(ferr["grad_norm"]) <= STEP_GNORM_TOL
              and all(math.isfinite(v) for m in fr[0]["metrics"] for v in m)
              and p_err <= p_bar and n_cmp > 0,
              f"train_dist (b) {arch}: (1, 2) against the single-device "
              f"run {ferr}, parameters {p_err} over {n_cmp}")
        check(same and frec["metrics_rank1_equal"],
              f"train_dist (b) {arch}: the ranks' collectives or metrics "
              "differ")
        check(max(mem) <= TRAIN_DIST_MEM_TOL,
              f"train_dist (b) {arch}: memory after placement {mem}")
        # the recurrent families' steps run the scans' plain loops on
        # every rank, each card call counted
        frec["scans"] = [scan_gates(
            f"train_dist (b) {arch} rank {i}", f["launched"],
            f["scan_calls"], True) for i, f in enumerate(fr)]
        check(all(bool(recurrent_layers(fcfg)) == any(
            v["card_calls"] for v in sc.values()) for sc in frec["scans"]),
              f"train_dist (b) {arch}: scans called {frec['scans']}")
        emit({"phase": "train_dist_b_scans", "arch": arch,
              "scans": frec["scans"]})

    # ---- (c) the dry-run over every cell
    t0 = time.perf_counter()
    dr = train_dist_dryrun(tdir)
    dr["part_s"] = time.perf_counter() - t0
    rec["c_dryrun"] = dr
    check(dr["failed"] == 0 and dr["rcs"] == [0, 0],
          f"train_dist (c): dry-run cells failed {dr['failed_cells']}")
    shutil.rmtree(tdir, ignore_errors=True)
    # since serve_dist's single runs: nothing in this process launched
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    check(not launched, f"train_dist: kernels launched {launched}")
    rec["kernel_launches_after_singles"] = 0
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def main() -> None:
    if "--dist-worker" in sys.argv:
        dist_worker(sys.argv[sys.argv.index("--dist-worker") + 1])
        return
    if "--train-dist-worker" in sys.argv:
        train_dist_worker(sys.argv[sys.argv.index("--train-dist-worker")
                                   + 1])
        return
    t_start = time.perf_counter()
    if not (REPO / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("src/repro_torch not found beside chip_smoke.py; run it from "
             "a checkout of the repository", code=2)
    sys.path.insert(0, str(REPO / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available", code=3)
    if torch.cuda.device_count() < 1:
        fail("no CUDA device is visible", code=3)

    from repro_torch.core.dglmnet import DGLMNETConfig
    from repro_torch.core.solver import GLMSolver
    from repro_torch.data import synthetic
    from repro_torch.kernels import build
    from repro_torch.kernels import cd_tile_solve as cd_tile_solve_k
    from repro_torch.kernels import glm_stats as glm_stats_k
    from repro_torch.kernels import gram_tc, ops, ref
    from repro_torch.kernels import tile_gram as tile_gram_k

    torch.manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else f"{kind}, power limit not read"

    # the traced parts of the run (serve, trace, stream) write here
    trace_tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-trace-")
    tdir = pathlib.Path(trace_tmp.name)

    # ---------------------------------------------------------------- setup
    t0 = time.perf_counter()
    lib = build.build()
    build_s = time.perf_counter() - t0
    build.library()
    ptxas = [ln.strip() for ln in (lib.parent / "build.log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "setup", "kernels_built": sorted(ops.KERNELS),
          "build_s": build_s, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": kind, "ptxas": ptxas})

    # --------------------------------------------- sparse problem (packing)
    t0 = time.perf_counter()
    ds = full_size_data(synthetic, "sparse")
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = full_size_solver(GLMSolver, ds, dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    design = solver.design
    n_rows, p_pad = design.shape
    nt, T, rb = design.n_tiles, design.tile_size, design.row_block
    emit({"phase": "sparse_setup", "train_shape": list(ds.train.X.shape),
          "nnz": ds.train.X.nnz, "n_rows": n_rows, "p_pad": p_pad,
          "n_tiles": nt, "row_block": rb, "n_bricks": solver.info.n_bricks,
          "occupancy": solver.info.occupancy,
          "max_bricks_per_tile": design.max_bricks_per_tile,
          "bricks_gb": design.bricks.numel() * 4 / 1e9,
          "generate_s": gen_s, "pack_and_place_s": pack_s})

    # ------------------------------------- kernels against their plain twins
    report = {}
    rng = np.random.default_rng(SEED)
    y, wobs, off = solver._ys, solver._wobs, solver._offsets
    n = n_rows
    # tolerances on max |kernel - plain| / max(max |plain|, 1): float32
    # with the same formulas (1e-5; probit 3e-4, erfc against log_ndtr);
    # K3 and K4 are the same float32 sums in another order (1e-5); K2 is
    # rounded step by step like its plain version and must match exactly
    # (torch.equal); K3's bf16 mode 1e-6, below bf16's own effect on the
    # smoke's G (its fault controls show the margin)
    tol = {"glm_stats": 1e-5, "glm_stats_probit": 3e-4,
           "alpha_search": 1e-5, "cd_tile_solve": 0.0, "tile_gram": 1e-5,
           "tile_gram_bf16": 1e-6}
    parity = {}

    # K1 and K4 at the sparse fit's n (its labels, weights and offsets) and
    # at the dense fit's n = 400,000 (random, with random weights), against
    # the throughput floor of their per-example work (tools/loss_floor.cu)
    xb = torch.from_numpy((rng.normal(size=n) * 1.5).astype(np.float32)) \
        .to(dev)
    xdb = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    vec = lambda v: torch.from_numpy(v.astype(np.float32)).to(dev)
    sets = {n: (y, wobs, off, xb, xdb),
            N_DENSE: (vec(rng.choice([-1.0, 1.0], N_DENSE)),
                      vec(rng.random(N_DENSE)),
                      vec(0.1 * rng.normal(size=N_DENSE)),
                      vec(1.5 * rng.normal(size=N_DENSE)),
                      vec(rng.normal(size=N_DENSE)))}
    floors = loss_floors(np, torch, glm_stats_k.FAMILY_CODES)
    floor_lib = floor_tool()
    report["glm_stats"] = k1_report(np, torch, rng, sets, floors, floor_lib,
                                    tol, parity)
    report["alpha_search"], alpha_counts = k4_report(
        np, torch, rng, sets, floors, floor_lib, tol, parity)
    emit({"phase": "k1_k4", "card": card, "loss_floor_ns": floors,
          "glm_stats": report["glm_stats"],
          "alpha_search": report["alpha_search"]})
    del sets

    # K3 on the real bricks of the fullest tile, at the first superstep's w, r
    _, s0, w0 = ops.glm_stats(y, torch.zeros_like(y), "logistic",
                              weights=wobs, offset=off)
    pops = np.diff(design.tile_ptr)
    tid = int(np.argmax(pops))
    tb, rows = design.tile_bricks(tid)
    K = tb.shape[0]
    G, g = ops.tile_gram(tb, rows, K, w0, s0)
    G2, g2 = ref.tile_gram(tb, rows, K, w0.reshape(-1, rb),
                           s0.reshape(-1, rb))
    e3 = max(errs(G, G2)[1], errs(g, g2)[1])
    parity["tile_gram"] = e3
    check(e3 <= tol["tile_gram"], f"tile_gram: error {e3}")
    # only G's upper blocks are computed and mirrored, with no atomics: G
    # is exactly symmetric and the same from run to run
    G3, g3 = ops.tile_gram(tb, rows, K, w0, s0)
    check(torch.equal(G, G.T), "tile_gram: G is not symmetric")
    check(torch.equal(G, G3) and torch.equal(g, g3),
          "tile_gram: G differs from run to run")
    del G3, g3
    e3 = max(errs(G, G2)[0], errs(g, g2)[0])
    k3_ms = time_ms(torch, lambda: tile_gram_k.launch(tb, rows, K, w0, s0),
                    20)
    k3_plain = time_ms(torch, lambda: ref.tile_gram(
        tb, rows, K, w0.reshape(-1, rb), s0.reshape(-1, rb)), 5)
    wk = w0.reshape(-1, rb)[rows.long()]
    k3_lib = time_ms(torch, lambda: torch.einsum("kit,ki,kiu->tu", tb, wk,
                                                 tb), 5)
    # G is symmetric, so the least work is its T (T + 1) / 2 unique
    # entries (one FMA a row each), beside the w scaling and g's FMAs
    k3_bytes = K * rb * T * 4 + K * 4 + 2 * K * rb * 4 + (T * T + T) * 4
    bn, slab = gram_tc.band(T), gram_tc.SLAB
    streamed = K * -(-rb // slab) * slab
    bounds = gram_bounds(k3_bytes, 1.0 * K * rb * T * (T + 1),
                         3.0 * K * rb * T,
                         6.0 * gram_tc.n_pairs(T) * bn * bn * streamed, k3_ms)
    report["tile_gram"] = dict(ms=k3_ms, plain_ms=k3_plain, **bounds,
                               library_ms=k3_lib, max_abs_err=e3, K=K)

    # K3's bf16 mode (precision="bf16" of the fused Jacobi superstep on
    # bricks) on the same tile: every block pair computed, none mirrored,
    # so G is not symmetric; its asymmetry must be the plain version's.
    # Its w and r are a later superstep's, at the random margins xb: the
    # first superstep's w is 1/4 on every row, and bf16(x / 4) = bf16(x) / 4
    # leaves that G exactly symmetric.
    _, s1, w1 = ops.glm_stats(y, xb, "logistic", weights=wobs, offset=off)
    Gb, gb = ops.tile_gram(tb, rows, K, w1, s1, precision="bf16")
    Gb2, gb2 = ref.tile_gram(tb, rows, K, w1.reshape(-1, rb),
                             s1.reshape(-1, rb), precision="bf16")
    scale = float(Gb2.abs().max())

    def k3b_off(Gx):
        """(G's error, its asymmetry's error) off the plain bf16 G,
        over the plain G's largest entry."""
        return (float((Gx - Gb2).abs().max()) / scale,
                errs(Gx - Gx.T, Gb2 - Gb2.T)[0] / scale)

    e3b_G, asym = k3b_off(Gb)
    e3b = max(e3b_G, errs(gb, gb2)[1])
    parity["tile_gram_bf16"] = e3b
    check(e3b <= tol["tile_gram_bf16"], f"tile_gram bf16: error {e3b}")
    check(not torch.equal(Gb, Gb.T) and asym <= tol["tile_gram_bf16"],
          f"tile_gram bf16: asymmetry {asym} off the plain version's")
    # Over 131,072 rows bf16 moves this G by only a few 1e-6 of its
    # largest entry, so the tolerance sits below that: the G of a kernel
    # that skipped a rounding, or mirrored its upper blocks, formed plainly
    # on the same inputs, must fail the same two checks
    A = tb * w1.reshape(-1, rb)[rows.long()][:, :, None]
    A32, A16 = A.double(), A.to(torch.bfloat16).double()
    B32, B16 = tb.double(), tb.to(torch.bfloat16).double()
    gram = lambda a, b: torch.einsum("kit,kiu->tu", a, b).float()
    upper = torch.triu(torch.ones(T, T, dtype=torch.bool, device=dev))
    faults = {"no_rounding": gram(A32, B32), "A_not_rounded": gram(A32, B16),
              "B_not_rounded": gram(A16, B32),
              "mirrored": torch.where(upper, Gb2, Gb2.T)}
    del A, A32, A16, B16, B32
    k3b_faults = {}
    for name, Gx in faults.items():
        ef, af = k3b_off(Gx)
        k3b_faults[name] = {"G_err": ef, "asymmetry_err": af}
        check(max(ef, af) > tol["tile_gram_bf16"],
              f"tile_gram bf16: the check passes a kernel with fault "
              f"{name} (G {ef}, asymmetry {af})")
    del faults
    Gb3, gb3 = ops.tile_gram(tb, rows, K, w1, s1, precision="bf16")
    check(torch.equal(Gb, Gb3) and torch.equal(gb, gb3),
          "tile_gram bf16: G differs from run to run")
    e3b = max(errs(Gb, Gb2)[0], errs(gb, gb2)[0])
    del Gb2, gb2, Gb3, gb3
    k3b_ms = time_ms(torch, lambda: tile_gram_k.launch(
        tb, rows, K, w1, s1, precision="bf16"), 20)
    k3b_plain = time_ms(torch, lambda: ref.tile_gram(
        tb, rows, K, w1.reshape(-1, rb), s1.reshape(-1, rb),
        precision="bf16"), 5)
    wk1 = w1.reshape(-1, rb)[rows.long()]
    A16 = (tb * wk1[:, :, None]).reshape(-1, T).to(torch.bfloat16)
    B16 = tb.reshape(-1, T).to(torch.bfloat16)
    k3b_lib, k3b_lib_what = library_bf16_ms(torch, A16.T, B16, 20)
    del A16, B16, wk1
    b_ms, b_by = bound_ms(k3_bytes, 2.0 * K * rb * T * T, H100_BF16_FLOPS)
    report["tile_gram_bf16"] = dict(
        ms=k3b_ms, plain_ms=k3b_plain, bound_ms=b_ms, bound_by=b_by,
        share_of_bound=b_ms / k3b_ms, library_ms=k3b_lib,
        library_covers=f"G only, operands rounded beforehand: {k3b_lib_what}",
        max_abs_err=e3b, K=K, asymmetry_vs_plain=asym,
        G_asymmetry=float((Gb - Gb.T).abs().max() / Gb.abs().max()),
        fault_controls=k3b_faults)
    del Gb, gb, s1, w1

    # K2 on that tile's Gram block (T = 256, h the strided diagonal view)
    # and on a T = 512 block, held bit for bit against the plain version;
    # T times the minimal step of tools/chain_floor.cu is its dependency
    # floor
    beta_t = torch.from_numpy((rng.normal(size=T) * 0.1).astype(np.float32)) \
        .to(dev)
    zeros = torch.zeros_like(beta_t)
    penf = solver._penf[tid * T:(tid + 1) * T].contiguous()
    mu = torch.full((), 1.0, device=dev)
    lam1 = 0.05 * float(g.abs().max())
    params = ops.solve_params(mu, 1e-6, lam1, 0.0, g)
    h = torch.diagonal(G)
    got = ops.cd_tile_solve(G, g, h, beta_t, zeros, params, penf=penf)
    want = ref.cd_tile_solve(G, g, h, beta_t, zeros, mu, 1e-6, lam1, 0.0,
                             penf=penf)
    check(torch.equal(got, want), "cd_tile_solve T=256: not bit-exact")
    e2 = float((got - want).abs().max())
    parity["cd_tile_solve"] = e2
    k2_ms = time_ms(torch, lambda: cd_tile_solve_k.launch(
        G, g, h, beta_t, zeros, params, penf), 200)
    k2_plain = time_ms(torch, lambda: ref.cd_tile_solve(
        G, g, h, beta_t, zeros, mu, 1e-6, lam1, 0.0, penf=penf), 3, 1)
    b_ms, b_by = k2_bound(T)
    steps = chain_floor(torch, G, g, beta_t, penf, mu, 1e-6, lam1, 0.0)
    T2 = 2 * T
    X2 = rng.normal(size=(4 * T2, T2)).astype(np.float32)
    w2 = rng.uniform(0.01, 0.25, 4 * T2).astype(np.float32)
    G2b = torch.from_numpy((X2.T * w2) @ X2).to(dev)
    g2b = torch.from_numpy(X2.T @ rng.normal(size=4 * T2)
                           .astype(np.float32)).to(dev)
    beta2 = torch.from_numpy((rng.normal(size=T2) * 0.1).astype(np.float32)) \
        .to(dev)
    zeros2 = torch.zeros_like(beta2)
    lam1_2 = 0.05 * float(g2b.abs().max())
    params2 = ops.solve_params(mu, 1e-6, lam1_2, 0.0, g2b)
    got2 = ops.cd_tile_solve(G2b, g2b, torch.diagonal(G2b), beta2, zeros2,
                             params2)
    want2 = ref.cd_tile_solve(G2b, g2b, torch.diagonal(G2b), beta2, zeros2,
                              mu, 1e-6, lam1_2, 0.0)
    check(torch.equal(got2, want2), "cd_tile_solve T=512: not bit-exact")
    k2_ms_512 = time_ms(torch, lambda: cd_tile_solve_k.launch(
        G2b, g2b, torch.diagonal(G2b), beta2, zeros2, params2, None), 200)
    del X2, G2b, g2b
    floor = T * steps["floor_step_ns"] * 1e-6
    floor_512 = T2 * steps["floor_step_ns"] * 1e-6
    report["cd_tile_solve"] = dict(
        ms=k2_ms, plain_ms=k2_plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, max_abs_err=e2, T=T, ms_T512=k2_ms_512,
        bound_ms_T512=k2_bound(T2)[0], dependency_floor_ms=floor,
        share_of_dependency_floor=floor / k2_ms,
        dependency_floor_ms_T512=floor_512,
        share_of_dependency_floor_T512=floor_512 / k2_ms_512, **steps)
    emit({"phase": "kernel_parity", "max_rel_err": parity,
          "tolerance": tol, "n": n, "T": T, "row_block": rb, "K": K,
          "alpha_counts": alpha_counts})
    del G, g, G2, g2, xb, xdb, wk, h

    # ------------------------------- small fits: the card against the CPU
    ref_fit = {}
    couplings = {"gauss-seidel": DGLMNETConfig(tile_size=256),
                 "jacobi-fused": DGLMNETConfig(tile_size=256,
                                               coupling="jacobi"),
                 "jacobi-unfused": DGLMNETConfig(tile_size=256,
                                                 coupling="jacobi",
                                                 fuse_superstep=False)}
    for kind_small in ("sparse", "dense"):
        small = (synthetic.make_sparse(n=3000, p=700, avg_nnz=20,
                                       k_true=30, seed=SEED + 1)
                 if kind_small == "sparse" else
                 synthetic.make_dense(n=3000, p=300, k_true=20,
                                      seed=SEED + 1))
        for coupling, cfg in couplings.items():
            res = []
            for d in ("cpu", dev):
                s = GLMSolver(small.train.X, small.train.y,
                              family="logistic", config=cfg,
                              fit_intercept=True, device=d)
                r = s.fit(lam1=0.05 * s.lambda_max(), max_outer=8, tol=0.0)
                res.append(r)
            f_err = float(np.max(np.abs(np.array(res[1].history["f"])
                                        / np.array(res[0].history["f"])
                                        - 1)))
            b_err = float(np.max(np.abs(res[1].beta - res[0].beta)))
            ref_fit[f"{kind_small}/{coupling}"] = {
                "f_rel_err": f_err, "beta_abs_err": b_err,
                "alpha_cpu": res[0].history["alpha"],
                "alpha_gpu": res[1].history["alpha"]}
            check(f_err <= 1e-4 and b_err <= 1e-3,
                  f"{kind_small} {coupling} small fit: card vs CPU f "
                  f"{f_err} beta {b_err}")
    emit({"phase": "reference_fit", "tolerance": {"f_rel": 1e-4,
                                                  "beta_abs": 1e-3},
          **ref_fit})

    # --------------------------------------------------------- the fits
    def run_fit(tag, solver, X_test, y_test, want_per_step, prefixes=None,
                steps=5):
        """Fit at LAM1_FRACTION * lambda_max for ``steps`` supersteps with
        the launch counts set to 0 just before; ``want_per_step`` the exact
        launches of one superstep.  With ``prefixes`` (kernel: name prefix
        of its CUDA functions) a profiled fit then counts the CUDA launches
        behind each logical one: every CUDA function of the kernel must run
        once per logical launch.  Returns (the counts, the fit's result)."""
        t0 = time.perf_counter()
        lmax = solver.lambda_max()
        torch.cuda.synchronize()
        lmax_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = solver.fit(lam1=LAM1_FRACTION * lmax, max_outer=steps)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        f = np.array(res.history["f"])
        it = res.n_iter
        want = {k: it * want_per_step.get(k, 0) for k in counts}
        check(np.isfinite(f).all(), f"{tag}: non-finite objective {f}")
        # f never rises: each f is one candidate-loss sum and the next f
        # before the step another sum of the same losses, so 1e-6 relative
        check(bool(np.all(np.diff(f) <= 1e-6 * np.abs(f[:-1]))),
              f"{tag}: objective rose {f.tolist()}")
        check(counts == want, f"{tag}: launches {counts} != {want}")
        nnz = int(res.history["nnz"][-1])
        check(0 < nnz <= solver.design.shape[1], f"{tag}: nnz {nnz}")
        beta = res.beta
        check(bool(np.isfinite(beta).all()), f"{tag}: non-finite beta")
        m = (X_test.matvec(beta) if hasattr(X_test, "matvec")
             else np.asarray(X_test, np.float32) @ beta) + solver.intercept_
        acc = float(((m > 0) == (y_test > 0)).mean())
        extra = {}
        if prefixes:
            found, logical, n_prof = cuda_launches(
                torch, solver, LAM1_FRACTION * lmax, prefixes)
            for k, fns in found.items():
                check(bool(fns) and all(c == logical[k] for c in
                                        fns.values()),
                      f"{tag}: CUDA launches of {k} {fns} for "
                      f"{logical[k]} logical launches")
            extra = {"cuda_launches_per_superstep": {
                         k: sum(fns.values()) / n_prof
                         for k, fns in found.items()},
                     "cuda_functions": found, "profiled_supersteps": n_prof}
        emit({"phase": f"{tag}_fit", "lambda_max": lmax,
              "lambda_max_s": lmax_s, "lam1": LAM1_FRACTION * lmax,
              "n_iter": it,
              "f": f.tolist(), "alpha": res.history["alpha"],
              "nnz": res.history["nnz"], "superstep_s": res.history["step_s"],
              "fit_s": fit_s, "launches": counts,
              "launches_per_superstep": {k: v / it for k, v in
                                         counts.items()},
              **extra, "peak_mem_gb": peak_gb, "test_accuracy": acc})
        return counts, res

    sparse_counts, sparse_res = run_fit("sparse", solver, ds.test.X,
                                        ds.test.y,
                               {"glm_stats": 1, "cd_tile_solve": nt,
                                "tile_gram": nt, "alpha_search": 2})
    del design, tb, rows, y, wobs, off, s0, w0, penf
    serve_counts = serve_phase(np, torch, solver, ds, dev, report, parity,
                               floor_lib, tdir)
    path = sparse_path_phase(np, torch, solver)
    checkpoint_phase(np, torch, GLMSolver, solver, ds, dev, path)
    trace_phase(np, torch, solver, path, tdir, card)
    # the analysis phase's parts on the sparse session (its line follows
    # the dist phase)
    analysis = {"sparse_launches": analysis_launches(
                    solver, solver.lambda_max()),
                "steady_state": analysis_steady_state(
                    solver, solver.lambda_max())}
    path_reference_phase(np, GLMSolver, DGLMNETConfig, synthetic, dev)
    lam1_sparse = LAM1_FRACTION * solver.lambda_max()
    del solver, path
    torch.cuda.empty_cache()
    multinomial_counts = multinomial_phase(np, torch, GLMSolver,
                                           DGLMNETConfig, ds, dev)
    estimator_counts = estimator_phase(np, torch, GLMSolver, DGLMNETConfig,
                                       synthetic, ds, dev, lam1_sparse)
    # the fused Jacobi superstep on bricks, in fp32 and in bf16: K1, K3 (or
    # its bf16 mode) for every tile, K2 once for all of them (batched), a
    # float32 matvec and K4 over all 294 candidates; a profiled fit holds
    # each kernel's CUDA functions to its logical launches
    sparse_jacobi = {}
    for prec, k3 in (("fp32", "tile_gram"), ("bf16", "tile_gram_bf16")):
        sj = full_size_solver(GLMSolver, ds, dev, DGLMNETConfig(
            coupling="jacobi", precision=prec))
        tag = "sparse_jacobi" + ("_bf16" if prec == "bf16" else "")
        sparse_jacobi[prec] = run_fit(
            tag, sj, ds.test.X, ds.test.y,
            {"glm_stats": 1, k3: nt, "cd_tile_solve": 1, "alpha_search": 1},
            {"glm_stats": "glm_stats_", k3: "tile_gram_",
             "cd_tile_solve": "cd_tile_solve_",
             "alpha_search": "alpha_search_"}, steps=3)
        del sj
        torch.cuda.empty_cache()
    emit(bf16_tracks_fp32(np, "sparse_jacobi_bf16", sparse_jacobi["fp32"][1],
                          sparse_jacobi["bf16"][1]))
    ingest_data = (ds.train.X, ds.train.y)      # the ingest phase's rows
    del ds

    t0 = time.perf_counter()
    dd = full_size_data(synthetic, "dense")
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dsolver = full_size_solver(GLMSolver, dd, dev)
    torch.cuda.synchronize()
    dnt = dsolver.design.n_tiles
    emit({"phase": "dense_setup", "train_shape": list(dd.train.X.shape),
          "padded_shape": list(dsolver.design.shape),
          "n_tiles": dnt,
          "design_gb": dsolver.design.data.numel() * 4 / 1e9,
          "generate_s": gen_s, "place_s": time.perf_counter() - t0})
    dense_counts, dense_res = run_fit("dense", dsolver, dd.test.X, dd.test.y,
                                      {"glm_stats": 1, "cd_tile_solve": dnt,
                                       "alpha_search": 2})
    lmax_dense = dsolver.lambda_max()
    analysis["dense_launches"] = analysis_launches(dsolver, lmax_dense)
    del dsolver
    torch.cuda.empty_cache()

    jsolver = full_size_solver(GLMSolver, dd, dev,
                               DGLMNETConfig(coupling="jacobi"))
    fused_parity(np, torch, jsolver, dev, report, parity)
    jacobi_counts, jres = run_fit(
        "dense_jacobi", jsolver, dd.test.X, dd.test.y,
        {"stats_gram_solve": 1, "margin_ls": 1},
        {"stats_gram_solve": "sgs_", "margin_ls": "margin_ls_"})
    del jsolver
    torch.cuda.empty_cache()
    # the same fit in bf16: the bf16 modes of K5 and K6, held against the
    # fp32 fit above
    bsolver = full_size_solver(GLMSolver, dd, dev, DGLMNETConfig(
        coupling="jacobi", precision="bf16"))
    bf16_counts, bres = run_fit(
        "dense_jacobi_bf16", bsolver, dd.test.X, dd.test.y,
        {"stats_gram_solve_bf16": 1, "margin_ls_bf16": 1},
        {"stats_gram_solve_bf16": "sgs_", "margin_ls_bf16": "margin_ls_"})
    emit(bf16_tracks_fp32(np, "dense_jacobi_bf16", jres, bres))
    del bsolver, jres, bres
    torch.cuda.empty_cache()
    # the unfused Jacobi superstep on the same data: a cuBLAS Gram per
    # tile, one K2 launch for every tile (as the reference's vmap is one
    # program), one matvec and the two-launch line search (K4)
    usolver = full_size_solver(GLMSolver, dd, dev,
                               DGLMNETConfig(coupling="jacobi",
                                             fuse_superstep=False))
    run_fit("dense_jacobi_unfused", usolver, dd.test.X, dd.test.y,
            {"glm_stats": 1, "cd_tile_solve": 1, "alpha_search": 2})
    # the streaming Jacobi fit's reference: 3 unfused supersteps
    lam1_unfused = LAM1_FRACTION * usolver.lambda_max()
    unfused_res = usolver.fit(lam1=lam1_unfused, max_outer=3, tol=0.0)
    del usolver
    torch.cuda.empty_cache()
    dense_cv_phase(np, torch, GLMSolver, DGLMNETConfig, dd, dev)
    torch.cuda.empty_cache()
    stream = stream_phase(np, torch, GLMSolver, DGLMNETConfig, dd, dev,
                          (LAM1_FRACTION * lmax_dense, dense_res),
                          (lam1_unfused, unfused_res), lmax_dense, floors,
                          floor_lib, parity, card, tdir)
    torch.cuda.empty_cache()
    baseline_counts = baselines_phase(np, torch, dd, dev, report, parity,
                                      card)
    torch.cuda.empty_cache()
    # the dist phase streams the dense train split from a .npy
    dist_tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-npy-")
    dense_npy = (str(pathlib.Path(dist_tmp.name) / "X.npy"),
                 str(pathlib.Path(dist_tmp.name) / "y.npy"))
    np.save(dense_npy[0], np.asarray(dd.train.X, np.float32))
    np.save(dense_npy[1], np.asarray(dd.train.y, np.float32))
    del dd, dense_res, unfused_res
    torch.cuda.empty_cache()
    ingest_counts = ingest_phase(np, torch, *ingest_data, dev, card)
    del ingest_data
    torch.cuda.empty_cache()
    dist_counts = dist_phase(np, torch, sparse_res, lam1_sparse, dense_npy,
                             LAM1_FRACTION * lmax_dense, card,
                             analysis=analysis)
    dist_tmp.cleanup()
    # the LM template's serving path and the head probe, last: every
    # earlier phase's tensors are freed before its 47 GB of weights
    probe_counts = lm_phase(np, torch, dev, card)
    # the other five families of the LM template after the dense one, and
    # the fused Jacobi probe on deepseek-v2-lite's features
    families_counts, scan_counts = lm_families_phase(np, torch, dev, card,
                                                     report, parity)
    # every kernel of the twelve sources has launched by now (the scans in
    # lm_families)
    analysis["kernel_smem"] = analysis_kernel_smem(dev)
    analysis_phase(analysis, card)
    # LM training on the card: no hand-written kernel on its path
    train_phase(np, torch, dev, card)
    # sharded LM training and the dry-run, last
    train_dist_phase(np, torch, dev, card)
    for name in ("glm_stats", "cd_tile_solve", "alpha_search"):
        report[name]["chunk_shapes"] = stream["kernels"][name]
        report[name]["launches_stream"] = stream["counts"][name]
        report[name]["launches_head_probe"] = probe_counts[name]
    for name in ("stats_gram_solve", "margin_ls"):
        report[name]["launches_head_probe_deepseek"] = families_counts[name]
    emit({"phase": "kernel_parity_report", "max_rel_err": parity})
    # the four built-in families never took a plain route on the card
    built_in = {"sparse": sparse_counts, "serve": serve_counts,
                "multinomial": multinomial_counts,
                **{f"estimator_{i}": c
                   for i, c in enumerate(estimator_counts)},
                "sparse_jacobi": sparse_jacobi["fp32"][0],
                "sparse_jacobi_bf16": sparse_jacobi["bf16"][0],
                "dense": dense_counts, "dense_jacobi": jacobi_counts,
                "dense_jacobi_bf16": bf16_counts, "stream": stream["counts"],
                "stream_jacobi": stream["jacobi_counts"],
                "ingest": ingest_counts, "baselines_admm": baseline_counts[0],
                "baselines_online_tg": baseline_counts[1]}
    plain = {tag: {k: v for k, v in c.items() if k.endswith("/plain") and v}
             for tag, c in built_in.items()}
    check(not any(plain.values()) and all(
        f"{k}/plain" in c for c in built_in.values()
        for k in ops.PLAIN_ROUTES),
          f"built-in families took a plain route: {plain}")
    emit({"phase": "plain_routes", "built_in_plain_calls": 0,
          "runs_checked": sorted(built_in)})
    trace_tmp.cleanup()

    # ------------------------------------------------------------- report
    # the bf16 modes replace the bf16 branches of the TPU kernels' bodies;
    # the reference forms the brick route's bf16 Gram in ref.py
    src = {"glm_stats": "src/repro/kernels/glm_stats.py:72",
           "cd_tile_solve": "src/repro/kernels/cd_tile_solve.py:74",
           "tile_gram": "src/repro/kernels/tile_gram.py:59",
           "alpha_search": "src/repro/kernels/alpha_search.py:48",
           "stats_gram_solve": "src/repro/kernels/superstep_tile.py:152",
           "margin_ls": "src/repro/kernels/superstep_tile.py:251",
           "predict_tile": "src/repro/kernels/predict_tile.py:68",
           "stats_gram_solve_bf16": "src/repro/kernels/superstep_tile.py:123",
           "margin_ls_bf16": "src/repro/kernels/superstep_tile.py:217",
           "tile_gram_bf16": "src/repro/kernels/ref.py:161",
           # the two scans of the competing algorithms: no Pallas kernel,
           # the reference's loops that XLA compiles
           "admm_shooting": "src/repro/baselines/admm.py:36",
           "online_tg": "src/repro/baselines/online_tg.py:37",
           # the recurrences' lax.scans of the LM template
           **SCAN_SRC}
    # each kernel's launches come from the run of its own path
    main_path = {"glm_stats": sparse_counts, "cd_tile_solve": sparse_counts,
                 "tile_gram": sparse_counts, "alpha_search": sparse_counts,
                 "stats_gram_solve": jacobi_counts,
                 "margin_ls": jacobi_counts, "predict_tile": serve_counts,
                 "stats_gram_solve_bf16": bf16_counts,
                 "margin_ls_bf16": bf16_counts,
                 "tile_gram_bf16": sparse_jacobi["bf16"][0],
                 "admm_shooting": baseline_counts[0],
                 "online_tg": baseline_counts[1],
                 # lm_families' zamba2 and xlstm serve checks
                 **{k: scan_counts for k in SCAN_NAMES}}
    # what each source's launched kernels ask of the card (the analysis
    # phase's kernel_smem read the same records)
    resources = {stem: [{k: r[k] for k in (
        "name", "regs", "static_smem", "requested_dynamic_smem",
        "requested_threads", "local_bytes", "launches")}
        for r in recs if r["launches"]]
        for stem, recs in ops.kernel_resources().items()}
    kernels = []
    for name in src:
        rep = report[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      f"{name.removesuffix('_bf16')}.cu",
            "replaces": src[name], "launches": main_path[name][name],
            "launches_dense": dense_counts[name],
            "resources": resources[name.removesuffix("_bf16")],
            **({"launches_dist_per_rank": {
                mesh: [c.get(name, 0) for c in per_rank]
                for mesh, per_rank in dist_counts.items()}}
               if name in ("glm_stats", "cd_tile_solve", "tile_gram",
                           "alpha_search") else {}),
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            **{k: rep[k] for k in ("bound_fma_ms", "bound_fma_by",
                                   "share_of_tensor_core_bound",
                                   "share_of_fma_bound", "tflops_needed",
                                   "tf32_tflops_executed", "plain_note",
                                   "dependency_floor_ms",
                                   "share_of_dependency_floor", "ms_T512",
                                   "bound_ms_T512",
                                   "dependency_floor_ms_T512",
                                   "share_of_dependency_floor_T512",
                                   "floor_step_cycles", "floor_step_ns",
                                   "floor_probe_clock_mhz",
                                   "design_step_cycles", "design_step_ns",
                                   "design_probe_clock_mhz", "batched_ms",
                                   "batched_tiles", "launch_floor_ms",
                                   "share_of_launch_floor", "share_of_bound",
                                   "library_share_of_bound", "grid_blocks",
                                   "sm_count", "ms_B64", "launch_floor_ms_B64",
                                   "share_of_launch_floor_B64",
                                   "bound_ms_B64", "library_covers",
                                   "shapes", "loss_floor_ns",
                                   "stats_floor_ns", "bytes_bound_ms",
                                   "loss_floor_ms", "stats_floor_ms",
                                   "at_half_of_bound", "threads", "n", "K",
                                   "asymmetry_vs_plain", "G_asymmetry",
                                   "fault_controls", "launches_stream",
                                   "launches_head_probe",
                                   "launches_head_probe_deepseek",
                                   "chunk_shapes", "bytes_bound_passes_ms",
                                   "share_of_bytes_bound_passes",
                                   "dependency_steps", "step_us",
                                   "floor_step_us", "cluster",
                                   "r_in_shared_memory",
                                   "w_in_shared_memory", "max_rel_err",
                                   "nonfinite_same_positions",
                                   "nonfinite_plain", "flops_bound_ms",
                                   "plain_over_kernel", "input_scale",
                                   "bar",
                                   "plain_off_float64",
                                   "kernel_off_float64")
               if k in rep}})
    emit({"kernels": kernels})
    emit({"phase": "wall", "wall_s": time.perf_counter() - t_start,
          "earlier_wall_s": "729.3 (PERF.md, before the train phase)"})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
