"""Dry-run: every (architecture x input shape) traced on one card of the
port's meshes of 1 and 4 cards, with its per-card peak memory, flops,
bytes and collectives, and its roofline terms.

A port of the JAX package's ``repro.launch.dryrun``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both [--no-compile]

The reference lowers and compiles each cell's step with XLA on the TPU
pod's production meshes, reads XLA's ``memory_analysis`` and profiles the
partitioned HLO (``analyze_hlo``).  The port traces its own step instead,
on the CPU with no card: rank 0 of ``launch.mesh.abstract_mesh(1)`` (1, 1)
or ``abstract_mesh(4)`` (1, 4) runs one call of the step a user runs
(``lm.make_train_step`` with ``adamw.AdamWConfig()``, its backward, remat
recompute and AdamW included; ``lm.make_prefill_step``;
``lm.make_decode_step`` with the cache full but for the new token;
``core.dglmnet.make_superstep``) on fake tensors
of its blocks (``roofline.hlo.fake_mode``: nothing is allocated), over a
world that does not communicate (``tensor_parallel.Layout.dry``), under
``roofline.hlo.analyze_step``.  Each record
(``results/dryrun_torch/<mesh><tag>/<arch>__<shape>.json``, or under
``--out``) holds:

  * ``status`` ("ok", "lowered" under ``--no-compile``, "skipped" with
    ``reason`` by ``configs.base.cell_is_runnable``, or "failed" with the
    traceback) and ``tp_padding`` (``configs.base.tp_pad_config``);
  * ``memory``: the reference's ``_mem_dict`` fields (``argument_bytes``,
    ``output_bytes``, ``temp_bytes``, ``alias_bytes``,
    ``peak_bytes_est``) from the traced live bytes, and ``fits``:
    ``peak_bytes_est`` against ``launch.mesh.HBM_BYTES``;
  * ``profile`` (``StepStats.as_dict()``: flops, bytes accessed,
    collective bytes and counts by kind, one card's), ``roofline``
    (``roofline.model.roofline_terms``: compute, memory and collective
    seconds, ``dominant``, ``bound_s``), ``model_flops``,
    ``hlo_flops_total`` (flops x cards) and ``useful_compute_ratio``;
  * ``bytes_per_card``: one card's block of the step's arguments by
    placement (``params``, ``moments`` with the step count, ``caches``,
    ``batch`` with a decode's token and cache length, ``total``), and
    ``param_count`` (``roofline.model.count_params``);
  * ``extrapolated`` where the step runs a loop over time (the hybrid's
    Mamba2 scan, xLSTM's mLSTM and sLSTM): the counts of the cell solved
    from short traces (``fit_plan``), and the two held-out traces (one
    length, one depth) that check them.

``--no-compile`` writes the argument-only record (``bytes_per_card``,
``fits`` on it, ``terms`` from the model flops, ``not_counted``) with
``"status": "lowered"``, as the reference's flag stops before the compile.

``--arch dglmnet`` traces the paper's workload (``configs.glm_webscale``):
rows over ``data``, feature blocks over ``model``, the design as bricks
where the shape's occupancy is below 1 (the reference's brick count and
row padding) and as a dense block otherwise, through the plain kernels
(``"kernel_backend": "ref"``, as the reference lowers it): the
hand-written kernels' work on the card is not what is counted.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import sys
import traceback
from fractions import Fraction
from typing import Optional

from repro_torch.configs import GLM_SHAPES, SHAPES
from repro_torch.configs.base import ShapeSpec, cell_is_runnable, \
    tp_pad_config
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.kernels import ref
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, PEAK_FLOPS_FP32,
                                     abstract_mesh)
from repro_torch.models import common, lm
from repro_torch.roofline import model as roof
from repro_torch.timing import timed

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"
MESHES = {"1": 1, "4": 4}
NOT_COUNTED = "activations and temporaries of the step (--no-compile)"


def leaves(tree) -> list:
    """The tensors of a nested dict / named tuple of meta tensors."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def card_bytes(tree, mesh) -> int:
    """One card's bytes of a tree of meta tensors, each laid out by its
    ``.spec``."""
    return sum(math.prod(common.shard_shape(t.shape, t.spec, mesh))
               * t.element_size() for t in leaves(tree))


def _terms(flops: float, total: int, n_cards: int) -> dict:
    return {"compute_s": flops / (n_cards * PEAK_FLOPS_FP32),
            "memory_s": total / HBM_BW}


def _shape(shape) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


# ---------------------------------------------------------------------------
# the traced step
# ---------------------------------------------------------------------------

def _block(t, mesh):
    """A fake tensor of one card's block of the meta tensor ``t``, keeping
    its ``.spec`` (made under a current ``hlo.fake_mode()``)."""
    import torch
    f = torch.empty(common.shard_shape(t.shape, t.spec, mesh),
                    dtype=t.dtype)
    f.spec = t.spec
    return f


def _blocks(tree, mesh):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _blocks(v, mesh) for k, v in tree.items()}
    return _block(tree, mesh)


def trace_step(cfg, shape, mesh, *, ce_chunk: Optional[int] = None):
    """``roofline.hlo.analyze_step`` over one call of ``cfg``'s step for
    ``shape`` (a ``ShapeSpec``) on rank 0 of ``mesh``'s dry world: the
    train step (AdamW, remat as ``cfg`` says), prefill or decode, on
    fake tensors of the rank's blocks of the dry-run's inputs
    (``lm.input_specs``) and of the parameters in ``cfg``'s dtype.
    ``ce_chunk``: the vocab-parallel loss's tokens a chunk for this trace
    (``lm.CE_CHUNK``; ``FitPlan.point``)."""
    if ce_chunk is not None:
        saved, lm.CE_CHUNK = lm.CE_CHUNK, ce_chunk
        try:
            return trace_step(cfg, shape, mesh)
        finally:
            lm.CE_CHUNK = saved
    import torch

    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.roofline import hlo
    from repro_torch.sharding import tensor_parallel as tp

    lay = tp.Layout.dry(tuple(mesh.sizes))
    pdt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    with hlo.fake_mode():
        batch, caches, cache_len, token = lm.input_specs(cfg, shape, mesh)
        batch, caches = _blocks(batch, mesh), _blocks(caches, mesh)
        shapes = transformer.state_shapes(transformer.block_defs(
            lm.param_defs(cfg), lay))
        state = {k: torch.empty(s, dtype=pdt) for k, s in shapes.items()}
        model = lm.build_model(cfg, state=state, layout=lay)
        if shape.kind == "train":
            step = lm.make_train_step(model, adamw.AdamWConfig(), layout=lay)
            params = lm.trainable_params(model)
            opt = adamw.AdamWState(
                m={k: torch.empty(p.shape) for k, p in params.items()},
                v={k: torch.empty(p.shape) for k, p in params.items()},
                count=torch.empty((), dtype=torch.int32))
            return hlo.analyze_step(step, opt, batch, state=params)
        with torch.no_grad():
            if shape.kind == "prefill":
                return hlo.analyze_step(lm.make_prefill_step(model), caches,
                                        batch, state=state)
            # the step's cache length is a host int: the new token's
            # position, the cache full but for it
            return hlo.analyze_step(
                lm.make_decode_step(model), caches, _block(token, mesh),
                shape.seq_len - 1, batch, state=state)


# the counts of a trace that ``extrapolate`` solves for
def _counts(trace, n_layers: dict) -> dict:
    """The counts of a trace by name; ``n_layers``: {stack: its layers}
    of the traced config (``_phase_key``)."""
    st = trace.stats
    out = {"flops": st.flops, "bytes_accessed": st.bytes_accessed,
           "collective_bytes": st.collective_bytes}
    out.update({f"count/{k}": v for k, v in st.collective_counts.items()})
    out.update({f"bytes/{k}": v
                for k, v in st.collective_bytes_by_kind.items()})
    out.update({f"memory/{k}": v for k, v in trace.memory.items()})
    for phase, v in trace.phase_peak.items():
        for k in _phase_key(phase, n_layers):
            if not k.endswith("/mid"):
                out["peak/" + k] = max(out.get("peak/" + k, 0), v)
    return out


def _phase_key(phase: str, n_layers: dict) -> str:
    """The names of a phase of ``StepTrace.phase_peak`` alike at every
    depth: a stacked layer's parameter by its stack and whether its layer
    is the first one the backward reaches (``/first``), the last
    (``/last``; a stack of one layer gives both), or one between them
    (``/mid``: its peak lies between theirs, as the live bytes there are
    linear in the layer's index)."""
    if not phase.startswith("backward:"):
        return [phase]
    parts = phase[len("backward:"):].split(".")
    if parts[0] not in n_layers or len(parts) < 2:
        return [phase]
    j, n = int(parts[1]), n_layers[parts[0]]
    pos = [p for p, at in (("first", n - 1), ("last", 0)) if j == at]
    return [f"backward:{parts[0]}/{p}" for p in pos or ["mid"]]


def _stack_sizes(cfg) -> dict:
    """{stacked subtree: its layers} of ``cfg``'s model state."""
    from repro_torch.models import transformer
    out = {}
    for name in transformer.state_shapes(lm.param_defs(cfg)):
        parts = name.split(".")
        if parts[0] in transformer.STACKED:
            out[parts[0]] = max(out.get(parts[0], 0), int(parts[1]) + 1)
    return out


def _from_counts(c: dict) -> tuple:
    """(StepStats, memory) of ``_counts``'s dict; the peak is the largest
    of the phases' peaks (``peak/...``), and the temporaries what the
    peak holds past the arguments and the new outputs."""
    from repro_torch.roofline.hlo import StepStats
    st = StepStats(c["flops"], c["bytes_accessed"], c["collective_bytes"])
    for k, v in c.items():
        if k.startswith("count/"):
            st.collective_counts[k[6:]] = v
        elif k.startswith("bytes/"):
            st.collective_bytes_by_kind[k[6:]] = v
    memory = {k[7:]: int(v) for k, v in c.items()
              if k.startswith("memory/")}
    memory["peak_bytes_est"] = int(max(v for k, v in c.items()
                                       if k.startswith("peak/")))
    memory["temp_bytes"] = memory["peak_bytes_est"] - memory[
        "argument_bytes"] - memory["output_bytes"] + memory["alias_bytes"]
    return st, memory


@dataclasses.dataclass(frozen=True)
class FitPlan:
    """The traces a cell's counts are solved from.

    At a fixed structure (every loop's trip count but the time loops'
    fixed) each count is a polynomial of degree at most 2 in the sequence
    length S (attention quadratic, the scans and the rest linear) and
    linear in the number of blocks of each kind.  So the cell is traced
    at S = 2, 3 and 4 units (the attention's KV chunk scaled to keep the
    cell's chunk count; at one unit a chunk could be one key, where
    ``einsum`` multiplies instead of calling a matmul) at each of
    ``cuts`` (layer counts whose ``structure`` vectors span the cell's),
    and checked on two more traces held out of the fit: one at S = 5
    units and ``cuts[0]`` layers (the quadratic in S), one at S = 2 units
    and ``held_layers`` (the linear model in blocks)."""
    unit: int
    cuts: tuple
    held_layers: int
    n_attn_chunks: int        # 0: no attention to scale
    n_ce_chunks: int          # 0: no vocab-parallel loss to scale

    def structure(self, cfg, n_layers: int) -> tuple:
        """(1, blocks of each kind) of ``cfg`` cut to ``n_layers``."""
        if cfg.family == "hybrid":
            return (1, -(-n_layers // cfg.shared_attn_every), n_layers)
        return (1, n_layers // cfg.slstm_period)

    def point(self, cfg, shape, n_layers: int, seq: int):
        """The (config, shape, ``lm.CE_CHUNK``) traced at ``n_layers``
        and length ``seq``."""
        kw = {"n_layers": n_layers}
        if self.n_attn_chunks:
            kw["attn_chunk"] = seq // self.n_attn_chunks
        ce = shape.global_batch * seq // self.n_ce_chunks \
            if self.n_ce_chunks else None
        return cfg.replace(**kw), dataclasses.replace(
            shape, name=f"{shape.name}@{seq}", seq_len=seq), ce


def fit_plan(cfg, shape, mesh) -> Optional[FitPlan]:
    """How a cell whose step loops over time is extrapolated (None: trace
    it whole).  The families with a loop over time are ``hybrid``
    (Mamba2) and ``ssm`` (xLSTM), in train and prefill.  The unit length
    keeps every chunk whole at every point: the attention's chunk count,
    the sequence split over ``model``, the vocab-parallel loss's
    ``lm.CE_CHUNK`` tokens (a multiple of them a point), ``ssm_chunk``
    and the scans' checkpoint stride (``kernels.ref.CKPT_EVERY``: a
    training step's scans keep ceil(S / L) checkpoints)."""
    if cfg.family not in ("hybrid", "ssm") or shape.kind == "decode":
        return None
    S, M = shape.seq_len, mesh.shape["model"]
    unit = M
    n_attn = n_ce = 0
    if cfg.family == "hybrid":
        if S % cfg.attn_chunk or cfg.sliding_window:
            return None
        n_attn = S // cfg.attn_chunk
        unit = math.lcm(unit, n_attn)
    if cfg.ssm_chunk:
        unit = math.lcm(unit, cfg.ssm_chunk)
    unit = math.lcm(unit, ref.CKPT_EVERY)
    if shape.kind == "train" and M > 1:
        # the vocab-parallel loss's chunks of tokens, kept as many
        rows = shape.global_batch // mesh.shape["data"]
        if (rows * S) % lm.CE_CHUNK or rows % mesh.shape["data"]:
            return None
        n_ce = rows * S // lm.CE_CHUNK
        unit = math.lcm(unit, n_ce // math.gcd(n_ce, rows))
    unit *= -(-4 // unit)          # fit lengths of 8 and more
    if 5 * unit >= S:
        return None
    if cfg.family == "hybrid":
        e = cfg.shared_attn_every
        cuts, held = (2, 3, e + 2), 2 * e + 1
    else:
        p = cfg.slstm_period
        cuts, held = (p, 2 * p), 3 * p
    return FitPlan(unit, cuts, held, n_attn, n_ce)


def _solve(rows, vals) -> list:
    """x with rows @ x = vals, exactly (Fractions; rows square)."""
    n = len(rows)
    a = [[Fraction(v) for v in r] + [Fraction(b)] for r, b in
         zip(rows, vals)]
    for c in range(n):
        piv = next(r for r in range(c, n) if a[r][c] != 0)
        a[c], a[piv] = a[piv], a[c]
        for r in range(n):
            if r != c and a[r][c] != 0:
                f = a[r][c] / a[c][c]
                a[r] = [x - f * y for x, y in zip(a[r], a[c])]
    return [a[r][n] / a[r][r] for r in range(n)]


def _predict(plan, cfg, table, seq, n_layers) -> dict:
    """The counts at (``seq``, ``n_layers``) from ``table`` {(cut, S):
    counts}: each cut's quadratic in S through its three lengths, then the
    blocks' linear model through the cuts."""
    seqs = sorted({s for _, s in table})
    # a phase seen at every point (a stack's last layer is its first at a
    # depth of one)
    keys = set.intersection(*(set(c) for c in table.values()))
    rows = [plan.structure(cfg, L) for L in plan.cuts]
    target = plan.structure(cfg, n_layers)
    out = {}
    for k in sorted(keys):
        at = []
        for L in plan.cuts:
            # Lagrange through the three lengths, evaluated at seq
            v = Fraction(0)
            for i, si in enumerate(seqs):
                w = Fraction(1)
                for j, sj in enumerate(seqs):
                    if j != i:
                        w *= Fraction(seq - sj, si - sj)
                v += w * Fraction(table[L, si][k])
            at.append(v)
        coef = _solve(rows, at)
        out[k] = sum(c * t for c, t in zip(coef, target))
    return out


def extrapolate(cfg, shape, mesh, plan: FitPlan):
    """(StepStats, memory, record) of the cell solved from ``plan``'s
    traces; raises where a held-out trace's flops, bytes or collectives
    differ from the prediction at all."""
    def traced(L, seq):
        c, sh, ce = plan.point(cfg, shape, L, seq)
        return _counts(trace_step(c, sh, mesh, ce_chunk=ce),
                       _stack_sizes(c))

    seqs = [plan.unit * i for i in (2, 3, 4)]
    table = {(L, s): traced(L, s) for L in plan.cuts for s in seqs}
    checks = []
    for s, L in ((5 * plan.unit, plan.cuts[0]),
                 (seqs[0], plan.held_layers)):
        held, pred = traced(L, s), _predict(plan, cfg, table, s, L)
        exact = [k for k in set(pred) | set(held)
                 if not k.startswith(("memory/", "peak/"))]
        bad = {k: (float(pred.get(k, 0)), held.get(k, 0)) for k in exact
               if pred.get(k, 0) != held.get(k, 0)}
        if bad:
            raise ValueError(f"extrapolation misses the held-out trace at "
                             f"S={s}, {L} layers: {bad}")
        held_peak = held["memory/peak_bytes_est"]
        peak = _from_counts({k: float(v) for k, v in pred.items()})[1][
            "peak_bytes_est"]
        checks.append({"seq": s, "layers": L, "exact": True,
                       "peak_rel_err": (peak - held_peak) / held_peak})
    got = _predict(plan, cfg, table, shape.seq_len, cfg.n_layers)
    if any(v.denominator != 1 for k, v in got.items()
           if not k.startswith(("memory/", "peak/"))):
        raise ValueError("extrapolated counts are not whole numbers")
    st, memory = _from_counts({k: float(v) for k, v in got.items()})
    rec = {"seq": seqs, "layers": list(plan.cuts), "held_out": checks}
    return st, memory, rec


def _compiled(rec, st, memory, mf, n_cards) -> dict:
    from repro_torch.roofline.model import roofline_terms
    hlo_total = st.flops * n_cards
    rec.update(status="ok", memory=memory, profile=st.as_dict(),
               roofline=roofline_terms(st, n_cards), model_flops=mf,
               hlo_flops_total=hlo_total,
               useful_compute_ratio=(mf / hlo_total) if hlo_total else None,
               fits=memory["peak_bytes_est"] <= HBM_BYTES,
               hbm_bytes=HBM_BYTES)
    return rec


def lower_cell(arch_name: str, shape, mesh, *, do_compile: bool = True,
               overrides: Optional[dict] = None) -> dict:
    """One cell's record on ``mesh`` (an ``AbstractMesh``).  ``shape``: a
    name of ``SHAPES`` or a ``ShapeSpec``.  ``overrides``:
    ``ArchConfig.replace`` keywords (parallelism, seq_shard, n_layers,
    dtype, ...).  ``do_compile=False``: the argument-only record."""
    cfg = get_arch(arch_name)
    shape = _shape(shape)
    runnable, why = cell_is_runnable(cfg, shape)
    rec = {"arch": arch_name, "shape": shape.name, "mesh": mesh.tag,
           "kind": shape.kind}
    if not runnable:
        rec.update(status="skipped", reason=why)
        return rec
    if overrides:
        cfg = cfg.replace(**overrides)
        rec["overrides"] = dict(overrides)
    if getattr(cfg, "parallelism", "tp") == "tp":
        cfg, pads = tp_pad_config(cfg, mesh.shape["model"])
        if pads:
            rec["tp_padding"] = {k: list(v) for k, v in pads.items()}
    batch, caches, cache_len, token = lm.input_specs(cfg, shape, mesh)
    params, opt_state = lm.abstract_state(
        cfg, mesh, with_opt=shape.kind == "train")
    parts = {"params": card_bytes(params, mesh),
             "moments": card_bytes(opt_state, mesh),
             "caches": card_bytes(caches, mesh),
             "batch": card_bytes([batch, cache_len, token], mesh)}
    parts["total"] = sum(parts.values())
    n_cards = math.prod(mesh.sizes)
    flops = roof.model_flops(cfg, shape)
    rec.update(n_cards=n_cards, bytes_per_card=parts,
               param_count=roof.count_params(cfg)[0])
    if not do_compile:
        rec.update(status="lowered", fits=parts["total"] <= HBM_BYTES,
                   hbm_bytes=HBM_BYTES, not_counted=NOT_COUNTED,
                   model_flops=flops,
                   terms=_terms(flops, parts["total"], n_cards))
        return rec
    plan = fit_plan(cfg, shape, mesh)
    if plan is None:
        tr, secs = timed(trace_step, cfg, shape, mesh)
        st, memory = tr.stats, tr.memory
        rec["n_ops"] = tr.n_ops
    else:
        (st, memory, rec["extrapolated"]), secs = timed(
            extrapolate, cfg, shape, mesh, plan)
    rec["trace_s"] = round(secs, 2)
    return _compiled(rec, st, memory, flops, n_cards)


def glm_card_bytes(shape_name: str, mesh) -> dict:
    """One card's bytes of the d-GLMNET superstep's arguments: the design
    block (bricks as the reference sizes them, or a dense block), the
    row vectors (y, weights, offsets, margins) and the feature vectors
    (beta, screening mask, penalty factors), the budget, lambdas and the
    scalars of the state."""
    gs = GLM_SHAPES[shape_name]
    D, M = mesh.shape["data"], mesh.shape["model"]
    n, p, T = gs.n_examples, gs.n_features, gs.tile_size
    occ = getattr(gs, "occupancy", 1.0)
    n_tiles = (p // M) // T
    if occ < 1.0:
        rb = 256
        n_loc = -(-n // (D * rb)) * rb          # rows padded to bricks
        n_rb = n_loc // rb
        B = max(1, int(round(occ * n_rb * n_tiles)))
        design = B * rb * T * 4 + 2 * B * 4 + (n_tiles + 1) * 4
        kind = "bricks"
    else:
        n_loc = n // D
        design = n_loc * (p // M) * 4
        kind = "dense"
    rows = 4 * n_loc * 4
    feats = 3 * (p // M) * 4
    scalars = 4 + 8 + 4 + 4 + 4     # budget, lams, mu, cursor, step
    out = {"design": design, "rows": rows, "features": feats,
           "scalars": scalars}
    out["total"] = sum(out.values())
    return {"design_kind": kind, "occupancy": occ, "bytes": out}


def trace_glm_step(shape_name: str, mesh, *, coupling: str = "jacobi",
                   compress=None):
    """``roofline.hlo.analyze_step`` over one d-GLMNET superstep
    (``core.dglmnet.make_superstep``, logistic, one tile cycle) on rank 0
    of ``mesh``'s dry world, on fake tensors of the rank's blocks: the
    design (bricks sized as ``glm_card_bytes`` sizes them, in equal
    tiles, or a dense block), the row and feature vectors and the state.
    The tensors are CPU tensors, so the plain kernels run (the reference
    lowers ``kernel_backend="ref"``)."""
    import numpy as np
    import torch

    from repro_torch.core import dglmnet
    from repro_torch.data.design import BlockSparseDesign, DenseDesign
    from repro_torch.roofline import hlo
    from repro_torch.sharding import tensor_parallel as tp

    gs = GLM_SHAPES[shape_name]
    D, M = mesh.shape["data"], mesh.shape["model"]
    n, p, T = gs.n_examples, gs.n_features, gs.tile_size
    p_loc = p // M
    n_tiles = p_loc // T
    lay = tp.Layout.dry(tuple(mesh.sizes))
    cfg = dglmnet.DGLMNETConfig(family="logistic", lam1=1.0, lam2=1.0,
                                tile_size=T, coupling=coupling,
                                compress_margin=compress)
    f32 = torch.float32
    with hlo.fake_mode():
        step = dglmnet.make_superstep(cfg, n_tiles=n_tiles, device="cpu",
                                      groups=(lay.data, lay.model),
                                      max_budget=n_tiles)
        if getattr(gs, "occupancy", 1.0) < 1.0:
            rb = 256
            n_loc = -(-n // (D * rb)) * rb
            B = max(1, int(round(gs.occupancy * (n_loc // rb) * n_tiles)))
            ptr = np.array([t * B // n_tiles for t in range(n_tiles + 1)],
                           dtype=np.int32)
            X = BlockSparseDesign(
                torch.empty((B, rb, T), dtype=f32),
                torch.empty((B,), dtype=torch.int32),
                torch.empty((B,), dtype=torch.int32), ptr, T, rb, n_loc,
                n_tiles, int(np.diff(ptr).max()))
            design = [X.bricks, X.brick_row, X.brick_tile]
        else:
            n_loc = n // D
            X = DenseDesign(torch.empty((n_loc, p_loc), dtype=f32), T)
            design = [X.data]
        rows = [torch.empty((n_loc,), dtype=f32) for _ in range(3)]
        active, penf = torch.empty((p_loc,)), torch.empty((p_loc,))
        state = dglmnet.FitState(torch.empty((p_loc,)),
                                 torch.empty((n_loc,)), torch.empty(()),
                                 0, 0)

        def superstep(y, weights, offset, penf, state, active):
            return step(X, y, weights, offset, (1.0, 1.0), penf, state,
                        active=active, budget=n_tiles)

        return hlo.analyze_step(superstep, *rows, penf, state, active,
                                state=design)


def lower_glm_cell(shape_name: str, mesh, *, do_compile: bool = True,
                   coupling: str = "jacobi", compress=None) -> dict:
    """The paper's own workload on ``mesh``: its per-card argument bytes,
    the model flops of one superstep, ``occupancy x (2 n p T + 4 n p)``
    (the tile Grams and the gradient and margin products), as the
    reference counts them, and (``do_compile``) the traced superstep
    (``trace_glm_step``)."""
    gs = GLM_SHAPES[shape_name]
    b = glm_card_bytes(shape_name, mesh)
    n, p, T = gs.n_examples, gs.n_features, gs.tile_size
    flops = b["occupancy"] * (2.0 * n * p * T + 4.0 * n * p)
    n_cards = math.prod(mesh.sizes)
    total = b["bytes"]["total"]
    rec = {"arch": "dglmnet", "shape": shape_name, "mesh": mesh.tag,
           "kind": "glm", "coupling": coupling, "compress": compress,
           "design": b["design_kind"], "occupancy": b["occupancy"],
           "kernel_backend": "ref", "n_cards": n_cards,
           "bytes_per_card": b["bytes"]}
    if not do_compile:
        rec.update(status="lowered", fits=total <= HBM_BYTES,
                   hbm_bytes=HBM_BYTES, not_counted=NOT_COUNTED,
                   model_flops=flops, terms=_terms(flops, total, n_cards))
        return rec
    tr, secs = timed(trace_glm_step, shape_name, mesh, coupling=coupling,
                     compress=compress)
    rec.update(trace_s=round(secs, 2), n_ops=tr.n_ops)
    return _compiled(rec, tr.stats, tr.memory, flops, n_cards)


def parse_overrides(text: str) -> dict:
    """``"parallelism=fsdp,seq_shard=False"`` as keywords (True, False and
    integers parsed)."""
    out = {}
    for kv in filter(None, text.split(",")):
        k, v = kv.split("=")
        out[k] = {"True": True, "False": False}.get(
            v, int(v) if v.isdigit() else v)
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id, 'all', or 'dglmnet'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["1", "4", "both"],
                    help="cards: 1 (mesh 1x1), 4 (1x4) or both")
    ap.add_argument("--no-compile", action="store_true",
                    help="the step's arguments only, not traced")
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", default="",
                    help="comma-separated ArchConfig overrides, e.g. "
                         "'parallelism=fsdp,seq_shard=False'")
    ap.add_argument("--out", default=str(RESULTS),
                    help="directory of the records")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.override)
    compile_ = not args.no_compile
    meshes = [abstract_mesh(MESHES[m]) for m in
              (("1", "4") if args.mesh == "both" else (args.mesh,))]
    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    n_ok = n_skip = n_fail = 0
    biggest = (0, None)
    for mesh in meshes:
        outdir = pathlib.Path(args.out) / (mesh.tag + args.tag)
        outdir.mkdir(parents=True, exist_ok=True)
        for arch in archs:
            shapes = (list(GLM_SHAPES) if arch == "dglmnet" else
                      list(SHAPES)) if args.shape == "all" else [args.shape]
            for shape in shapes:
                try:
                    if arch == "dglmnet":
                        rec = lower_glm_cell(
                            shape, mesh, do_compile=compile_,
                            coupling=overrides.get("coupling", "jacobi"),
                            compress=overrides.get("compress"))
                    else:
                        rec = lower_cell(arch, shape, mesh,
                                         do_compile=compile_,
                                         overrides=overrides or None)
                except Exception:
                    rec = {"arch": arch, "shape": shape, "mesh": mesh.tag,
                           "status": "failed",
                           "error": traceback.format_exc(limit=20)}
                (outdir / f"{arch}__{shape}.json").write_text(
                    json.dumps(rec, indent=2))
                st = rec["status"]
                n_ok += st in ("ok", "lowered")
                n_skip += st == "skipped"
                n_fail += st == "failed"
                extra = ""
                if st in ("ok", "lowered"):
                    per_card = rec["memory"]["peak_bytes_est"] \
                        if st == "ok" else rec["bytes_per_card"]["total"]
                    if per_card > biggest[0]:
                        biggest = (per_card, f"{mesh.tag} {arch} x {shape}")
                    extra = f" per_card={per_card / 1e9:.3f} GB " \
                        f"fits={rec['fits']}"
                if st == "ok":
                    r = rec["roofline"]
                    extra += (f" dominant={r['dominant']}"
                              f" bound={r['bound_s']:.4g}s"
                              f" trace={rec['trace_s']}s")
                print(f"[{mesh.tag}] {arch} x {shape}: {st}{extra}",
                      flush=True)
    what = "peak" if compile_ else "arguments"
    print(f"dry-run summary: ok={n_ok} skipped={n_skip} failed={n_fail} "
          f"largest_per_card={biggest[0]} ({what}: {biggest[1]})",
          flush=True)
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
