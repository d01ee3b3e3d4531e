"""Dry-run: every (architecture x input shape) placed abstractly on the
port's meshes of 1 and 4 cards, with its per-card bytes and roofline
terms.

A port of the JAX package's ``repro.launch.dryrun``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both

The reference lowers and compiles each cell's step with XLA on the TPU
pod's production meshes and reads XLA's ``memory_analysis``; neither has a
counterpart here.  The port places the step's arguments as meta tensors
(``models.lm.input_specs`` and ``abstract_state``: nothing is allocated)
on ``launch.mesh.abstract_mesh(1)`` (1, 1) and ``abstract_mesh(4)``
(1, 4), and each record
(``results/dryrun_torch/<mesh><tag>/<arch>__<shape>.json``, or under
``--out``) holds:

  * ``status`` ("ok", "skipped" with ``reason`` by
    ``configs.base.cell_is_runnable``, or "failed" with the traceback)
    and ``tp_padding`` (``configs.base.tp_pad_config`` under tp);
  * ``bytes_per_card``: one card's block of the step's arguments by
    placement (``params``, ``moments`` with the step count, ``caches``,
    ``batch`` with a decode's token and cache length, ``total``), and
    ``fits`` against ``launch.mesh.HBM_BYTES``; activations and
    temporaries are not counted (``not_counted``);
  * ``param_count`` (``roofline.model.count_params`` of the config placed,
    padding included) and ``model_flops`` (``roofline.model.model_flops``);
  * ``terms``: ``compute_s`` = model flops / (cards x ``PEAK_FLOPS_FP32``)
    and ``memory_s`` = per-card bytes / ``HBM_BW``.

``--arch dglmnet`` places the paper's workload (``configs.glm_webscale``):
rows over ``data``, feature blocks over ``model``, the design as bricks
where the shape's occupancy is below 1 (the reference's brick count and
row padding) and as a dense block otherwise.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import traceback
from typing import Optional

from repro_torch.configs import GLM_SHAPES, SHAPES
from repro_torch.configs.base import cell_is_runnable, tp_pad_config
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, PEAK_FLOPS_FP32,
                                     abstract_mesh)
from repro_torch.models import common, lm
from repro_torch.roofline import model as roof

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"
MESHES = {"1": 1, "4": 4}
NOT_COUNTED = "activations and temporaries of the step (no compiler here)"


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


def lower_cell(arch_name: str, shape_name: str, mesh, *,
               overrides: Optional[dict] = None) -> dict:
    """One cell's record on ``mesh`` (an ``AbstractMesh``).
    ``overrides``: ``ArchConfig.replace`` keywords (parallelism,
    seq_shard, ...)."""
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    runnable, why = cell_is_runnable(cfg, shape)
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh.tag,
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
    rec.update(status="ok", n_cards=n_cards, bytes_per_card=parts,
               fits=parts["total"] <= HBM_BYTES, hbm_bytes=HBM_BYTES,
               not_counted=NOT_COUNTED,
               param_count=roof.count_params(cfg)[0], model_flops=flops,
               terms=_terms(flops, parts["total"], n_cards))
    return rec


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


def lower_glm_cell(shape_name: str, mesh, *, coupling: str = "jacobi",
                   compress=None) -> dict:
    """The paper's own workload on ``mesh``: its per-card bytes and the
    model flops of one superstep, ``occupancy x (2 n p T + 4 n p)`` (the
    tile Grams and the gradient and margin products), as the reference
    counts them."""
    gs = GLM_SHAPES[shape_name]
    b = glm_card_bytes(shape_name, mesh)
    n, p, T = gs.n_examples, gs.n_features, gs.tile_size
    flops = b["occupancy"] * (2.0 * n * p * T + 4.0 * n * p)
    n_cards = math.prod(mesh.sizes)
    total = b["bytes"]["total"]
    return {"arch": "dglmnet", "shape": shape_name, "mesh": mesh.tag,
            "kind": "glm", "coupling": coupling, "compress": compress,
            "design": b["design_kind"], "occupancy": b["occupancy"],
            "status": "ok", "n_cards": n_cards, "bytes_per_card": b["bytes"],
            "fits": total <= HBM_BYTES, "hbm_bytes": HBM_BYTES,
            "not_counted": NOT_COUNTED, "model_flops": flops,
            "terms": _terms(flops, total, n_cards)}


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
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", default="",
                    help="comma-separated ArchConfig overrides, e.g. "
                         "'parallelism=fsdp,seq_shard=False'")
    ap.add_argument("--out", default=str(RESULTS),
                    help="directory of the records")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.override)
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
                            shape, mesh,
                            coupling=overrides.get("coupling", "jacobi"),
                            compress=overrides.get("compress"))
                    else:
                        rec = lower_cell(arch, shape, mesh,
                                         overrides=overrides or None)
                except Exception:
                    rec = {"arch": arch, "shape": shape, "mesh": mesh.tag,
                           "status": "failed",
                           "error": traceback.format_exc(limit=20)}
                (outdir / f"{arch}__{shape}.json").write_text(
                    json.dumps(rec, indent=2))
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_fail += st == "failed"
                extra = ""
                if st == "ok":
                    total = rec["bytes_per_card"]["total"]
                    if total > biggest[0]:
                        biggest = (total, f"{mesh.tag} {arch} x {shape}")
                    extra = (f" per_card={total / 1e9:.3f} GB"
                             f" fits={rec['fits']}")
                print(f"[{mesh.tag}] {arch} x {shape}: {st}{extra}",
                      flush=True)
    print(f"dry-run summary: ok={n_ok} skipped={n_skip} failed={n_fail} "
          f"largest_per_card={biggest[0]} ({biggest[1]})", flush=True)
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
