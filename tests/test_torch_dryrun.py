"""The port's placement helpers and dry-run (``repro_torch.models.lm``'s
sharding helpers and abstract inputs, ``common.abstract_params``,
``launch/dryrun.py``) against the JAX package's on the same meshes.

The JAX side runs in a subprocess with 4 fake XLA devices (this file is
its own script: ``python tests/test_torch_dryrun.py --jax-ref OUT``) and
writes, for every case, the shard shape of every leaf (``NamedSharding.
shard_shape``, or the error it raises) and the spec it chose; the port's
side runs here on meta tensors (``common.shard_shape``).  Specs compare
after normalisation (an axis name as a 1-tuple, None as (), padded to
the rank).  Bars: equal, shape for shape and spec for spec.

Meshes: ``fsdp_param_sharding``, ``zero1_sharding``, ``sanitize_specs``
and ``_reshard_cache_seq`` on (1, 4), (2, 2) and (4, 1) over a table of
shapes; ``input_specs`` and ``abstract_state`` for all ten
architectures x four shapes on (1, 4) and (2, 2) (cells skipped alike,
``tp_pad_config`` alike); ``launch.dryrun.main`` over every architecture
and ``dglmnet`` on the port's meshes of 1 and 4 cards.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
SRC = REPO / "src"
THIS = pathlib.Path(__file__).resolve()
MESHES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}
CELL_MESHES = ("1x4", "2x2")
# (shape, spec) cases of the spec helpers: divisible, ragged, tiny,
# vectors, stacked layers, already split on model (zero1 takes the specs
# of parameters, which never name "data")
SHAPES = [(4, 7), (3, 5), (8,), (1,), (6, 12), (2, 4, 8), (16, 3, 5),
          (7, 11, 13), (4096, 3072), (32, 8, 128), (1, 1, 4)]
SPECS = [(None, None), (None,), ("model", None), (None, "model"),
         (None, None, "model"), ("model", None, None)]
ARCH_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _norm(spec, ndim):
    """A spec as a list of tuples (axis names a dim), padded to ``ndim``."""
    out = []
    for s in list(spec) + [None] * (ndim - len(spec)):
        out.append(() if s is None else (s,) if isinstance(s, str)
                   else tuple(s))
    return [list(t) for t in out]


def _cache_def_cases():
    """(shape, spec) cache tensors: a KV cache (batch, s_max, kv heads,
    head dim) and a recurrent state (batch, heads, hd, hd)."""
    return [((8, 64, 4, 16), ("data", None, "model", None)),
            ((2, 64, 4, 16), ("data", None, "model", None)),
            ((3, 4, 16, 16), ("data", "model", None, None)),
            ((1, 64, 2, 16), ("data", None, "model", None))]


# ---------------------------------------------------------------------------
# JAX's side (fake devices)
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts and named tuples, '/'-joined."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), f"{prefix}{k}/"))
    elif tree is not None:
        out[prefix.rstrip("/")] = tree
    return out


def _jax_leaf(x):
    try:
        shard = list(x.sharding.shard_shape(x.shape)) \
            if x.sharding is not None else list(x.shape)
    except ValueError:
        shard = "raises"
    # no sharding: whole on every device
    spec = _norm(x.sharding.spec if x.sharding is not None else (),
                 len(x.shape))
    return {"shape": list(x.shape), "shard": shard, "spec": spec,
            "dtype": str(x.dtype)}


def _jax_ref(out: str) -> int:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.configs import SHAPES as J_SHAPES
    from repro.configs.base import cell_is_runnable, tp_pad_config
    from repro.configs.registry import ARCHS, get_arch
    from repro.models import lm
    from repro.models.common import ParamDef

    devs = np.array(jax.devices()[:4])
    R = {"helpers": {}, "cells": {}}
    for tag, sizes in MESHES.items():
        mesh = Mesh(devs.reshape(sizes), ("data", "model"))
        H = R["helpers"][tag] = {}
        for shape in SHAPES:
            H[f"fsdp/{shape}"] = _norm(
                lm.fsdp_param_sharding(shape, mesh).spec, len(shape))
            for spec in SPECS:
                if len(spec) > len(shape):
                    continue
                sds = jax.ShapeDtypeStruct(
                    shape, jnp.float32, sharding=NamedSharding(mesh,
                                                               P(*spec)))
                H[f"zero1/{shape}/{spec}"] = _norm(
                    lm.zero1_sharding(sds, mesh).spec, len(shape))
        for i, (shape, spec) in enumerate(_cache_def_cases()):
            d = {"c": ParamDef(shape, P(*spec))}
            H[f"sanitize/{i}"] = _norm(
                lm.sanitize_specs(d, mesh)["c"].spec, len(shape))
            for dp in (("data",), "data"):
                r = lm._reshard_cache_seq(d, 64, dp)["c"]
                H[f"reshard/{i}/{dp}"] = _norm(r.spec, len(shape))
        if tag not in CELL_MESHES:
            continue
        for arch in sorted(ARCHS):
            for shape_name in ARCH_SHAPES:
                cfg, shape = get_arch(arch), J_SHAPES[shape_name]
                ok, why = cell_is_runnable(cfg, shape)
                cell = {"runnable": ok, "reason": why}
                if ok:
                    cfg, pads = tp_pad_config(cfg, mesh.shape["model"])
                    cell["pads"] = {k: list(v) for k, v in pads.items()}
                    batch, caches, cache_len, token = lm.input_specs(
                        cfg, shape, mesh)
                    params, opt = lm.abstract_state(
                        cfg, mesh, with_opt=shape.kind == "train")
                    tree = {"batch": batch, "caches": caches,
                            "params": params, "opt": opt}
                    if token is not None:
                        tree["token"] = token
                    cell["leaves"] = {k: _jax_leaf(v)
                                      for k, v in _flat(tree).items()}
                R["cells"][f"{tag}/{arch}/{shape_name}"] = cell
    pathlib.Path(out).write_text(json.dumps(R))
    return 0


# ---------------------------------------------------------------------------
# the session's JAX run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "jax.json"
    env = dict(os.environ, PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(THIS), "--jax-ref", str(out)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


def _port_mesh(tag):
    from repro_torch.launch.mesh import AbstractMesh
    return AbstractMesh(MESHES[tag])


def _port_leaf(t, mesh):
    from repro_torch.models import common
    try:
        shard = list(common.shard_shape(t.shape, t.spec, mesh))
    except ValueError:
        shard = "raises"
    return {"shape": list(t.shape), "shard": shard,
            "spec": _norm(t.spec, t.dim())}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", sorted(MESHES))
def test_spec_helpers_make_jaxs_choices(jax_ref, tag):
    """fsdp_param_sharding, zero1_sharding, sanitize_specs and
    _reshard_cache_seq choose JAX's dims and axes, fallbacks included."""
    import torch

    from repro_torch.models import common, lm
    mesh = _port_mesh(tag)
    want = jax_ref["helpers"][tag]
    got = {}
    for shape in SHAPES:
        got[f"fsdp/{shape}"] = _norm(lm.fsdp_param_sharding(shape, mesh),
                                     len(shape))
        for spec in SPECS:
            if len(spec) > len(shape):
                continue
            t = torch.empty(shape, device="meta")
            t.spec = spec
            got[f"zero1/{shape}/{spec}"] = _norm(lm.zero1_sharding(t, mesh),
                                                 len(shape))
    for i, (shape, spec) in enumerate(_cache_def_cases()):
        d = {"c": common.ParamDef(shape, spec)}
        got[f"sanitize/{i}"] = _norm(lm.sanitize_specs(d, mesh)["c"].spec,
                                     len(shape))
        for dp in (("data",), "data"):
            r = lm._reshard_cache_seq(d, 64, dp)["c"]
            got[f"reshard/{i}/{dp}"] = _norm(r.spec, len(shape))
    assert got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


def test_zero1_and_fsdp_sharding_choices():
    """tests/test_sharding_utils.py's contract on the port: on a mesh of
    one ``data`` device zero1 takes the first free divisible dim, and
    fsdp splits the first dim (everything divides 1)."""
    import torch

    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.lm import fsdp_param_sharding, zero1_sharding
    mesh = AbstractMesh((1,), ("data",))
    sds = torch.empty((4, 7), device="meta")
    sds.spec = (None, None)
    assert zero1_sharding(sds, mesh)[0] in (("data",), "data")
    assert fsdp_param_sharding((3, 5), mesh)[0] in (("data",), "data")


@pytest.mark.parametrize("tag", CELL_MESHES)
@pytest.mark.parametrize("shape_name", ARCH_SHAPES)
def test_abstract_inputs_match_jax(jax_ref, tag, shape_name):
    """input_specs and abstract_state: for every architecture the same
    leaves with JAX's shape, spec and shard shape (or both raise), the
    same skipped cells and the same tp padding."""
    from repro_torch.configs import SHAPES as T_SHAPES
    from repro_torch.configs.base import cell_is_runnable, tp_pad_config
    from repro_torch.configs.registry import ARCHS, get_arch
    from repro_torch.models import lm
    mesh = _port_mesh(tag)
    n_cells = 0
    for arch in sorted(ARCHS):
        want = jax_ref["cells"][f"{tag}/{arch}/{shape_name}"]
        cfg, shape = get_arch(arch), T_SHAPES[shape_name]
        ok, why = cell_is_runnable(cfg, shape)
        assert (ok, why) == (want["runnable"], want["reason"])
        if not ok:
            continue
        cfg, pads = tp_pad_config(cfg, mesh.shape["model"])
        assert {k: list(v) for k, v in pads.items()} == want["pads"]
        batch, caches, cache_len, token = lm.input_specs(cfg, shape, mesh)
        params, opt = lm.abstract_state(cfg, mesh,
                                        with_opt=shape.kind == "train")
        tree = {"batch": batch, "caches": caches, "params": params,
                "opt": opt}
        if token is not None:
            tree["token"] = token
        got = {k: _port_leaf(v, mesh) for k, v in _flat(tree).items()}
        assert got.keys() == want["leaves"].keys(), (arch, sorted(
            set(got) ^ set(want["leaves"]))[:8])
        for k, g in got.items():
            w = want["leaves"][k]
            assert (g["shape"], g["shard"], g["spec"]) == \
                (w["shape"], w["shard"], w["spec"]), (arch, k, g, w)
        n_cells += 1
    # long_500k runs only the four sub-quadratic architectures
    assert n_cells == (4 if shape_name == "long_500k" else 10)


@pytest.mark.parametrize("tag,shape_name", [
    ("1x4", "prefill_32k"), ("1x4", "decode_32k"), ("2x2", "long_500k"),
    ("4x1", "long_500k")])
def test_init_cache_blocks_are_the_dryruns(tag, shape_name):
    """A rank's blocks of ``init_cache(layout=)`` hold the bytes a card of
    the dry-run's caches (``input_specs``) holds, float32 on both sides,
    for every runnable architecture: the prefill and decode cells on (1,
    4), and long_500k at batch 1 below a data axis of 2 and of 4 (the KV
    caches' sequence over ``data``).  The blocks are meta tensors, so
    nothing is allocated."""
    from repro_torch.configs import SHAPES as T_SHAPES
    from repro_torch.configs.base import cell_is_runnable, tp_pad_config
    from repro_torch.configs.registry import ARCHS, get_arch
    from repro_torch.models import common, lm
    import torch

    from repro_torch.sharding import tensor_parallel as tp
    mesh = _port_mesh(tag)
    lay = tp.Layout.__new__(tp.Layout)
    lay.D, lay.M = mesh.sizes
    lay.d = lay.m = 0
    shape = T_SHAPES[shape_name]
    n_cells = 0
    for arch in sorted(ARCHS):
        cfg = get_arch(arch)
        if not cell_is_runnable(cfg, shape)[0]:
            continue
        cfg, _ = tp_pad_config(cfg, mesh.shape["model"])
        _, caches, _, _ = lm.input_specs(cfg, shape, mesh)
        want = sum(4 * math.prod(common.shard_shape(t.shape, t.spec, mesh))
                   for t in _flat(caches).values())
        blocks = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                               device="meta", layout=lay)
        got = _flat(blocks)
        assert sum(t.numel() * t.element_size() for t in got.values()) \
            == want, arch
        assert all(t.dtype == torch.float32 for t in got.values())
        n_cells += 1
    assert n_cells == (4 if shape_name == "long_500k" else 10)


def test_dryrun_main_records(tmp_path, capsys):
    """launch.dryrun.main --no-compile over every architecture and
    dglmnet on the meshes of 1 and 4 cards: no failure; parameter counts
    equal roofline.model.count_params of the placed config; per-card
    bytes equal the sum of the leaves' blocks, which on one card are the
    whole leaves and on four sum, over the cards, to each leaf's bytes
    once a split."""
    from repro_torch.configs import SHAPES as T_SHAPES
    from repro_torch.configs.base import tp_pad_config
    from repro_torch.configs.registry import ARCHS, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_FP32, abstract_mesh
    from repro_torch.models import common, lm
    from repro_torch.roofline import model as roof

    assert dryrun.main(["--arch", "all", "--mesh", "both", "--no-compile",
                        "--out", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "dglmnet", "--mesh", "both",
                        "--no-compile", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "failed=0" in out
    n_ok = 0
    for n in (1, 4):
        mesh = abstract_mesh(n)
        for arch in sorted(ARCHS):
            for shape_name in ARCH_SHAPES:
                rec = json.loads((tmp_path / mesh.tag /
                                  f"{arch}__{shape_name}.json").read_text())
                if rec["status"] == "skipped":
                    continue
                assert rec["status"] == "lowered", rec
                cfg, _ = tp_pad_config(get_arch(arch), n)
                shape = T_SHAPES[shape_name]
                assert rec["param_count"] == roof.count_params(cfg)[0]
                params, opt = lm.abstract_state(
                    cfg, mesh, with_opt=shape.kind == "train")
                whole = blocks = 0
                for t in _flat({"p": params}).values():
                    full = math.prod(t.shape) * t.element_size()
                    split = math.prod(mesh.shape[a] for i in range(t.dim())
                                      for a in common.spec_axes(t.spec, i))
                    whole += full
                    blocks += full // split
                    assert math.prod(common.shard_shape(
                        t.shape, t.spec, mesh)) * t.element_size() \
                        == full // split
                b = rec["bytes_per_card"]
                assert b["params"] == blocks
                if n == 1:
                    assert b["params"] == whole == rec["param_count"] * (
                        2 if cfg.dtype == "bfloat16" else 4)
                assert b["total"] == sum(v for k, v in b.items()
                                         if k != "total")
                assert rec["model_flops"] == roof.model_flops(cfg, shape)
                assert rec["terms"]["compute_s"] == pytest.approx(
                    rec["model_flops"] / (n * PEAK_FLOPS_FP32))
                assert rec["terms"]["memory_s"] == pytest.approx(
                    b["total"] / HBM_BW)
                assert "activations" in rec["not_counted"]
                if shape.kind == "train":
                    moments = sum(
                        math.prod(common.shard_shape(t.shape, t.spec, mesh))
                        * 4 for t in _flat({"m": opt.m, "v": opt.v}).values())
                    assert b["moments"] == moments + 4     # + the count
                n_ok += 1
        for shape_name in ("glm_web", "glm_tall", "glm_sparse"):
            rec = json.loads((tmp_path / mesh.tag /
                              f"dglmnet__{shape_name}.json").read_text())
            assert rec["status"] == "lowered"
            assert rec["design"] == ("bricks" if shape_name == "glm_sparse"
                                     else "dense")
            b = rec["bytes_per_card"]
            assert b["total"] == sum(v for k, v in b.items() if k != "total")
    assert n_ok == 2 * 34           # 10 architectures x 4 shapes, 6 skipped


# one architecture a family, each at a depth of two blocks of its kinds
TRACED_CELLS = [("phi4-mini-3.8b", "train_4k", {"n_layers": 2}),
                ("deepseek-v2-lite-16b", "prefill_32k", {"n_layers": 2}),
                ("zamba2-1.2b", "decode_32k", {"n_layers": 7}),
                ("xlstm-1.3b", "long_500k", {"n_layers": 16}),
                ("llama-3.2-vision-11b", "decode_32k", {"n_layers": 10}),
                ("whisper-tiny", "train_4k", {})]


@pytest.mark.parametrize("arch,shape_name,overrides", TRACED_CELLS,
                         ids=[c[0] for c in TRACED_CELLS])
def test_traced_cell_records(arch, shape_name, overrides):
    """A traced cell of each family on (1, 1), its depth cut to two blocks
    of each kind: the reference's fields (``memory``, ``profile``,
    ``roofline``, ``model_flops``, ``hlo_flops_total``,
    ``useful_compute_ratio``), ``fits`` from the peak, the arguments the
    placement's bytes, and the roofline terms from the profile."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES,
                                         NVLINK_BW_PER_LINK, PEAK_FLOPS_FP32,
                                         abstract_mesh)
    rec = dryrun.lower_cell(arch, shape_name, abstract_mesh(1),
                            overrides=overrides)
    assert rec["status"] == "ok", rec.get("error")
    mem, prof, roof = rec["memory"], rec["profile"], rec["roofline"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "alias_bytes", "peak_bytes_est"}
    assert mem["peak_bytes_est"] == mem["argument_bytes"] + \
        mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"]
    assert rec["fits"] == (mem["peak_bytes_est"] <= HBM_BYTES)
    # a decode's cache length is a host int: the placement counts its 4
    # bytes, the trace does not
    assert mem["argument_bytes"] == rec["bytes_per_card"]["total"] - (
        4 if rec["kind"] == "decode" else 0)
    assert mem["temp_bytes"] > 0
    if rec["kind"] == "train":
        # parameters and moments updated in place
        assert mem["alias_bytes"] >= rec["bytes_per_card"]["params"] + \
            rec["bytes_per_card"]["moments"] - 4
    assert prof["flops"] > 0 and prof["bytes_accessed"] > 0
    assert prof["collective_bytes"] == 0 and prof["collective_counts"] == {}
    assert rec["hlo_flops_total"] == prof["flops"]
    assert rec["useful_compute_ratio"] == pytest.approx(
        rec["model_flops"] / prof["flops"])
    assert roof["compute_s"] == pytest.approx(prof["flops"] /
                                              PEAK_FLOPS_FP32)
    assert roof["memory_s"] == pytest.approx(prof["bytes_accessed"] /
                                             HBM_BW)
    assert roof["collective_s"] == 0 * NVLINK_BW_PER_LINK
    assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"])
    assert "not_counted" not in rec


if __name__ == "__main__":
    if "--jax-ref" in sys.argv:
        sys.exit(_jax_ref(sys.argv[sys.argv.index("--jax-ref") + 1]))
