"""Serving on a (data, model) mesh of CPU processes (gloo): prefill and
greedy decode of every LM family, the caches laid out by their specs,
held against the JAX package's jitted ``make_prefill_step`` /
``make_decode_step`` on the same meshes (fake XLA devices, parameters
and caches ``device_put`` to the reference's own shardings).

The module is also its own worker and reference script:

  * ``python tests/test_torch_serve_sharded.py --worker W --root DIR``
    runs as one rank of a port world (``repro_torch.dist.launcher``,
    ``backend="gloo"``, ``device="cpu"``) and writes
    ``DIR/<W>_rank<r>.json``;
  * ``--jax-job J DIR`` (4 fake devices) runs JAX's side of the cases of
    ``JAX_JOBS[J]``.

Configs (``CONFIGS``): the smoke configs of
``tests/test_torch_train_sharded_families.py`` (mixtral and
llama-3.2-vision with 4 KV heads, deepseek with 8 and 16 experts,
zamba2, xlstm, whisper), phi4-mini with ``test_torch_train_sharded.py``'s
8 heads and 4 KV heads (``dense``), and gemma3-12b at the same head
counts with a softcap of 50 (``gemma``: its sliding window, local:global
layers and a softcap, which gemma3's own config leaves off).

Cases: every config on (1, 2) with sequence parallelism on and off, on
(1, 4) and on (2, 2); zamba2 at batch 1 on (2, 1) and (2, 2) and gemma
at batch 1 on (2, 1), where the KV caches' sequence is split over
``data`` (the reference's ``_reshard_cache_seq``; gemma's window then
crosses the blocks).  Each case: a prefill of 8 x 32 tokens (whisper: its
32 frames and 16 tokens), then 8 greedy decode steps, each side taking
its own argmax; the batch-1 cases hold a cache of 72 positions, so the
decode crosses the data blocks' boundary (36).  ``launch.serve.generate``
serves each case's request once more.

Weights: N(0, 0.02^2) matrices and N(0, 0.1^2) vectors (the reference's
own init is chaotic in float32, ROADMAP Queue 3 item 14); the MoE keeps
its capacity of 1.5, and the seeds keep every router's k-th and (k+1)-th
logits apart over the served tokens (``test_router_margins_stay_off_
ties``).

Bars: every step's logits within 1e-5 of the largest |logit|, each cache
leaf gathered to full within 1e-5 of its largest entry after the prefill
and after the last step, the greedy tokens equal.
"""
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
SRC = REPO / "src"
THIS = pathlib.Path(__file__).resolve()
WORLD_TIMEOUT_S = 240
# key: (architecture, ArchConfig.replace)
CONFIGS = {"dense": ("phi4-mini-3.8b", dict(n_heads=8, n_kv_heads=4)),
           "gemma": ("gemma3-12b", dict(n_heads=8, n_kv_heads=4,
                                        attn_softcap=50.0)),
           "deepseek": ("deepseek-v2-lite-16b", {}),
           "deepseek_ep": ("deepseek-v2-lite-16b", dict(n_experts=16)),
           "mixtral": ("mixtral-8x7b", dict(n_kv_heads=4)),
           "zamba2": ("zamba2-1.2b", {}),
           "xlstm": ("xlstm-1.3b", {}),
           "llama_vision": ("llama-3.2-vision-11b", dict(n_kv_heads=4)),
           "whisper": ("whisper-tiny", {})}
# key: (mesh, ArchConfig.replace)
MESHES = {"1x2_sp": ((1, 2), dict(seq_shard=True)),
          "1x2": ((1, 2), dict(seq_shard=False)),
          "1x4_sp": ((1, 4), dict(seq_shard=True)),
          "2x2_sp": ((2, 2), dict(seq_shard=True)),
          "2x1": ((2, 1), {})}
B, S, STEPS = 8, 32, 8
S_WHISPER = 16
S_MAX_B1 = 72                      # batch 1: the decode crosses 36
CASES = [f"{c}/{m}" for m in ("1x2_sp", "1x2", "1x4_sp", "2x2_sp")
         for c in CONFIGS] + ["zamba2_b1/2x1", "zamba2_b1/2x2_sp",
                              "gemma_b1/2x1"]
JAX_JOBS = {"a": [c for c in CASES if c.endswith("/1x2_sp")],
            "b": [c for c in CASES if c.endswith(("/1x2", "/2x1"))],
            "c": [c for c in CASES if c.endswith("/1x4_sp")],
            "d": [c for c in CASES if c.endswith("/2x2_sp")]}
TOL = 1e-5
MARGIN_MIN = 1e-5                  # router logits: 100x their rounding
# the weights' seeds; the MoE configs' chosen for the widest router
# margin over the served tokens (test_router_margins_stay_off_ties)
SEEDS = {"deepseek": 22, "deepseek_ep": 17, "mixtral": 29}


def case_parts(case: str):
    """(config key, mesh key, mesh shape, the config's replace, batch,
    cache length, prompt length)."""
    ckey, mkey = case.split("/")
    b1 = ckey.endswith("_b1")
    ckey = ckey.removesuffix("_b1")
    shape, rep = MESHES[mkey]
    seq = S_WHISPER if ckey == "whisper" else S
    return (ckey, mkey, shape, {**CONFIGS[ckey][1], **rep}, 1 if b1 else B,
            S_MAX_B1 if b1 else seq + STEPS, seq)


def weights_seed(ckey: str) -> int:
    return SEEDS.get(ckey, 11 + list(CONFIGS).index(ckey))


def make_batch(cfg, rows, seq, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (rows, seq))
           .astype(np.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.normal(
            size=(rows, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["audio_embeds"] = rng.normal(
            size=(rows, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return out


def smoke_weights(defs_flat: dict, seed: int) -> dict:
    """{name: array} over a flat {name: shape}: N(0, 0.02^2) matrices,
    N(0, 0.1^2) vectors."""
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * (0.1 if len(s) < 2 else 0.02))
            .astype(np.float32) for k, s in defs_flat.items()}


def _digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def _flat(tree, prefix=""):
    """{"a.b.c": leaf} of a nested dict (sorted keys)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _name(case: str) -> str:
    return case.replace("/", "__")


# ---------------------------------------------------------------------------
# the port's worlds (worker mode)
# ---------------------------------------------------------------------------

def _port_cfg(ckey, **replace):
    from repro_torch.configs.registry import smoke_variant
    arch, rep = CONFIGS[ckey]
    return smoke_variant(arch).replace(**{**rep, **replace})


def _blocks(cfg, state: dict, lay) -> dict:
    """This rank's blocks of a full model state."""
    from repro_torch.models import common, lm, transformer
    specs = {k: d.spec for k, d in
             common.flatten(lm.param_defs(cfg)).items()}
    out = {}
    for k, t in state.items():
        parts = k.split(".")
        if parts[0] in transformer.STACKED:
            del parts[1]
            spec = specs[".".join(parts)][1:]
        else:
            spec = specs[k]
        out[k] = lay.block(t, spec)
    return out


def _full(t, spec, lay):
    """The full array of this rank's block ``t`` laid out by ``spec``."""
    from repro_torch.models.common import spec_axes
    from repro_torch.sharding import tensor_parallel as tp
    for i in range(t.ndim):
        for axis in spec_axes(spec, i):
            t = tp.all_gather(t, lay.data if axis == "data" else lay.model,
                              i)
    return t


def _port_model(root, ckey, rep, lay):
    from repro_torch import convert
    from repro_torch.models import common, lm
    cfg = _port_cfg(ckey, **rep)
    with np.load(root / f"weights_{ckey}.npz") as z:
        tree = common.unflatten({k: z[k] for k in z.files})
    state = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    return lm.build_model(cfg, state=_blocks(cfg, state, lay), layout=lay)


def _port_case(root, case, lay):
    """The case's prefill and decode steps on this rank's rows and blocks:
    the digest of the full results, the collectives of the steps, the
    greedy tokens; rank 0 writes the full logits and caches.  Then
    ``generate`` on the whole request."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.sharding import collectives
    from repro_torch.sharding import tensor_parallel as tp

    ckey, _, _, rep, rows_n, s_max, seq = case_parts(case)
    model = _port_model(root, ckey, rep, lay)
    cfg = model.cfg
    batch = {k: torch.from_numpy(v).to(torch.int64 if k == "tokens"
                                       else torch.float32)
             for k, v in make_batch(cfg, rows_n, seq).items()}
    rows = lm.served_rows(rows_n, lay)
    mine = {k: v[rows] for k, v in batch.items()}
    extra = {k: v for k, v in mine.items() if k != "tokens"}
    caches = lm.init_cache(cfg, rows_n, s_max, device="cpu", layout=lay)
    prefill = lm.make_prefill_step(model)
    decode = lm.make_decode_step(model)
    logits, snaps = [], []
    with collectives.collective_trace() as ev, torch.no_grad():
        lg, caches = prefill(caches, mine)
        logits.append(lg)
        snaps.append({k: v.clone() for k, v in _flat(caches).items()})
        for i in range(STEPS):
            tok = lg.argmax(dim=-1)[:, None]
            lg, caches = decode(caches, tok, seq + i, extra)
            logits.append(lg)
    snaps.append(_flat(caches))
    specs = {k: v.spec for k, v in _flat(caches).items()}
    split_rows = rows != slice(0, rows_n)
    full = {}
    for i, lg in enumerate(logits):
        full[f"logits/{i}"] = (tp.all_gather(lg, lay.data, 0) if split_rows
                               else lg).numpy()
    for when, snap in zip(("prefill", "last"), snaps):
        for k, t in snap.items():
            full[f"cache_{when}/{k}"] = _full(t, specs[k], lay).numpy()
    if lay.d == 0 and lay.m == 0:
        np.savez(root / f"port_{_name(case)}.npz", **full)
    tokens = np.stack([full[f"logits/{i}"].argmax(-1)
                       for i in range(STEPS + 1)], 1)
    with torch.no_grad():
        rec = serve.generate(model, batch["tokens"], STEPS + 1,
                             extra={k: v for k, v in batch.items()
                                    if k != "tokens"}, keep_logits=True)
    return {"digest": _digest(full), "tokens": tokens.tolist(),
            "collectives": len(ev),
            "collective_digest": hashlib.sha256(
                json.dumps(ev).encode()).hexdigest(),
            "block_bytes": sum(t.numel() * t.element_size()
                               for t in snaps[-1].values()),
            "generate_tokens": rec["tokens"],
            "generate_logits_rel": max(
                _rel(rec["logits"][:, i].numpy(), full[f"logits/{i}"])
                for i in range(STEPS + 1))}


def _worker_main(argv) -> int:
    import argparse

    import torch

    from repro_torch.dist import bootstrap, faults
    from repro_torch.sharding import tensor_parallel as tp
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", required=True)
    ap.add_argument("--root", required=True)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    ctx = bootstrap.initialize(backend="gloo", device="cpu")
    root = pathlib.Path(a.root)
    t0 = time.perf_counter()
    R = {}
    shapes = ((1, 2), (2, 1)) if a.worker == "W2" else ((1, 4), (2, 2))
    for shape in shapes:
        lay = tp.Layout(bootstrap.make_dist_mesh(*shape))
        for case in CASES:
            if case_parts(case)[2] == shape:
                R[case] = _port_case(root, case, lay)
    R["seconds"] = time.perf_counter() - t0
    (root / f"{a.worker}_rank{ctx.process_id}.json").write_text(
        json.dumps(R))
    faults.guarded_barrier("serve-sharded-exit")
    bootstrap.shutdown()
    return 0


# ---------------------------------------------------------------------------
# JAX's side (fake devices)
# ---------------------------------------------------------------------------

def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh
    n = shape[0] * shape[1]
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))


def _jax_cfg(ckey, **replace):
    from repro.configs import registry
    arch, rep = CONFIGS[ckey]
    return registry.smoke_variant(arch).replace(**{**rep, **replace})


def _jax_case(root, case) -> dict:
    """JAX's jitted prefill and decode steps of ``case`` on its mesh: the
    parameters and the caches laid out by the reference's own specs
    (``_reshard_cache_seq`` below the data extent, ``sanitize_specs``),
    the batch over ``data`` where it divides, inside the mesh's context
    (``_shard_h`` and ``_shard_moe`` see it)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.models import lm

    ckey, _, shape, rep, rows_n, s_max, seq = case_parts(case)
    cfg = _jax_cfg(ckey, **rep)
    prefill_step, model = lm.make_prefill_step(cfg)
    decode_step, _ = lm.make_decode_step(cfg)
    with np.load(root / f"weights_{ckey}.npz") as z:
        flat = {k: z[k] for k in z.files}
    batch = make_batch(cfg, rows_n, seq)
    mesh = _jax_mesh(shape)
    specs = _flat(model.param_defs())
    cdefs = model.cache_defs(rows_n, s_max)
    if rows_n < shape[0]:
        cdefs = lm._reshard_cache_seq(cdefs, s_max, ("data",))
    cspecs = _flat(lm.sanitize_specs(cdefs, mesh))
    bspec = P("data") if rows_n % shape[0] == 0 else P()
    with mesh:
        params = {k: jax.device_put(v, NamedSharding(mesh, specs[k].spec))
                  for k, v in flat.items()}
        params = _unflat(params)
        caches = {k: jax.device_put(v, NamedSharding(mesh, cspecs[k].spec))
                  for k, v in _flat(lm.init_cache(cfg, rows_n,
                                                  s_max)).items()}
        caches = _unflat(caches)
        jb = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, bspec))
              for k, v in batch.items()}
        extra = {k: v for k, v in jb.items() if k != "tokens"}
        pf, dc = jax.jit(prefill_step), jax.jit(decode_step)
        out = {}
        lg, caches = pf(params, caches, jb)
        out["logits/0"] = np.asarray(lg)
        out.update({f"cache_prefill/{k}": np.asarray(v)
                    for k, v in _flat(caches).items()})
        for i in range(STEPS):
            tok = jnp.argmax(lg, axis=-1)[:, None].astype(jnp.int32)
            lg, caches = dc(params, caches, tok, jnp.int32(seq + i), extra)
            out[f"logits/{i + 1}"] = np.asarray(lg)
        out.update({f"cache_last/{k}": np.asarray(v)
                    for k, v in _flat(caches).items()})
    np.savez(root / f"jax_{_name(case)}.npz", **out)
    tokens = np.stack([out[f"logits/{i}"].argmax(-1)
                       for i in range(STEPS + 1)], 1)
    return {"tokens": tokens.tolist()}


def _unflat(flat: dict) -> dict:
    out = {}
    for name, v in flat.items():
        *path, last = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _jax_job(job: str, root: pathlib.Path) -> int:
    R = {case: _jax_case(root, case) for case in JAX_JOBS[job]}
    (root / f"jax_{job}.json").write_text(json.dumps(R))
    return 0


# ---------------------------------------------------------------------------
# the fixture: the seed, every world and every JAX run, once
# ---------------------------------------------------------------------------

def _seed(root: pathlib.Path):
    from repro_torch.models import common, lm
    for ckey in CONFIGS:
        defs = {k: d.shape for k, d in
                common.flatten(lm.param_defs(_port_cfg(ckey))).items()}
        np.savez(root / f"weights_{ckey}.npz",
                 **smoke_weights(defs, weights_seed(ckey)))


def _jax_env(devices: int) -> dict:
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(SRC)
    for k in ("REPRO_DIST_COORD", "REPRO_DIST_PROCID", "REPRO_DIST_NPROCS"):
        env.pop(k, None)
    return env


def _start_jax(job, root):
    log = open(root / f"jax_{job}.log", "w")
    return subprocess.Popen([sys.executable, str(THIS), "--jax-job", job,
                             str(root)], stdout=log,
                            stderr=subprocess.STDOUT, env=_jax_env(4)), log


def _wait(job, timeout=WORLD_TIMEOUT_S):
    proc, log = job
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    log.close()
    text = pathlib.Path(log.name).read_text()
    assert rc == 0, f"{log.name}: exit {rc}\n{text[-4000:]}"


def _port_world(n, worker, root):
    from repro_torch.dist import launcher
    res = launcher.run_local(n, THIS, args=["--worker", worker, "--root",
                                            str(root)],
                             timeout_s=WORLD_TIMEOUT_S, grace_s=5)
    assert res.ok, res.summary()
    return [json.loads((root / f"{worker}_rank{r}.json").read_text())
            for r in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_sharded")
    _seed(root)
    jobs = {j: _start_jax(j, root) for j in JAX_JOBS}
    w2 = _port_world(2, "W2", root)
    w4 = _port_world(4, "W4", root)
    jax_r = {}
    for j, job in jobs.items():
        _wait(job)
        jax_r.update(json.loads((root / f"jax_{j}.json").read_text()))
    return {"root": root, "w2": w2, "w4": w4, "jax": jax_r}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _ranks(runs, case):
    return runs["w2"] if case_parts(case)[2] in ((1, 2), (2, 1)) \
        else runs["w4"]


def _load(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_serving_on_a_mesh_matches_jax(runs, case):
    """The prefill and 8 greedy decode steps on the case's mesh against
    JAX's jitted steps on the same mesh from the same weights and prompt:
    every step's logits within 1e-5 of the largest |logit|, each cache
    leaf gathered to full within 1e-5 of its largest entry after the
    prefill and after the last step, the greedy tokens equal; every rank
    holds the same full results."""
    ranks = _ranks(runs, case)
    assert len({r[case]["digest"] for r in ranks}) == 1
    assert ranks[0][case]["tokens"] == runs["jax"][case]["tokens"]
    pz = _load(runs["root"] / f"port_{_name(case)}.npz")
    jz = _load(runs["root"] / f"jax_{_name(case)}.npz")
    assert pz.keys() == jz.keys()
    for k in jz:
        assert pz[k].shape == jz[k].shape, (case, k)
        assert _rel(pz[k], jz[k]) <= TOL, (case, k, _rel(pz[k], jz[k]))


@pytest.mark.parametrize("case", CASES)
def test_generate_on_a_mesh_matches_the_steps(runs, case):
    """``launch.serve.generate`` of the case's whole request on every rank
    (each serving its rows, the record gathered over ``data``) returns
    JAX's greedy tokens, and logits within 1e-5 of the steps'."""
    for r in _ranks(runs, case):
        assert r[case]["generate_tokens"] == runs["jax"][case]["tokens"]
        assert r[case]["generate_logits_rel"] <= TOL


@pytest.mark.parametrize("world", ["w2", "w4"])
def test_ranks_record_the_same_collectives(runs, world):
    """Every rank of a world ran the same sequence of collectives in each
    case's steps, and every case ran some."""
    ranks = runs[world]
    cases = [k for k in ranks[0] if "/" in k]
    assert cases
    for case in cases:
        seqs = {(r[case]["collectives"], r[case]["collective_digest"])
                for r in ranks}
        assert len(seqs) == 1, (case, seqs)
        assert ranks[0][case]["collectives"] > 0


@pytest.mark.parametrize("case", [c for c in CASES if "_b1" in c])
def test_batch_one_splits_the_kv_sequence_over_data(runs, case):
    """At batch 1 below a data axis of 2 the KV caches' sequence is split
    over ``data`` (the reference's ``_reshard_cache_seq``): each rank
    holds half the positions of every KV leaf (and its model block of the
    heads), the recurrent states whole over ``data``; a rank's bytes are
    the dry-run's count for that layout."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import common, lm
    ckey, _, shape, rep, rows_n, s_max, _ = case_parts(case)
    cfg = _port_cfg(ckey, **rep)
    mesh = AbstractMesh(shape, ("data", "model"))
    defs = common.flatten(lm.cache_specs(cfg, rows_n, s_max, mesh))
    kv = {k: d for k, d in defs.items() if s_max in d.shape}
    assert kv
    for k, d in defs.items():
        blk = common.shard_shape(d.shape, d.spec, mesh)
        if k in kv:
            assert blk[2] == s_max // 2 and "data" in common.spec_axes(
                d.spec, 2), k
        assert blk[1] == d.shape[1], k
    want = sum(4 * np.prod(common.shard_shape(d.shape, d.spec, mesh))
               for d in defs.values())
    assert all(r[case]["block_bytes"] == want for r in _ranks(runs, case))


@pytest.mark.parametrize("ckey", ["deepseek", "deepseek_ep", "mixtral"])
def test_router_margins_stay_off_ties(runs, ckey):
    """The seeds keep the routers away from float32 ties over the served
    tokens: in a single-device prefill and the 8 decode steps (JAX's
    greedy tokens fed) the smallest gap between a token's k-th and
    (k+1)-th router logit, over every MoE layer, is above
    ``MARGIN_MIN``.  Measured: 2.0e-5 (deepseek), 2.8e-4 (deepseek_ep, its
    seed chosen among 11-40; the training test's 29 gave 7.0e-6 here),
    1.6e-4 (mixtral)."""
    import torch

    from repro_torch import convert
    from repro_torch.models import common, lm, moe
    cfg = _port_cfg(ckey)
    with np.load(runs["root"] / f"weights_{ckey}.npz") as z:
        tree = common.unflatten({k: z[k] for k in z.files})
    model = lm.build_model(cfg, state=convert.lm_params_from_numpy(
        cfg, tree, device="cpu"))
    gaps = []
    route = moe.route

    def spy(p, x, cfg_):
        logits = common.matmul(x, p["router"]).reshape(-1, cfg_.n_experts)
        top = torch.topk(logits, cfg_.top_k + 1, dim=-1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return route(p, x, cfg_)
    tokens = torch.from_numpy(make_batch(cfg, B, S)["tokens"]).long()
    want = np.asarray(runs["jax"][f"{ckey}/1x2_sp"]["tokens"])
    caches = lm.init_cache(cfg, B, S + STEPS, device="cpu")
    moe.route = spy
    try:
        with torch.no_grad():
            _, caches = lm.make_prefill_step(model)(caches,
                                                    {"tokens": tokens})
            step = lm.make_decode_step(model)
            for i in range(STEPS):
                tok = torch.from_numpy(want[:, i:i + 1]).long()
                _, caches = step(caches, tok, S + i)
    finally:
        moe.route = route
    assert len(gaps) == (STEPS + 1) * (cfg.n_layers - cfg.first_dense_layers)
    assert min(gaps) > MARGIN_MIN, gaps


if __name__ == "__main__":
    if "--worker" in sys.argv:
        sys.exit(_worker_main(sys.argv[1:]))
    if "--jax-job" in sys.argv:
        i = sys.argv.index("--jax-job")
        sys.exit(_jax_job(sys.argv[i + 1], pathlib.Path(sys.argv[i + 2])))
