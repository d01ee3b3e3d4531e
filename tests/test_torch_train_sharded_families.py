"""Tensor parallelism of the moe, hybrid, ssm, vlm and audio families on a
(data, model) mesh of CPU processes (gloo), held against the JAX
package's jitted train step and ``Trainer(mesh=)`` on the same meshes
(fake XLA devices).

The module is also its own worker and reference script:

  * ``python tests/test_torch_train_sharded_families.py --worker W --root
    DIR`` runs as one rank of a port world (``repro_torch.dist.launcher``,
    ``backend="gloo"``, ``device="cpu"``) and writes
    ``DIR/<W>_rank<r>.json``;
  * ``--jax-job J DIR`` (4 fake devices) runs JAX's side of the cases of
    ``JAX_JOBS[J]``.

Configs: the six smoke configs of ``tests/test_torch_train_sharded.py``'s
``OTHER``, replaced where the model axis of 4 must divide a split dim
(``CONFIGS``): mixtral and llama-3.2-vision with 4 KV heads (2 in the
smoke configs); plus deepseek with 16 experts (``deepseek_ep``: the smoke
config's 8 take the in-expert branch, 16 the expert-parallel one) and
xlstm with ``ssm_chunk=16`` (the chunkwise mLSTM).  Every other split dim
of the smoke configs divides 4.

Worlds: W2 (2 processes, mesh (1, 2)) runs one ``make_train_step`` step
of every config with sequence parallelism on and off, with
``parallelism="fsdp"`` for deepseek_ep and zamba2, and the chunkwise
xlstm; and 3-step trainers for deepseek_ep (checkpointed at step 2) and
xlstm.  W4 (4 processes) runs every config's step on (1, 4) and on
(2, 2), both sequence-parallel, and resumes deepseek_ep's (1, 2)
checkpoint on (1, 4).  JAX runs the same cases on the same meshes in
four processes at once, and resumes the port's checkpoint on (1, 4).
Every world runs under ``run_local``'s timeout.

Weights: N(0, 0.02^2) matrices and N(0, 0.1^2) vectors (the reference's
own init is chaotic in float32, ROADMAP Queue 3 item 14), batch 8 x 64
(a rank's 256 tokens: whole MoE groups); the MoE keeps its capacity of
1.5, so tokens drop, and the seeds keep every router's k-th and
(k+1)-th logits apart (``test_router_margins_stay_off_ties``).

Bars (``tests/test_torch_train_archs.py``'s): a step's loss 1e-5
relative, its grad norm 1e-4 relative, each gradient leaf (gathered over
``model`` to full) within 1e-4 of its largest entry, updated parameters
within 1e-7 where AdamW's first step is not near sign(g); the trainers'
losses 2e-4 relative over 3 steps (``tests/test_torch_train.py``'s).
"""
import hashlib
import json
import os
import pathlib
import shutil
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
CONFIGS = {"deepseek": ("deepseek-v2-lite-16b", {}),
           "deepseek_ep": ("deepseek-v2-lite-16b", dict(n_experts=16)),
           "mixtral": ("mixtral-8x7b", dict(n_kv_heads=4)),
           "zamba2": ("zamba2-1.2b", {}),
           "xlstm": ("xlstm-1.3b", {}),
           "xlstm_chunk": ("xlstm-1.3b", dict(ssm_chunk=16)),
           "llama_vision": ("llama-3.2-vision-11b", dict(n_kv_heads=4)),
           "whisper": ("whisper-tiny", {})}
FAMILIES = ("deepseek", "deepseek_ep", "mixtral", "zamba2", "xlstm",
            "llama_vision", "whisper")
# key: (mesh, ArchConfig.replace)
MESHES = {"1x2_sp": ((1, 2), dict(seq_shard=True)),
          "1x2": ((1, 2), dict(seq_shard=False)),
          "1x2_fsdp": ((1, 2), dict(parallelism="fsdp")),
          "1x4_sp": ((1, 4), dict(seq_shard=True)),
          "2x2_sp": ((2, 2), dict(seq_shard=True))}
STEP_CASES = [f"{c}/{m}" for m in ("1x2_sp", "1x2", "1x4_sp", "2x2_sp")
              for c in FAMILIES] + ["deepseek_ep/1x2_fsdp",
                                    "zamba2/1x2_fsdp", "xlstm_chunk/1x2_sp"]
TRAINERS = ("deepseek_ep", "xlstm")         # 3 steps on (1, 2)
JAX_JOBS = {"a": [c for c in STEP_CASES if c.endswith(("/1x2_sp",
                                                      "1x2_fsdp"))],
            "b": [c for c in STEP_CASES if c.endswith("/1x2")]
            + [f"trainer/{t}" for t in TRAINERS],
            "c": [c for c in STEP_CASES if c.endswith("/1x4_sp")],
            "d": [c for c in STEP_CASES if c.endswith("/2x2_sp")],
            "resume": ["resume/deepseek_ep"]}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=8)
B, S = 8, 64
T_STEPS, T_BATCH, T_SEQ = 3, 4, 64
STEP_LOSS, STEP_GRAD, STEP_PARAM = 1e-5, 1e-4, 1e-7
STEP_FLOOR = 1e3 * 1e-8              # 1000 AdamW eps
LOSS_RTOL = 2e-4
MARGIN_MIN = 1e-5                    # router logits: 100x their rounding


def case_parts(case: str):
    """(config key, mesh key, mesh shape, the config's replace)."""
    ckey, mkey = case.split("/")
    shape, rep = MESHES[mkey]
    return ckey, mkey, shape, {**CONFIGS[ckey][1], **rep}


# the weights' seeds; the MoE configs' chosen among 11-30 for the widest
# router margin (test_router_margins_stay_off_ties)
SEEDS = {"deepseek": 22, "deepseek_ep": 29, "mixtral": 29}


def weights_seed(ckey: str) -> int:
    return SEEDS.get(ckey, 11 + list(CONFIGS).index(ckey))


def make_batch(cfg, seed=1, rows=B, seq=S):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (rows, seq))
           .astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (rows, seq))
           .astype(np.int32),
           "loss_mask": (rng.random((rows, seq)) < 0.9).astype(np.float32)}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.normal(
            size=(rows, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["audio_embeds"] = rng.normal(
            size=(rows, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return out


def smoke_weights(defs_flat: dict, seed: int) -> dict:
    """{name: array} over a flat {name: shape} (the reference's sorted leaf
    order): N(0, 0.02^2) matrices, N(0, 0.1^2) vectors."""
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * (0.1 if len(s) < 2 else 0.02))
            .astype(np.float32) for k, s in defs_flat.items()}


def _digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def read_log(d: pathlib.Path) -> list:
    return [json.loads(ln) for ln in
            (d / "log.jsonl").read_text().splitlines()]


def ckpt_arrays(d: pathlib.Path, step: int) -> dict:
    with np.load(d / f"ckpt_{step}" / "shard_0.npz") as z:
        return {k: z[k] for k in z.files}


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


# ---------------------------------------------------------------------------
# the port's worlds (worker mode)
# ---------------------------------------------------------------------------

def _port_cfg(ckey, **replace):
    from repro_torch.configs.registry import smoke_variant
    arch, rep = CONFIGS[ckey]
    return smoke_variant(arch).replace(**{**rep, **replace})


def _port_step(root, case, lay):
    """One make_train_step step of ``case`` on this rank's rows and
    blocks: the metrics, the collectives of the step, and (rank 0) the
    gradients and updated parameters gathered to full."""
    from repro_torch import convert
    from repro_torch.models import common, lm
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import gathered
    from repro_torch.sharding import collectives

    ckey, _, _, rep = case_parts(case)
    cfg = _port_cfg(ckey, **rep)
    with np.load(root / f"weights_{ckey}.npz") as z:
        tree = common.unflatten({k: z[k] for k in z.files})
    state = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    model = lm.build_model(cfg, state=_blocks(cfg, state, lay), layout=lay)
    n = B // lay.D
    rows = {k: v[lay.d * n:(lay.d + 1) * n]
            for k, v in make_batch(cfg).items()}
    step = lm.make_train_step(model, adamw.AdamWConfig(**OPT), layout=lay)
    params = lm.trainable_params(model)
    _, grads = lm.loss_and_grads(model, params,
                                 lm.batch_to_device(rows, "cpu"), lay)
    lm.reduce_grads(grads, cfg, lay, S)
    with collectives.collective_trace() as ev:
        _, m = step(adamw.adamw_init(params), rows)
    defs = lm.param_defs(cfg)
    full = {**{f"g/{k}": v for k, v in
               _flat(gathered(defs, grads, model.layout)).items()},
            **{f"p/{k}": v for k, v in _flat(gathered(
                defs, {k: p.detach() for k, p in params.items()},
                model.layout)).items()}}
    if lay.d == 0 and lay.m == 0:
        np.savez(root / f"port_{case.replace('/', '__')}.npz", **full)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "digest": _digest(full), "collectives": len(ev),
            "collective_digest": hashlib.sha256(
                json.dumps(ev).encode()).hexdigest()}


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


def _port_trainer(d, ckey, mesh, ckpt_every=100):
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    return Trainer(_port_cfg(ckey), adamw.AdamWConfig(**OPT),
                   TrainerConfig(steps=T_STEPS, ckpt_every=ckpt_every,
                                 ckpt_dir=str(d), async_save=False,
                                 batch=T_BATCH, seq_len=T_SEQ,
                                 log_path=str(d / "log.jsonl")),
                   mesh=mesh, device="cpu")


def _trainer_case(root, ckey, mesh):
    from repro_torch.sharding import collectives
    t = _port_trainer(root / f"port_trainer_{ckey}", ckey, mesh,
                      ckpt_every=2 if ckey == "deepseek_ep" else 100)
    with collectives.collective_trace() as ev:
        _, _, losses = t.run()
    return {"losses": losses, "collectives": len(ev),
            "collective_digest": hashlib.sha256(
                json.dumps(ev).encode()).hexdigest()}


def _resume(root, mesh):
    """deepseek_ep's (1, 2) checkpoint at step 2 resumed on ``mesh``:
    whether each rank restored its blocks of the saved bits, and the last
    loss."""
    import torch

    from repro_torch.models import common, lm, transformer
    d = root / "resume_1x4"
    t = _port_trainer(d, "deepseek_ep", mesh)
    arrays = ckpt_arrays(d, 2)
    params, opt, start = t.restore_or_init()
    defs = common.flatten(lm.param_defs(t.cfg))
    lay = t.model.layout
    ok = int(opt.count) == int(arrays["opt/count"])
    for name in params:
        parts = name.split(".")
        stacked = parts[0] in transformer.STACKED
        i = int(parts.pop(1)) if stacked else None
        dd = defs[".".join(parts)]
        spec, shape = (dd.spec[1:], dd.shape[1:]) if stacked \
            else (dd.spec, dd.shape)
        idx = lay.block_index(spec, shape)
        for tree, pre in ((params, "params"), (opt.m, "opt/m"),
                          (opt.v, "opt/v")):
            arr = arrays[f"{pre}/{'/'.join(parts)}"]
            arr = arr[i] if stacked else arr
            ok = ok and torch.equal(tree[name].detach(), torch.from_numpy(
                np.ascontiguousarray(arr[idx])))
    _, _, losses = t.run()
    return {"start": start, "bits_equal": bool(ok), "losses": losses}


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
    if a.worker == "W2":
        mesh = bootstrap.make_dist_mesh(1, 2)
        lay = tp.Layout(mesh)
        for case in STEP_CASES:
            if case_parts(case)[2] == (1, 2):
                R[case] = _port_step(root, case, lay)
        for ckey in TRAINERS:
            R[f"trainer/{ckey}"] = _trainer_case(root, ckey, mesh)
    else:                                   # W4
        for shape in ((1, 4), (2, 2)):
            lay = tp.Layout(bootstrap.make_dist_mesh(*shape))
            for case in STEP_CASES:
                if case_parts(case)[2] == shape:
                    R[case] = _port_step(root, case, lay)
        R["resume_1x4"] = _resume(root, bootstrap.make_dist_mesh(1, 4))
    R["seconds"] = time.perf_counter() - t0
    (root / f"{a.worker}_rank{ctx.process_id}.json").write_text(
        json.dumps(R))
    faults.guarded_barrier("train-sharded-families-exit")
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


def _jax_tree(flat: dict) -> dict:
    import jax.numpy as jnp
    out = {}
    for name, v in flat.items():
        *path, last = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(v)
    return out


def _jax_step(root, case) -> dict:
    """JAX's jitted make_train_step step (one microbatch) of ``case`` on
    its mesh: the parameters laid out by their specs, the batch over
    ``data``, inside the mesh's context (``_shard_h`` and ``_shard_moe``
    see it)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.models import lm
    from repro.optim import adamw

    ckey, _, shape, rep = case_parts(case)
    model = lm.build_model(_jax_cfg(ckey, **rep))
    with np.load(root / f"weights_{ckey}.npz") as z:
        params = _jax_tree({k: z[k] for k in z.files})
    batch = make_batch(model.cfg)
    opt_cfg = adamw.AdamWConfig(**OPT)

    def step(p, jb):
        def loss_fn(p_):
            kw = {k: jb[k] for k in ("image_embeds", "audio_embeds")
                  if k in jb}
            hh, _ = model.forward(p_, jb["tokens"], mode="train",
                                  return_hidden=True, **kw)
            ww, tww = model.unembed_weights(p_)
            return lm.vocab_parallel_ce(hh, ww, tww, jb["targets"],
                                        jb["loss_mask"])
        loss, g = jax.value_and_grad(loss_fn)(p)
        p2, _, om = adamw.adamw_update(opt_cfg, g, adamw.adamw_init(p), p)
        return g, p2, {"loss": loss, **om}

    mesh = _jax_mesh(shape)
    specs = _flat(model.param_defs())
    with mesh:
        params = _jax_tree({k: jax.device_put(v, NamedSharding(
            mesh, specs[k].spec)) for k, v in _flat(params).items()})
        jb = {k: jax.device_put(v, NamedSharding(mesh, P("data")))
              for k, v in batch.items()}
        g, p2, mt = jax.jit(step)(params, jb)
    np.savez(root / f"jax_{case.replace('/', '__')}.npz",
             **{f"g/{k}": np.asarray(v) for k, v in _flat(g).items()},
             **{f"p/{k}": np.asarray(v) for k, v in _flat(p2).items()})
    return {k: float(v) for k, v in mt.items()}


def _jax_trainer(d, ckey, shape):
    from repro.optim import adamw
    from repro.runtime.trainer import Trainer, TrainerConfig
    return Trainer(_jax_cfg(ckey), adamw.AdamWConfig(**OPT),
                   TrainerConfig(steps=T_STEPS, ckpt_every=100,
                                 ckpt_dir=str(d), async_save=False,
                                 batch=T_BATCH, seq_len=T_SEQ,
                                 log_path=str(d / "log.jsonl")),
                   mesh=_jax_mesh(shape))


def _jax_job(job: str, root: pathlib.Path) -> int:
    R = {}
    for task in JAX_JOBS[job]:
        kind, ckey = task.split("/")
        if kind == "trainer":
            t = _jax_trainer(root / f"jax_trainer_{ckey}", ckey, (1, 2))
            with t.mesh:
                t.run()
        elif kind == "resume":
            # the port's (1, 2) checkpoint at step 2 resumed on (1, 4)
            d = root / "jax_resume"
            arrays = ckpt_arrays(d, 2)
            t = _jax_trainer(d, ckey, (1, 4))
            with t.mesh:
                params, opt, start = t.restore_or_init()
                got = {**{f"params/{k.replace('.', '/')}": np.asarray(v)
                          for k, v in _flat(params).items()},
                       **{f"opt/m/{k.replace('.', '/')}": np.asarray(v)
                          for k, v in _flat(opt.m).items()},
                       **{f"opt/v/{k.replace('.', '/')}": np.asarray(v)
                          for k, v in _flat(opt.v).items()},
                       "opt/count": np.asarray(opt.count)}
                ok = got.keys() == arrays.keys() and all(
                    np.array_equal(got[k], arrays[k]) for k in arrays)
                _, _, losses = t.run()
            R[task] = {"start": start, "bits_equal": bool(ok),
                       "losses": losses}
        else:
            R[task] = _jax_step(root, task)
    (root / f"jax_{job}.json").write_text(json.dumps(R))
    return 0


# ---------------------------------------------------------------------------
# the session: the seed, every world and every JAX run, once
# ---------------------------------------------------------------------------

def _seed(root: pathlib.Path):
    """Every config's weights, and a checkpoint at step 0 (those weights,
    zero moments) in the reference's layout for each trainer, written
    with the port's manager (the packages share the format)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import common, lm
    from repro_torch.optim.adamw import AdamWState

    for ckey in CONFIGS:
        defs = {k: d.shape for k, d in
                common.flatten(lm.param_defs(_port_cfg(ckey))).items()}
        flat = smoke_weights(defs, weights_seed(ckey))
        np.savez(root / f"weights_{ckey}.npz", **flat)
        if ckey in TRAINERS:
            zeros = common.unflatten({k: np.zeros(s, np.float32)
                                      for k, s in defs.items()})
            for pkg in ("port", "jax"):
                CheckpointManager(root / f"{pkg}_trainer_{ckey}").save(
                    0, {"params": common.unflatten(flat),
                        "opt": AdamWState(m=zeros, v=zeros,
                                          count=np.zeros((), np.int32))},
                    metadata={"next_step": 0, "loss": 0.0})


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
    root = tmp_path_factory.mktemp("train_sharded_families")
    _seed(root)
    jobs = {j: _start_jax(j, root) for j in "abcd"}
    w2 = _port_world(2, "W2", root)
    ck = root / "port_trainer_deepseek_ep" / "ckpt_2"
    for sub in ("resume_1x4", "jax_resume"):
        shutil.copytree(ck, root / sub / "ckpt_2")
    jobs["resume"] = _start_jax("resume", root)
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
    return runs["w2"] if case_parts(case)[2] == (1, 2) else runs["w4"]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", STEP_CASES)
def test_step_on_a_model_axis_matches_jax(runs, case):
    """One make_train_step step on the case's mesh against JAX's jitted
    step on the same mesh from the same weights and batch: the loss
    within 1e-5 and the grad norm within 1e-4 (relative), every gradient
    leaf gathered to full within 1e-4 of its largest entry, the updated
    parameters within 1e-7 where AdamW's first step is not near sign(g);
    every rank holds the same full gradients and parameters."""
    ranks = _ranks(runs, case)
    got = ranks[0][case]
    want = runs["jax"][case]
    assert abs(got["loss"] - want["loss"]) <= STEP_LOSS * abs(want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) \
        <= STEP_GRAD * want["grad_norm"]
    assert len({r[case]["digest"] for r in ranks}) == 1
    assert all(r[case]["loss"] == got["loss"] for r in ranks)
    name = case.replace("/", "__")
    with np.load(runs["root"] / f"port_{name}.npz") as z:
        pz = {k: z[k] for k in z.files}
    with np.load(runs["root"] / f"jax_{name}.npz") as z:
        jz = {k: z[k] for k in z.files}
    assert pz.keys() == jz.keys()
    scale = min(1.0, 1.0 / want["grad_norm"])
    n_cmp = 0
    for k in (k for k in jz if k.startswith("g/")):
        pg, jg = pz[k], jz[k]
        assert pg.shape == jg.shape, k
        assert _rel(pg, jg) <= STEP_GRAD, (case, k, _rel(pg, jg))
        g = np.abs(jg)
        keep = ((g > STEP_GRAD * max(g.max(), 1e-30))
                & (g * scale > STEP_FLOOR)) | ((jg == 0) & (pg == 0))
        p = "p/" + k[2:]
        diff = np.abs(pz[p] - jz[p])
        assert diff[keep].max(initial=0.0) <= STEP_PARAM, (case, k)
        n_cmp += int(keep.sum())
    assert n_cmp > 0


@pytest.mark.parametrize("world", ["w2", "w4"])
def test_ranks_record_the_same_collectives(runs, world):
    """Every rank of a world ran the same sequence of collectives in each
    step (and each trainer), and a model axis past 1 ran some."""
    ranks = runs[world]
    cases = [k for k in ranks[0] if "/" in k]
    assert cases
    for case in cases:
        seqs = {(r[case]["collectives"], r[case]["collective_digest"])
                for r in ranks}
        assert len(seqs) == 1, (case, seqs)
        assert ranks[0][case]["collectives"] > 0


@pytest.mark.parametrize("ckey", TRAINERS)
def test_trainer_on_a_model_axis_matches_jax(runs, ckey):
    """Trainer(mesh=make_dist_mesh(1, 2)) for 3 steps against JAX's
    Trainer on (1, 2) from the same checkpoint: every loss within 2e-4
    (relative), the same losses on both ranks."""
    got = [r[f"trainer/{ckey}"]["losses"] for r in runs["w2"]]
    assert got[0] == got[1]
    want = [r["loss"] for r in read_log(runs["root"]
                                        / f"jax_trainer_{ckey}")]
    assert len(got[0]) == len(want) == T_STEPS
    for g, w in zip(got[0], want):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (ckey, got[0], want)


def test_expert_parallel_checkpoint_resumes_on_another_mesh(runs):
    """deepseek_ep's (1, 2) checkpoint at step 2 resumed on (1, 4): each
    rank restored its blocks (4 of the 16 experts) of the saved bits;
    step 3 within the trainers' bar of the (1, 2) run's."""
    straight = runs["w2"][0]["trainer/deepseek_ep"]["losses"]
    for r in runs["w4"]:
        got = r["resume_1x4"]
        assert got["start"] == 2 and got["bits_equal"]
        assert abs(got["losses"][0] - straight[2]) \
            <= LOSS_RTOL * abs(straight[2])


def test_expert_parallel_checkpoint_resumes_in_jax(runs):
    """JAX's Trainer on (1, 4) restores the port's (1, 2) deepseek_ep
    checkpoint bit for bit; its step 3 within the bar of the port's."""
    straight = runs["w2"][0]["trainer/deepseek_ep"]["losses"]
    got = runs["jax"]["resume/deepseek_ep"]
    assert got["start"] == 2 and got["bits_equal"]
    assert abs(got["losses"][0] - straight[2]) <= LOSS_RTOL * abs(straight[2])


@pytest.mark.parametrize("arch,replace,what", [
    ("deepseek-v2-lite-16b", dict(n_heads=6), "n_heads"),
    ("deepseek-v2-lite-16b", dict(n_experts=18), "n_experts"),
    ("mixtral-8x7b", dict(moe_d_ff=66), "moe_d_ff"),
    ("zamba2-1.2b", dict(ssm_head_dim=64), "Mamba2 heads"),
    ("xlstm-1.3b", dict(n_heads=32), "head dim"),
    ("whisper-tiny", dict(vocab_size=258), "tp_pad_config")])
def test_check_layout_names_what_the_axis_does_not_divide(arch, replace,
                                                          what):
    """A model axis of 4 that does not divide a dim the family's specs
    split raises ``ValueError`` naming it (the vocab and heads with
    ``tp_pad_config``); the configs of ``CONFIGS`` pass, xlstm's 2 KV
    heads (no GQA reads them) included."""
    from repro_torch.configs.registry import smoke_variant
    from repro_torch.models import transformer

    class Four:
        M = 4
    base = dict(n_kv_heads=4) if arch == "mixtral-8x7b" else {}
    cfg = smoke_variant(arch).replace(**base)
    transformer.check_layout(cfg, Four)
    with pytest.raises(ValueError, match=what):
        transformer.check_layout(cfg.replace(**replace), Four)


@pytest.mark.parametrize("ckey", ["deepseek", "deepseek_ep", "mixtral"])
def test_router_margins_stay_off_ties(ckey):
    """The seeds keep the routers away from float32 ties: in the step's
    forward (single device, the tests' batch and weights) the smallest
    gap between a token's k-th and (k+1)-th router logit, over every MoE
    layer, is above ``MARGIN_MIN`` (the logits' rounding is ~1e-8), so
    the sums over ``model`` cannot flip an expert or a drop.  Measured:
    2.7e-4 (deepseek), 1.4e-4 (deepseek_ep), 1.6e-4 (mixtral); the seeds
    11-30 gave margins down to 5.4e-6."""
    import torch

    from repro_torch import convert
    from repro_torch.models import common, lm, moe
    cfg = _port_cfg(ckey)
    defs = {k: d.shape for k, d in
            common.flatten(lm.param_defs(cfg)).items()}
    flat = smoke_weights(defs, weights_seed(ckey))
    model = lm.build_model(cfg, state=convert.lm_params_from_numpy(
        cfg, common.unflatten(flat), device="cpu"))
    gaps = []
    route = moe.route

    def spy(p, x, cfg_):
        logits = common.matmul(x, p["router"]).reshape(-1, cfg_.n_experts)
        top = torch.topk(logits, cfg_.top_k + 1, dim=-1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return route(p, x, cfg_)
    batch = lm.batch_to_device(make_batch(cfg), "cpu")
    moe.route = spy
    try:
        with torch.no_grad():
            model(batch["tokens"], mode="train", return_hidden=True)
    finally:
        moe.route = route
    assert len(gaps) == cfg.n_layers - cfg.first_dense_layers
    assert min(gaps) > MARGIN_MIN, gaps


@pytest.mark.parametrize("module,defs,arch", [
    ("attention", "mla_defs", "deepseek-v2-lite-16b"),
    ("moe", "moe_defs", "mixtral-8x7b"), ("ssm", "mamba_defs", "zamba2-1.2b"),
    ("xlstm", "mlstm_defs", "xlstm-1.3b")])
def test_region_whole_leaves_are_named_by_their_module(module, defs, arch):
    """Each module's list of the whole leaves used inside its split region
    names leaves of its own defs that no spec splits, and
    ``lm.partial_leaves`` sums every such leaf of every architecture over
    ``model`` on a model axis of 2 without sequence parallelism, and no
    other whole leaf."""
    import importlib

    from repro_torch.configs.registry import ARCHS, smoke_variant
    from repro_torch.models import common, lm, transformer
    from repro_torch.sharding import tensor_parallel as tp
    mod = importlib.import_module(f"repro_torch.models.{module}")
    names = mod.MLA_REGION_WHOLE if module == "attention" \
        else mod.REGION_WHOLE
    d = getattr(mod, defs)(smoke_variant(arch))
    for n in names:
        assert n in d and not any(common.spec_axes(d[n].spec, i)
                                  for i in range(len(d[n].shape))), n
    found = set()
    two = tp.Layout.__new__(tp.Layout)
    two.M = 2
    for a in sorted(ARCHS):
        cfg = smoke_variant(a).replace(seq_shard=False)
        split = lm.split_leaves(cfg)
        want = [k for k in transformer.state_shapes(lm.param_defs(cfg))
                if k not in split
                and lm._stacked_name(k).endswith(lm.REGION_LEAVES)]
        assert lm.partial_leaves(cfg, two, S) == want, a
        found |= {lm._stacked_name(k).split(".")[-1] for k in want}
    assert set(names) <= found, (module, names, found)


if __name__ == "__main__":
    if "--worker" in sys.argv:
        sys.exit(_worker_main(sys.argv[1:]))
    if "--jax-job" in sys.argv:
        i = sys.argv.index("--jax-job")
        sys.exit(_jax_job(sys.argv[i + 1], pathlib.Path(sys.argv[i + 2])))
