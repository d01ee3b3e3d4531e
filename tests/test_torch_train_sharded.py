"""The port's sharded LM training on a (data, model) mesh of CPU processes
(gloo), held against the JAX package's ``Trainer(mesh=)`` and
``vocab_parallel_ce`` on the same meshes (fake XLA devices).

The module is also its own worker and reference script:

  * ``python tests/test_torch_train_sharded.py --worker W --root DIR``
    runs as one rank of a port world (``repro_torch.dist.launcher``,
    ``backend="gloo"``, ``device="cpu"``) and writes
    ``DIR/<W>_rank<r>.json``;
  * ``--jax-ref DIR`` (4 fake devices) runs the same trainer cases
    through the JAX package, ``--jax-fam DIR`` (4 fake devices) its
    ``vocab_parallel_ce`` and the other families' step, and
    ``--jax-resume DIR`` (2 fake devices) resumes JAX's (1, 2) trainer
    from the port's checkpoint.

Worlds: W1 (1 process) trains on (1, 1); W2 (2 processes) holds the
(1, 2) trainers (sequence-parallel on and off, fsdp) and the (2, 1) step
of every other family (their model axes:
tests/test_torch_train_sharded_families.py); W4 (4 processes) the (1, 4)
and (2, 2) trainers, ``vocab_parallel_ce`` on (1, 4) and (2, 2), and the
(1, 2) checkpoint resumed on (1, 4); W2b (2 fresh processes) the (1, 2)
checkpoints of both packages resumed on (1, 2).  Every world runs under
``run_local``'s timeout.

Weights: a checkpoint at step 0 of N(0, 0.02^2) matrices and N(0, 0.1^2)
vectors, which every trainer restores (the reference's own init is
chaotic in float32, ROADMAP Queue 3 item 14).  Config: phi4-mini's smoke
config with 8 heads and 4 KV heads, so heads, KV heads, d_ff (192) and
the vocabulary (256) divide 4.

Bars (``tests/test_torch_train.py``'s and ``test_torch_train_archs.py``'s):
losses 2e-4 relative over the 3 steps, grad norms 1e-4 relative, the
final moments 1e-4 of each leaf's largest entry and parameters 2e-5 (a
fiftieth of lr: ``test_trainer_checkpoint_matches_jax``); one
step of every other family: loss 1e-5, grad norm 1e-4, each gradient
leaf 1e-4 of its largest entry, updated parameters 1e-7 where AdamW's
first step is not near sign(g) (``test_torch_train_archs.py``'s rule);
``vocab_parallel_ce``: ``tests/progs/dist_ce.py``'s (loss 1e-5 relative,
gradients rtol 1e-4, atol 1e-5).  A checkpoint restores its saved bits
on any mesh and in either package, and the next step on the mesh that
saved it gives the same bits.
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
ARCH = "phi4-mini-3.8b"
DENSE = dict(n_heads=8, n_kv_heads=4)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=8)
STEPS, BATCH, SEQ = 3, 4, 32
# mesh, ArchConfig.replace of each dense trainer case
CASES = {"1x2_sp": ((1, 2), dict(seq_shard=True)),
         "1x2": ((1, 2), dict(seq_shard=False)),
         "1x2_fsdp": ((1, 2), dict(parallelism="fsdp")),
         "1x4_sp": ((1, 4), dict(seq_shard=True)),
         "1x4": ((1, 4), dict(seq_shard=False)),
         "2x2_sp": ((2, 2), dict(seq_shard=True))}
W2_CASES = ("1x2_sp", "1x2", "1x2_fsdp")
W4_CASES = ("1x4_sp", "1x4", "2x2_sp")
OTHER = ("deepseek-v2-lite-16b", "llama-3.2-vision-11b", "mixtral-8x7b",
         "whisper-tiny", "xlstm-1.3b", "zamba2-1.2b")
FAM_B, FAM_S = 8, 64         # a rank's 256 tokens: one whole MoE group
LOSS_RTOL, GNORM_RTOL = 2e-4, 1e-4
PARAM_ATOL, MOMENT_TOL = 2e-5, 1e-4     # the trainers' final state
STEP_LOSS, STEP_GRAD, STEP_PARAM = 1e-5, 1e-4, 1e-7
STEP_FLOOR = 1e3 * 1e-8              # 1000 AdamW eps
CE_CASES = [(mesh, tw, sp, S) for mesh in ((1, 4), (2, 2))
            for tw in (False, True) for sp in (False, True)
            for S in (16, 15) if not (sp and S == 15)]


def ce_key(mesh, tw, sp, S):
    return f"ce/{mesh[0]}x{mesh[1]}/{'wT' if tw else 'w'}/" \
        f"{'sp' if sp else 'whole'}/S{S}"


def ce_inputs(S=16):
    """tests/progs/dist_ce.py's inputs (B 4, S 16, d 32, V 64, seed 0), the
    sequence cut to S."""
    rng = np.random.default_rng(0)
    B, S0, d, V = 4, 16, 32, 64
    h = rng.normal(size=(B, S0, d)).astype(np.float32)
    w = rng.normal(size=(d, V)).astype(np.float32) * 0.3
    t = rng.integers(0, V, size=(B, S0)).astype(np.int32)
    m = (rng.random((B, S0)) > 0.1).astype(np.float32)
    return h[:, :S], w, t[:, :S], m[:, :S]


def family_batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (FAM_B, FAM_S))
           .astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (FAM_B, FAM_S))
           .astype(np.int32),
           "loss_mask": (rng.random((FAM_B, FAM_S)) < 0.9)
           .astype(np.float32)}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.normal(
            size=(FAM_B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["audio_embeds"] = rng.normal(
            size=(FAM_B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return out


def smoke_weights(defs_flat: dict, seed: int) -> dict:
    """{name: array} over a flat {name: shape} (the reference's sorted leaf
    order): N(0, 0.02^2) matrices, N(0, 0.1^2) vectors."""
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * (0.1 if len(s) < 2 else 0.02))
            .astype(np.float32) for k, s in defs_flat.items()}


def read_log(d: pathlib.Path) -> list:
    return [json.loads(ln) for ln in
            (d / "log.jsonl").read_text().splitlines()]


def ckpt_arrays(d: pathlib.Path, step: int) -> dict:
    with np.load(d / f"ckpt_{step}" / "shard_0.npz") as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the port's worlds (worker mode)
# ---------------------------------------------------------------------------

def _port_cfg(**replace):
    from repro_torch.configs.registry import smoke_variant
    return smoke_variant(ARCH).replace(**DENSE, **replace)


def _port_trainer(d, mesh, replace, steps=STEPS, ckpt_every=100):
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    return Trainer(_port_cfg(**replace), adamw.AdamWConfig(**OPT),
                   TrainerConfig(steps=steps, ckpt_every=ckpt_every,
                                 ckpt_dir=str(d), async_save=False,
                                 batch=BATCH, seq_len=SEQ,
                                 log_path=str(d / "log.jsonl")),
                   mesh=mesh, device="cpu")


def restored_bits_equal(trainer, params, opt_state, arrays: dict) -> bool:
    """Whether a restored trainer holds, in every parameter and moment,
    its block of the checkpoint's arrays, bit for bit."""
    import torch

    from repro_torch.models import common, lm, transformer
    defs = common.flatten(lm.param_defs(trainer.cfg))
    lay = trainer.model.layout
    for name in params:
        parts = name.split(".")
        stacked = parts[0] in transformer.STACKED
        i = int(parts.pop(1)) if stacked else None
        d = defs[".".join(parts)]
        spec, shape = (d.spec[1:], d.shape[1:]) if stacked \
            else (d.spec, d.shape)
        idx = lay.block_index(spec, shape) if lay is not None else ()
        for tree, pre in ((params, "params"), (opt_state.m, "opt/m"),
                          (opt_state.v, "opt/v")):
            arr = arrays[f"{pre}/{'/'.join(parts)}"]
            arr = arr[i] if stacked else arr
            if not torch.equal(tree[name].detach(),
                               torch.from_numpy(np.ascontiguousarray(
                                   arr[idx]))):
                return False
    return int(opt_state.count) == int(arrays["opt/count"])


def _dense_case(root, case, mesh):
    from repro_torch.sharding import collectives
    d = root / f"port_{case}"
    _, replace = CASES.get(case, ((1, 1), {}))
    t = _port_trainer(d, mesh, replace,
                      ckpt_every=2 if case == "1x2_sp" else 100)
    with collectives.collective_trace() as ev:
        t.run()
    return {"collectives": len(ev),
            "collective_digest": hashlib.sha256(
                json.dumps(ev).encode()).hexdigest()}


def _resume(root, sub, mesh, replace):
    """A trainer on ``root/sub`` (a checkpoint at step 2) restored and run
    to step 3: whether it restored the saved bits, and its last loss."""
    d = root / sub
    t = _port_trainer(d, mesh, replace)
    arrays = ckpt_arrays(d, 2)
    params, opt, start = t.restore_or_init()
    ok = restored_bits_equal(t, params, opt, arrays)
    _, _, losses = t.run()
    return {"start": start, "bits_equal": ok, "losses": losses}


def _family_steps(root, mesh, rank):
    """One make_train_step step of every other family on (2, 1): this
    rank's rows, the gradients completed over data; rank 0 saves the
    metrics, gradients and updated parameters."""
    from repro_torch import convert
    from repro_torch.configs.registry import smoke_variant
    from repro_torch.models import common, lm, moe
    from repro_torch.optim import adamw
    from repro_torch.sharding import tensor_parallel as tp

    moe.CAPACITY_FACTOR = 16.0           # no drops (the reference's test)
    lay = tp.Layout(mesh)
    out = {}
    for arch in OTHER:
        cfg = smoke_variant(arch)
        with np.load(root / f"weights_{arch}.npz") as z:
            tree = common.unflatten({k: z[k] for k in z.files})
        model = lm.build_model(cfg, state=convert.lm_params_from_numpy(
            cfg, tree, device="cpu"), layout=lay)
        batch = family_batch(cfg)
        n = FAM_B // lay.D
        rows = {k: v[lay.d * n:(lay.d + 1) * n] for k, v in batch.items()}
        step = lm.make_train_step(model, adamw.AdamWConfig(**OPT),
                                  layout=lay)
        params = lm.trainable_params(model)
        _, grads = lm.loss_and_grads(model, params,
                                     lm.batch_to_device(rows, "cpu"), lay)
        lm.reduce_grads(grads, cfg, lay, FAM_S)
        _, m = step(adamw.adamw_init(params), rows)
        out[arch] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])}
        np.savez(root / f"fam_{arch}_rank{rank}.npz",
                 **{f"g/{k}": g.numpy() for k, g in grads.items()},
                 **{f"p/{k}": p.detach().numpy() for k, p in params.items()})
    return out


def _ce_cases(root, rank):
    """vocab_parallel_ce on (1, 4) and (2, 2): this rank's rows (and block
    of the sequence), its vocab block; the loss and this rank's
    gradients."""
    import torch

    from repro_torch.dist import bootstrap
    from repro_torch.models import lm
    from repro_torch.sharding import tensor_parallel as tp

    out = {}
    for mesh_shape in ((1, 4), (2, 2)):
        lay = tp.Layout(bootstrap.make_dist_mesh(*mesh_shape))
        for m_, tw, sp, S in CE_CASES:
            if m_ != mesh_shape:
                continue
            h, w, t, m = ce_inputs(S)
            rows = lay.block_index(("data",), h.shape[:1])[0]
            hl = h[rows]
            if sp:
                hl = hl[:, lay.block_index((None, "model"),
                                           hl.shape[:2])[1]]
            wf = w.T.copy() if tw else w
            wl = wf[lay.block_index(("model", None) if tw
                                    else (None, "model"), wf.shape)]
            ht = torch.from_numpy(np.ascontiguousarray(hl)).requires_grad_()
            wt = torch.from_numpy(np.ascontiguousarray(wl)).requires_grad_()
            loss = lm.vocab_parallel_ce(
                ht, wt, tw, torch.from_numpy(t[rows]),
                torch.from_numpy(m[rows]), mesh=lay, seq_sharded=sp)
            loss.backward()
            out[ce_key(mesh_shape, tw, sp, S)] = {
                "loss": float(loss), "d": lay.d, "m": lay.m,
                "gh": ht.grad.numpy().tolist(),
                "gw": wt.grad.numpy().tolist()}
    return out


def _worker_main(argv) -> int:
    import argparse

    import torch

    from repro_torch.dist import bootstrap, faults
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", required=True)
    ap.add_argument("--root", required=True)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    ctx = bootstrap.initialize(backend="gloo", device="cpu")
    root = pathlib.Path(a.root)
    rank = ctx.process_id
    t0 = time.perf_counter()
    R = {}
    if a.worker == "W2":
        m12 = bootstrap.make_dist_mesh(1, 2)
        for case in W2_CASES:
            R[case] = _dense_case(root, case, m12)
        R["families"] = _family_steps(root, bootstrap.make_dist_mesh(2, 1),
                                      rank)
    elif a.worker == "W4":
        for case in W4_CASES:
            R[case] = _dense_case(root, case,
                                  bootstrap.make_dist_mesh(*CASES[case][0]))
        R.update(_ce_cases(root, rank))
        R["resume_1x4"] = _resume(root, "resume_1x4",
                                  bootstrap.make_dist_mesh(1, 4),
                                  CASES["1x2_sp"][1])
    elif a.worker == "W1":
        R["1x1"] = _dense_case(root, "1x1", bootstrap.make_dist_mesh(1, 1))
    else:                                   # W2b
        m12 = bootstrap.make_dist_mesh(1, 2)
        R["resume_1x2"] = _resume(root, "resume_1x2", m12,
                                  CASES["1x2_sp"][1])
        R["resume_jax"] = _resume(root, "resume_jax", m12,
                                  CASES["1x2_sp"][1])
    R["seconds"] = time.perf_counter() - t0
    (root / f"{a.worker}_rank{rank}.json").write_text(json.dumps(R))
    faults.guarded_barrier("train-sharded-exit")
    bootstrap.shutdown()
    return 0


# ---------------------------------------------------------------------------
# JAX's side (fake devices)
# ---------------------------------------------------------------------------

def _jax_cfg(**replace):
    from repro.configs import registry
    return registry.smoke_variant(ARCH).replace(**DENSE, **replace)


def _jax_trainer(d, mesh, replace, ckpt_every=100):
    from repro.optim import adamw
    from repro.runtime.trainer import Trainer, TrainerConfig
    return Trainer(_jax_cfg(**replace), adamw.AdamWConfig(**OPT),
                   TrainerConfig(steps=STEPS, ckpt_every=ckpt_every,
                                 ckpt_dir=str(d), async_save=False,
                                 batch=BATCH, seq_len=SEQ,
                                 log_path=str(d / "log.jsonl")),
                   mesh=mesh)


def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh
    n = shape[0] * shape[1]
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))


def _jax_ref(root: pathlib.Path) -> int:
    """JAX's Trainer for every dense case on its mesh (inside the mesh's
    context, so its ``vocab_parallel_ce`` and ``_shard_h`` see it)."""
    for case, (shape, replace) in CASES.items():
        mesh = _jax_mesh(shape)
        with mesh:
            _jax_trainer(root / f"jax_{case}", mesh, replace,
                         ckpt_every=2 if case == "1x2_sp" else 100).run()
    return 0


def _jax_fam(root: pathlib.Path) -> int:
    """JAX's vocab_parallel_ce on (1, 4) and (2, 2), and one step of every
    other family on (2, 1)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import registry
    from repro.models import lm, moe
    from repro.optim import adamw

    R = {}
    # the vocab-sharded branch (S 16) or the plain one (S 15)
    for mesh_shape, tw, sp, S in CE_CASES:
        if sp:
            continue                    # the same inputs whole or split
        mesh = _jax_mesh(mesh_shape)
        h, w, t, m = ce_inputs(S)
        wf = w.T.copy() if tw else w

        def loss(h_, w_, _tw=tw, _t=t, _m=m):
            return lm.vocab_parallel_ce(h_, w_, _tw, jnp.asarray(_t),
                                        jnp.asarray(_m))
        with mesh:
            hd = jax.device_put(h, NamedSharding(mesh, P("data", None,
                                                         None)))
            wd = jax.device_put(wf, NamedSharding(
                mesh, P("model", None) if tw else P(None, "model")))
            val, (gh, gw) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1)))(hd, wd)
        R[ce_key(mesh_shape, tw, False, S)] = {
            "loss": float(val), "gh": np.asarray(gh).tolist(),
            "gw": np.asarray(gw).tolist()}
    moe.CAPACITY_FACTOR = 16.0
    mesh = _jax_mesh((2, 1))
    opt_cfg = adamw.AdamWConfig(**OPT)
    for arch in OTHER:
        model = lm.build_model(registry.smoke_variant(arch))
        with np.load(root / f"weights_{arch}.npz") as z:
            params = _unflatten_jax({k: z[k] for k in z.files})
        batch = family_batch(model.cfg)

        def step(p, jb, _model=model):
            # make_train_step's step (one microbatch), its gradients too
            def loss_fn(p_):
                kw = {k: jb[k] for k in ("image_embeds", "audio_embeds")
                      if k in jb}
                hh, _ = _model.forward(p_, jb["tokens"], mode="train",
                                       return_hidden=True, **kw)
                ww, tww = _model.unembed_weights(p_)
                return lm.vocab_parallel_ce(hh, ww, tww, jb["targets"],
                                            jb["loss_mask"])
            loss, g = jax.value_and_grad(loss_fn)(p)
            p2, _, om = adamw.adamw_update(opt_cfg, g, adamw.adamw_init(p),
                                           p)
            return g, p2, {"loss": loss, **om}
        with mesh:
            params = jax.device_put(params, NamedSharding(mesh, P()))
            jb = {k: jax.device_put(v, NamedSharding(mesh, P("data")))
                  for k, v in batch.items()}
            g, p2, mt = jax.jit(step)(params, jb)
        np.savez(root / f"fam_{arch}_jax.npz",
                 **{f"g/{k}": np.asarray(v) for k, v in _flat(g).items()},
                 **{f"p/{k}": np.asarray(v) for k, v in _flat(p2).items()})
        R[f"family/{arch}"] = {k: float(v) for k, v in mt.items()}
    (root / "jax_ref.json").write_text(json.dumps(R))
    return 0


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


def _unflatten_jax(flat: dict) -> dict:
    import jax.numpy as jnp
    out = {}
    for name, v in flat.items():
        *path, last = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(v)
    return out


def _jax_resume(root: pathlib.Path) -> int:
    """JAX's (1, 2) trainer resumes the port's (1, 2) checkpoint at step 2:
    the restored bits and the last loss."""
    d = root / "jax_resume"
    mesh = _jax_mesh((1, 2))
    arrays = ckpt_arrays(d, 2)
    with mesh:
        t = _jax_trainer(d, mesh, CASES["1x2_sp"][1])
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
    (root / "jax_resume.json").write_text(json.dumps(
        {"start": start, "bits_equal": bool(ok), "losses": losses}))
    return 0


# ---------------------------------------------------------------------------
# the session: the seed, every world and every JAX run, once
# ---------------------------------------------------------------------------

def _seed(root: pathlib.Path):
    """A checkpoint at step 0 (N(0, 0.02^2) matrices, N(0, 0.1^2) vectors,
    zero moments) in the reference's layout, and every other family's
    weights, written with the port's manager (the packages share the
    format)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.registry import smoke_variant
    from repro_torch.models import common, lm
    from repro_torch.optim.adamw import AdamWState

    defs = {k: d.shape for k, d in
            common.flatten(lm.param_defs(_port_cfg())).items()}
    params = common.unflatten(smoke_weights(defs, 0))
    zeros = common.unflatten({k: np.zeros(s, np.float32)
                              for k, s in defs.items()})
    CheckpointManager(root / "seed").save(
        0, {"params": params, "opt": AdamWState(
            m=zeros, v=zeros, count=np.zeros((), np.int32))},
        metadata={"next_step": 0, "loss": 0.0})
    for i, arch in enumerate(OTHER):
        fdefs = {k: d.shape for k, d in
                 common.flatten(lm.param_defs(smoke_variant(arch))).items()}
        np.savez(root / f"weights_{arch}.npz", **smoke_weights(fdefs, i + 1))


def _jax_env(devices: int) -> dict:
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(SRC)
    for k in ("REPRO_DIST_COORD", "REPRO_DIST_PROCID", "REPRO_DIST_NPROCS"):
        env.pop(k, None)
    return env


def _jax_job(flag, root, devices):
    log = open(root / f"{flag.strip('-')}.log", "w")
    return subprocess.Popen([sys.executable, str(THIS), flag, str(root)],
                            stdout=log, stderr=subprocess.STDOUT,
                            env=_jax_env(devices)), log


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


def _cut(src: pathlib.Path, dst: pathlib.Path):
    """A copy of a trainer directory holding only its step-2 checkpoint."""
    shutil.copytree(src / "ckpt_2", dst / "ckpt_2")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_sharded")
    _seed(root)
    for case in CASES:
        for pkg in ("port", "jax"):
            shutil.copytree(root / "seed", root / f"{pkg}_{case}")
    for sub in ("port_1x1", "port_single"):
        shutil.copytree(root / "seed", root / sub)
    jax_job = _jax_job("--jax-ref", root, 4)
    fam_job = _jax_job("--jax-fam", root, 4)
    w2 = _port_world(2, "W2", root)
    _port_world(1, "W1", root)
    _cut(root / "port_1x2_sp", root / "resume_1x4")
    w4 = _port_world(4, "W4", root)
    _wait(jax_job)
    _cut(root / "port_1x2_sp", root / "jax_resume")
    resume = _jax_job("--jax-resume", root, 2)
    _cut(root / "port_1x2_sp", root / "resume_1x2")
    _cut(root / "jax_1x2_sp", root / "resume_jax")
    w2b = _port_world(2, "W2b", root)
    _cut(root / "port_1x2_sp", root / "resume_one")
    _wait(resume)
    _wait(fam_job)
    return {"root": root, "w2": w2, "w4": w4, "w2b": w2b,
            "jax": json.loads((root / "jax_ref.json").read_text()),
            "jax_resume": json.loads(
                (root / "jax_resume.json").read_text())}


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


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_on_a_mesh_matches_jax(runs, case):
    """Trainer(mesh=) for 3 steps against JAX's Trainer on the same mesh
    from the same weights: every loss within 2e-4 and grad norm within
    1e-4 (relative), the same steps logged and checkpointed."""
    root = runs["root"]
    got, want = read_log(root / f"port_{case}"), read_log(root /
                                                         f"jax_{case}")
    assert [r["step"] for r in got] == [r["step"] for r in want] == \
        list(range(STEPS))
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= LOSS_RTOL * abs(w["loss"]), \
            (case, g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) \
            <= GNORM_RTOL * w["grad_norm"], (case, g, w)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    steps = sorted(int(p.name.split("_")[1]) for p in
                   (root / f"port_{case}").glob("ckpt_*"))
    assert steps == ([0, 2, 3] if case == "1x2_sp" else [0, 3])


@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_checkpoint_matches_jax(runs, case):
    """The final checkpoints of both packages (full arrays, the
    reference's layout): the same keys, shapes and dtypes; the parameters
    within PARAM_ATOL of JAX's (2% of a step of lr 1e-3: a step is
    m / (sqrt(v) + eps), whose ratio moves with the float order where m
    is small against sqrt(v); measured 4.1e-6 to 7.5e-6), the moments
    within MOMENT_TOL of their leaf's largest entry (the gradient bar;
    measured 1.5e-6 to 4.2e-6)."""
    root = runs["root"]
    got, want = ckpt_arrays(root / f"port_{case}", STEPS), \
        ckpt_arrays(root / f"jax_{case}", STEPS)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
    assert int(got["opt/count"]) == STEPS
    for k in want:
        if k.startswith("params/"):
            assert np.max(np.abs(got[k] - want[k])) <= PARAM_ATOL, k
        elif k != "opt/count":
            assert _rel(got[k], want[k]) <= MOMENT_TOL, k


def test_world_of_one_gives_the_single_device_bits(runs):
    """A world of one (gloo, mesh (1, 1)) against the trainer without a
    mesh from the same checkpoint: the same losses, grad norms and
    learning rates, and the same final parameters and moments, bit for
    bit."""
    root = runs["root"]
    _port_trainer(root / "port_single", None, {}).run()
    got, want = read_log(root / "port_1x1"), read_log(root / "port_single")
    assert [(r["loss"], r["grad_norm"], r["lr"]) for r in got] == \
        [(r["loss"], r["grad_norm"], r["lr"]) for r in want]
    a, b = ckpt_arrays(root / "port_1x1", STEPS), \
        ckpt_arrays(root / "port_single", STEPS)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("world", ["w2", "w4"])
def test_ranks_record_the_same_collectives(runs, world):
    """Every rank of a world ran the same sequence of collectives in each
    trainer case."""
    ranks = runs[world]
    for case in (W2_CASES if world == "w2" else W4_CASES):
        seqs = {(r[case]["collectives"], r[case]["collective_digest"])
                for r in ranks}
        assert len(seqs) == 1, (case, seqs)
        assert ranks[0][case]["collectives"] > 0


@pytest.mark.parametrize("mesh,tw,sp,S", CE_CASES,
                         ids=[ce_key(*c) for c in CE_CASES])
def test_vocab_parallel_ce_on_a_mesh(runs, mesh, tw, sp, S):
    """The sharded vocab_parallel_ce (S 16: the vocab-sharded branch; S
    15 fails ``usable`` and takes the plain one over the gathered
    unembed) against the plain loss and against JAX's: dist_ce.py's bars.
    Every rank returns the global loss; its gradients are its rows' (and
    block's) share, summed over data for w."""
    import torch

    from repro_torch.models import lm
    ranks = [r[ce_key(mesh, tw, sp, S)] for r in runs["w4"]]
    h, w, t, m = ce_inputs(S)
    wf = w.T.copy() if tw else w
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(wf).requires_grad_()
    loss = lm.next_token_loss(lm._unembed_logits(ht, wt, tw),
                              torch.from_numpy(t), torch.from_numpy(m))
    loss.backward()
    want_loss = float(loss.detach())
    D, M = mesh
    gh = np.zeros_like(h)
    gw = np.zeros_like(wf)
    for r in ranks:
        assert abs(r["loss"] - want_loss) <= 1e-5 * abs(want_loss)
        b = h.shape[0] // D
        rows = slice(r["d"] * b, (r["d"] + 1) * b)
        if sp:
            s = S // M
            gh[rows, r["m"] * s:(r["m"] + 1) * s] = r["gh"]
        elif r["m"] == 0:
            gh[rows] = r["gh"]
        else:           # whole over model: every rank holds the same rows
            np.testing.assert_array_equal(
                gh[rows], np.asarray(r["gh"], np.float32))
        v = wf.shape[0 if tw else 1] // M
        blk = (slice(r["m"] * v, (r["m"] + 1) * v), slice(None)) if tw \
            else (slice(None), slice(r["m"] * v, (r["m"] + 1) * v))
        gw[blk] += np.asarray(r["gw"], np.float32)
    for got, want in ((gh, ht.grad.numpy()), (gw, wt.grad.numpy())):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    j = runs["jax"][ce_key(mesh, tw, False, S)]
    assert abs(r["loss"] - j["loss"]) <= 1e-5 * abs(j["loss"])
    np.testing.assert_allclose(gh, j["gh"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gw, j["gw"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", OTHER)
def test_other_families_on_a_data_mesh_match_jax(runs, arch):
    """One make_train_step step on (2, 1), this rank's rows, against JAX's
    jitted step on (2, 1): test_torch_train_archs.py's bars; both ranks
    hold the same updated parameters."""
    root = runs["root"]
    got = runs["w2"][0]["families"][arch]
    want = runs["jax"][f"family/{arch}"]
    assert abs(got["loss"] - want["loss"]) <= STEP_LOSS * abs(want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) \
        <= STEP_GRAD * want["grad_norm"]
    with np.load(root / f"fam_{arch}_jax.npz") as z:
        jz = {k: z[k] for k in z.files}
    ranks = []
    for r in range(2):
        with np.load(root / f"fam_{arch}_rank{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    port = _stacked(arch, ranks[0])
    scale = min(1.0, 1.0 / want["grad_norm"])
    n_cmp = 0
    for k, pg in port["g"].items():
        jg = jz[f"g/{k}"]
        assert _rel(pg, jg) <= STEP_GRAD, (arch, k)
        g = np.abs(jg)
        keep = ((g > STEP_GRAD * max(g.max(), 1e-30))
                & (g * scale > STEP_FLOOR)) | ((jg == 0) & (pg == 0))
        diff = np.abs(port["p"][k] - jz[f"p/{k}"])
        assert diff[keep].max(initial=0.0) <= STEP_PARAM, (arch, k)
        n_cmp += int(keep.sum())
    assert n_cmp > 0


def _stacked(arch, flat_npz: dict) -> dict:
    """{"g": {name: array}, "p": ...} in the reference's stacked names of
    a rank's saved gradients and parameters."""
    from repro_torch.configs.registry import smoke_variant
    from repro_torch.models import common, lm, transformer
    defs = lm.param_defs(smoke_variant(arch))
    out = {}
    for part in ("g", "p"):
        state = {k[2:]: v for k, v in flat_npz.items()
                 if k.startswith(part + "/")}
        tree = {}
        for key in sorted(defs):
            sub = defs[key]
            for name, d in common.flatten({key: sub}).items():
                if key in transformer.STACKED:
                    rest = name[len(key) + 1:]
                    tree[name] = np.stack([state[f"{key}.{i}.{rest}"]
                                           for i in range(d.shape[0])])
                else:
                    tree[name] = state[name]
        out[part] = tree
    return out


def test_checkpoint_resumes_on_the_same_mesh_bit_for_bit(runs):
    """The (1, 2) checkpoint at step 2, resumed by a fresh (1, 2) world:
    the saved bits restored, and step 3 gives the straight run's loss bit
    for bit."""
    straight = [r["loss"] for r in read_log(runs["root"] / "port_1x2_sp")]
    for r in runs["w2b"]:
        got = r["resume_1x2"]
        assert got["start"] == 2 and got["bits_equal"]
        assert got["losses"] == straight[2:]


def test_checkpoint_resumes_on_another_mesh(runs):
    """The (1, 2) checkpoint resumed on (1, 4): each rank restored its
    blocks of the saved bits; step 3 within the trainers' bar of the
    (1, 2) run's."""
    straight = [r["loss"] for r in read_log(runs["root"] / "port_1x2_sp")]
    for r in runs["w4"]:
        got = r["resume_1x4"]
        assert got["start"] == 2 and got["bits_equal"]
        assert abs(got["losses"][0] - straight[2]) \
            <= LOSS_RTOL * abs(straight[2])


def test_checkpoint_resumes_on_one_process(runs):
    """The (1, 2) checkpoint resumed without a mesh: the saved bits
    restored; step 3 within the bar of the (1, 2) run's."""
    d = runs["root"] / "resume_one"
    straight = [r["loss"] for r in read_log(runs["root"] / "port_1x2_sp")]
    t = _port_trainer(d, None, CASES["1x2_sp"][1])
    params, opt, start = t.restore_or_init()
    assert start == 2
    assert restored_bits_equal(t, params, opt, ckpt_arrays(d, 2))
    _, _, losses = t.run()
    assert abs(losses[0] - straight[2]) <= LOSS_RTOL * abs(straight[2])


def test_port_checkpoint_resumes_in_jax(runs):
    """JAX's (1, 2) Trainer restores the port's (1, 2) checkpoint bit for
    bit; its step 3 within the bar of the port's."""
    straight = [r["loss"] for r in read_log(runs["root"] / "port_1x2_sp")]
    got = runs["jax_resume"]
    assert got["start"] == 2 and got["bits_equal"]
    assert abs(got["losses"][0] - straight[2]) <= LOSS_RTOL * abs(straight[2])


def test_jax_checkpoint_resumes_on_the_port(runs):
    """JAX's (1, 2) checkpoint at step 2 resumed by the port's (1, 2)
    world: the saved bits restored; step 3 within the bar of JAX's."""
    want = [r["loss"] for r in read_log(runs["root"] / "jax_1x2_sp")]
    for r in runs["w2b"]:
        got = r["resume_jax"]
        assert got["start"] == 2 and got["bits_equal"]
        assert abs(got["losses"][0] - want[2]) <= LOSS_RTOL * abs(want[2])


def test_launch_train_devices_on_the_cpu(tmp_path, capsys):
    """``launch.train.main([... "--devices", "2", "--device", "cpu"])``:
    two ranks over gloo train phi4-mini's smoke config; process 0 logs
    and checkpoints."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    rc = train.main(["--arch", ARCH, "--smoke", "--devices", "2", "--device",
                     "cpu", "--steps", "2", "--batch", "2", "--seq-len",
                     "16", "--ckpt-every", "2", "--ckpt-dir",
                     str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("final loss") == 2
    assert CheckpointManager(tmp_path).all_steps() == [2]
    assert len((tmp_path / "train.jsonl").read_text().splitlines()) == 2


if __name__ == "__main__":
    if "--worker" in sys.argv:
        sys.exit(_worker_main(sys.argv[1:]))
    if "--jax-ref" in sys.argv:
        sys.exit(_jax_ref(pathlib.Path(sys.argv[sys.argv.index(
            "--jax-ref") + 1])))
    if "--jax-fam" in sys.argv:
        sys.exit(_jax_fam(pathlib.Path(sys.argv[sys.argv.index(
            "--jax-fam") + 1])))
    if "--jax-resume" in sys.argv:
        sys.exit(_jax_resume(pathlib.Path(sys.argv[sys.argv.index(
            "--jax-resume") + 1])))
