"""The port's LM training pieces against the JAX package's on the CPU:
``data.pipeline.TokenPipeline``, ``optim.adamw``, ``models.lm``'s
``next_token_loss`` and ``vocab_parallel_ce``, ``roofline.model``,
``runtime.trainer.Trainer`` (its losses, kill-and-restart, checkpoints
across the packages both ways) and ``launch.train``; the flash backward
is ``tests/test_torch_flash.py``'s.

Tolerances, each stated where it is used:
- TokenPipeline: bit for bit;
- schedule, AdamW (parameters, moments, grad norm, lr) and the losses:
  1e-6 relative to the largest |value| (float32, sums in another order);
- the trainer's losses: 2e-4 relative (the reference's own resume bar,
  tests/test_checkpoint.py), from the same weights: a checkpoint at step
  0 of N(0, 0.02^2) matrices, which both trainers restore.  Under the
  reference's init (attention logits with a std of tens at smoke width)
  two float32 runs, the port's flash and naive attention among them, part
  by 1e-3 within 4 steps, so there the port is held to the reference's
  learning bar alone (tests/test_system.py).
"""
import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_reg
from repro.configs.base import SHAPES as J_SHAPES
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import lm as j_lm
from repro.optim import adamw as j_adamw
from repro.roofline import model as j_roof
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import CheckpointManager, Stacked
from repro_torch.configs import registry as t_reg
from repro_torch.configs.base import SHAPES as T_SHAPES
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import train as t_train
from repro_torch.models import common as t_common
from repro_torch.models import lm as t_lm
from repro_torch.optim import adamw as t_adamw
from repro_torch.roofline import model as t_roof
from repro_torch.runtime.trainer import Trainer, TrainerConfig

TOL = 1e-6
LOSS_RTOL = 2e-4
ARCH = "phi4-mini-3.8b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke widths: torch's intra-op threads buy nothing here and, beside
    the other test workers, spin on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / max(np.max(np.abs(want)), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- pipeline

@pytest.mark.parametrize("seed,vocab,batch,seq", [
    (0, 256, 4, 32), (3, 2048, 8, 128), (11, 200_064, 2, 64)])
def test_token_pipeline_bit_for_bit(seed, vocab, batch, seq):
    mine = TokenPipeline(vocab, batch, seq, seed=seed)
    ref = JTokenPipeline(vocab, batch, seq, seed=seed)
    for step in (0, 1, 7, 123):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# ------------------------------------------------------------------- adamw

def test_schedule_matches_jax():
    for kw in ({}, {"warmup_steps": 5, "total_steps": 30},
               {"warmup_steps": 0, "total_steps": 1, "min_lr_frac": 0.0}):
        jc, tc = j_adamw.AdamWConfig(**kw), t_adamw.AdamWConfig(**kw)
        for step in (0, 1, 3, 5, 17, 30, 10_001):
            want = float(j_adamw.schedule(jc, jnp.int32(step)))
            got = float(t_adamw.schedule(tc, torch.tensor(step)))
            assert abs(got - want) <= TOL * max(abs(want), 1e-30), \
                (kw, step, got, want)


def _tree(rng, scale):
    return {"a": (rng.normal(size=(5, 7)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(11,)) * scale).astype(np.float32),
                  "d": (rng.normal(size=(3, 4, 2)) * scale)
                  .astype(np.float32)}}


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_adamw_update_matches_jax(grad_scale):
    """Three steps from the same tree; grad scale 10 clips (norm past 1),
    1e-3 does not.  The port updates in place."""
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jc, tc = j_adamw.AdamWConfig(**kw), t_adamw.AdamWConfig(**kw)
    p0 = _tree(rng, 1.0)
    jp = jax.tree.map(jnp.asarray, p0)
    jo = j_adamw.adamw_init(jp)
    tp = {k: _t(v) for k, v in t_common.flatten(p0).items()}
    to = t_adamw.adamw_init(tp)
    ids = {k: id(v) for k, v in tp.items()}
    for _ in range(3):
        g = _tree(rng, grad_scale)
        jp, jo, jm = j_adamw.adamw_update(jc, jax.tree.map(jnp.asarray, g),
                                          jo, jp)
        tp, to, tm = t_adamw.adamw_update(
            tc, {k: _t(v) for k, v in t_common.flatten(g).items()}, to, tp)
        for name in ("grad_norm", "lr"):
            assert _rel(tm[name], jm[name]) <= TOL, name
        assert int(to.count) == int(jo.count)
        for tree_j, tree_t in ((jp, tp), (jo.m, to.m), (jo.v, to.v)):
            for k, want in t_common.flatten(
                    jax.tree.map(np.asarray, tree_j)).items():
                assert _rel(tree_t[k], want) <= TOL, k
    assert {k: id(v) for k, v in tp.items()} == ids      # in place
    if grad_scale > 1:
        assert float(tm["grad_norm"]) > 1.0


# -------------------------------------------------------------------- loss

def test_next_token_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(3, 9, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, (3, 9)).astype(np.int32)
    mask = (rng.random((3, 9)) < 0.7).astype(np.float32)
    want = float(j_lm.next_token_loss(jnp.asarray(logits),
                                      jnp.asarray(targets),
                                      jnp.asarray(mask)))
    got = float(t_lm.next_token_loss(_t(logits), _t(targets), _t(mask)))
    assert abs(got - want) <= TOL * abs(want)
    zero = float(t_lm.next_token_loss(_t(logits), _t(targets),
                                      torch.zeros(3, 9)))
    assert zero == 0.0        # no masked position: 0 over max(0, 1)


class _Mesh:
    """What a ``tensor_parallel.Layout`` reads of a (data, model)
    ``DeviceMesh``, for rank 0 and with no process group (a group of one:
    no call), enough for the checks that need no collective."""
    mesh_dim_names = ("data", "model")

    def __init__(self, shape: dict):
        self._sizes = [shape["data"], shape["model"]]

    def size(self, i: int) -> int:
        return self._sizes[i]

    def get_local_rank(self, name: str) -> int:
        return 0

    def get_group(self, name: str):
        return None


@pytest.mark.parametrize("transpose_w", [True, False])
def test_vocab_parallel_ce_matches_jax(transpose_w):
    rng = np.random.default_rng(2)
    h = rng.normal(size=(2, 6, 16)).astype(np.float32)
    w = (rng.normal(size=(40, 16) if transpose_w else (16, 40))
         * 0.5).astype(np.float32)
    targets = rng.integers(0, 40, (2, 6)).astype(np.int32)
    mask = np.ones((2, 6), np.float32)
    want = float(j_lm.vocab_parallel_ce(jnp.asarray(h), jnp.asarray(w),
                                        transpose_w, jnp.asarray(targets),
                                        jnp.asarray(mask)))
    args = (_t(h), _t(w), transpose_w, _t(targets), _t(mask))
    assert abs(float(t_lm.vocab_parallel_ce(*args)) - want) <= TOL * want
    # a model axis of 1 takes the plain loss, bit for bit; the vocab-
    # sharded branch runs on gloo worlds (tests/test_torch_train_sharded.py)
    one = _Mesh({"data": 4, "model": 1})
    assert float(t_lm.vocab_parallel_ce(*args, mesh=one)) \
        == float(t_lm.vocab_parallel_ce(*args))


# ---------------------------------------------------------------- roofline

@pytest.mark.parametrize("name", sorted(j_reg.ARCHS))
def test_roofline_model_matches_jax(name):
    for smoke in (False, True):
        jc = j_reg.smoke_variant(name) if smoke else j_reg.get_arch(name)
        tc = t_reg.smoke_variant(name) if smoke else t_reg.get_arch(name)
        assert t_roof.count_params(tc) == j_roof.count_params(jc)
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            assert t_roof.model_flops(tc, T_SHAPES[shape]) \
                == j_roof.model_flops(jc, J_SHAPES[shape])


def test_roofline_terms_on_the_card_peaks():
    class Stats:
        flops, bytes_accessed, collective_bytes = 67e12, 3.35e12, 0.0
    terms = t_roof.roofline_terms(Stats, 1)
    assert terms["compute_s"] == pytest.approx(1.0)
    assert terms["memory_s"] == pytest.approx(1.0)
    terms = t_roof.roofline_terms(Stats, 1,
                                  peak_flops=t_mesh.PEAK_FLOPS_BF16)
    assert terms["dominant"] == "memory"


# ----------------------------------------------------------------- trainer

OPT = dict(lr=3e-3, warmup_steps=5, total_steps=30)


def _seed_dir(path, cfg_name=ARCH):
    """A directory holding one checkpoint at step 0 (next_step 0) of the
    reference's layout: N(0, 0.02^2) matrices, N(0, 0.1^2) vectors, zero
    moments.  Both trainers resume from it, so they start alike."""
    cfg = j_reg.smoke_variant(cfg_name)
    t = JTrainer(cfg, j_adamw.AdamWConfig(**OPT), JTrainerConfig(
        steps=1, ckpt_dir=str(path), async_save=False))
    params, opt, _ = t.init_state()
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: jnp.asarray((rng.normal(size=a.shape) * (
        0.1 if a.ndim < 2 else 0.02)).astype(np.float32)), params)
    t.ckpt.save(0, {"params": params, "opt": opt},
                metadata={"next_step": 0, "loss": 0.0})
    return path


def _jax_trainer(d, steps, ckpt_every=100, **kw):
    return JTrainer(j_reg.smoke_variant(ARCH), j_adamw.AdamWConfig(**kw.pop(
        "opt", OPT)), JTrainerConfig(steps=steps, ckpt_every=ckpt_every,
                                     ckpt_dir=str(d), async_save=False,
                                     batch=4, seq_len=32, **kw))


def _port_trainer(d, steps, ckpt_every=100, **kw):
    return Trainer(t_reg.smoke_variant(ARCH), t_adamw.AdamWConfig(**kw.pop(
        "opt", OPT)), TrainerConfig(steps=steps, ckpt_every=ckpt_every,
                                    ckpt_dir=str(d), async_save=False,
                                    batch=4, seq_len=32, **kw),
                   device="cpu")


def test_trainer_losses_match_jax(tmp_path):
    """tests/test_system.py's config (30 steps, batch 4 x 32, lr 3e-3,
    warmup 5): every loss within 2e-4 of the JAX trainer's, falling by
    more than 0.1 (last 5 against first 5)."""
    _seed_dir(tmp_path / "j")
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    _, _, want = _jax_trainer(tmp_path / "j", 30, ckpt_every=10).run()
    trainer = _port_trainer(tmp_path / "t", 30, ckpt_every=10,
                            log_path=str(tmp_path / "log.jsonl"))
    _, _, got = trainer.run()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert np.mean(got[-5:]) < np.mean(got[:5]) - 0.1
    log = [json.loads(ln) for ln in
           (tmp_path / "log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == list(range(30))
    assert [r["loss"] for r in log] == got
    assert CheckpointManager(tmp_path / "t").all_steps() == [10, 20, 30]


def test_trainer_own_init_learns(tmp_path):
    """The port's own init (a torch.Generator seeded with ``seed``: the
    reference's init law) at tests/test_system.py's config and bar."""
    _, _, losses = _port_trainer(tmp_path, 30, ckpt_every=10).run()
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_trainer_resume_matches_uninterrupted(tmp_path):
    """tests/test_checkpoint.py's kill-and-restart on the port: 8 steps
    straight against 4, a restart, 4 more (on the CPU the same bits)."""
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=12)
    _, _, ref = _port_trainer(tmp_path / "a", 8, opt=opt).run()
    _port_trainer(tmp_path / "b", 4, ckpt_every=4, opt=opt).run()
    _, _, resumed = _port_trainer(tmp_path / "b", 8, ckpt_every=4,
                                  opt=opt).run()
    np.testing.assert_allclose(ref[4:], resumed, rtol=2e-4, atol=2e-5)
    assert ref[4:] == resumed


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, first):
    """A run cut at step 4 by one package's trainer and resumed to step 8
    by the other's, against the JAX trainer's straight 8 steps."""
    _seed_dir(tmp_path / "straight")
    shutil.copytree(tmp_path / "straight", tmp_path / "cut")
    _, _, want = _jax_trainer(tmp_path / "straight", 8).run()
    a, b = (_jax_trainer, _port_trainer) if first == "jax" \
        else (_port_trainer, _jax_trainer)
    a(tmp_path / "cut", 4, ckpt_every=4).run()
    _, _, got = b(tmp_path / "cut", 8, ckpt_every=4).run()
    np.testing.assert_allclose(got, want[4:], rtol=LOSS_RTOL)


def test_trainer_checkpoint_layout(tmp_path):
    """The port's checkpoint holds the reference's keys and shapes
    (stacked layers, AdamWState), and ``restore_or_init`` fills the
    trainer's tensors in place with the saved bits."""
    t = _port_trainer(tmp_path, 2, ckpt_every=2)
    params, opt, losses = t.run()
    jt = _jax_trainer(tmp_path, 2)
    jp, jo, _ = jt.init_state()
    want = jax.tree.map(lambda a: a.shape, {"params": jp, "opt": jo})
    tree, md = jt.ckpt.restore({"params": jp, "opt": jo})
    assert jax.tree.map(lambda a: a.shape, tree) == want
    assert md == {"next_step": 2, "loss": losses[-1]}
    t2 = _port_trainer(tmp_path, 2, ckpt_every=2)
    p2, o2, start = t2.restore_or_init()
    assert start == 2 and int(o2.count) == 2
    for k in params:
        assert torch.equal(p2[k], params[k])
        assert torch.equal(o2.m[k], opt.m[k])
        assert torch.equal(o2.v[k], opt.v[k])
    assert p2 is not params and p2[next(iter(p2))] is \
        dict(t2.model.named_parameters())[next(iter(p2))]


def test_stacked_leaf_round_trip(tmp_path):
    """``Stacked``: one array on disk, restored into its tensors in place;
    a plain tensor leaf in place too with ``in_place=True``."""
    rows = [torch.randn(3, 2) for _ in range(4)]
    bias = torch.randn(5)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": Stacked(rows), "b": bias})
    with np.load(tmp_path / "ckpt_1" / "shard_0.npz") as z:
        assert np.array_equal(z["w"], torch.stack(rows).numpy())
    into = [torch.zeros(3, 2) for _ in range(4)]
    b_into = torch.zeros(5)
    tree, _ = mgr.restore({"w": Stacked(into), "b": b_into}, in_place=True)
    assert tree["b"] is b_into and torch.equal(b_into, bias)
    assert all(torch.equal(a, b) for a, b in zip(into, rows))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": Stacked([torch.zeros(3, 2)] * 3), "b": b_into})


def test_restore_reads_compressed_members(tmp_path, monkeypatch):
    """``restore`` maps the members ``np.savez`` stores and reads any
    other member (here a compressed one, and a 0-d one) through
    ``np.load``: the same values either way."""
    import repro_torch.checkpoint.manager as M

    tree = {"w": torch.randn(4, 3), "c": torch.tensor(7, dtype=torch.int32)}
    for sub, savez in (("plain", np.savez), ("zipped", np.savez_compressed)):
        monkeypatch.setattr(M.np, "savez", savez)
        mgr = CheckpointManager(tmp_path / sub)
        mgr.save(1, tree)
        like = {"w": torch.zeros(4, 3),
                "c": torch.zeros((), dtype=torch.int32)}
        got, _ = mgr.restore(like)
        assert torch.equal(got["w"], tree["w"])
        assert torch.equal(got["c"], tree["c"])


# ------------------------------------------------------------ entry points

def test_launch_train_main_in_process(tmp_path, capsys):
    rc = t_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq-len", "16",
                       "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    assert rc == 0
    assert "final loss" in capsys.readouterr().out
    assert CheckpointManager(tmp_path).all_steps() == [2, 3]
    assert len((tmp_path / "train.jsonl").read_text().splitlines()) == 3


_PREFILL_WORLD = """
import json, pathlib, sys
sys.path.insert(0, sys.argv[2])
import torch
from repro_torch.configs import registry
from repro_torch.dist import bootstrap
from repro_torch.models import lm
from repro_torch.sharding import tensor_parallel as tp
torch.set_num_threads(1)
ctx = bootstrap.initialize(backend="gloo", device="cpu")
lay = tp.Layout(bootstrap.make_dist_mesh(1, 2))
out = {}
for arch in ("deepseek-v2-lite-16b", "whisper-tiny"):
    cfg = registry.smoke_variant(arch)
    model = lm.build_model(cfg, generator=torch.Generator().manual_seed(0),
                           layout=lay)
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int64)}
    if cfg.family == "audio":
        batch["audio_embeds"] = torch.zeros((2, cfg.n_audio_frames,
                                             cfg.d_model))
    caches = lm.init_cache(cfg, 2, 8, device="cpu", layout=lay)
    with torch.no_grad():
        logits, _ = lm.make_prefill_step(model)(caches, batch)
    out[arch] = [list(logits.shape), cfg.vocab_size,
                 bool(torch.isfinite(logits).all())]
pathlib.Path(sys.argv[1], f"rank{ctx.process_id}.json").write_text(
    json.dumps(out))
bootstrap.shutdown()
"""


def test_no_mesh_yet(tmp_path):
    """What a mesh runs and what it refuses: serving (prefill) under a
    model axis of 2, for a decoder and for whisper, runs in a gloo world
    of two processes and returns the full (B, V) logits on each rank
    (parity with JAX: tests/test_torch_serve_sharded.py); KV heads that a
    model axis does not divide (xlstm's, which no GQA reads, do not count)
    raise, and so does ``--devices`` over NCCL with more ranks than cards,
    naming why, with no fallback to one process or to the CPU."""
    from repro_torch.dist import launcher
    script = tmp_path / "prefill_world.py"
    script.write_text(_PREFILL_WORLD)
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    res = launcher.run_local(2, script, args=[str(tmp_path), src],
                             timeout_s=120, grace_s=5)
    assert res.ok, res.summary()
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        for arch, (shape, vocab, finite) in got.items():
            assert shape == [2, vocab] and finite, (arch, shape)
    four = _Mesh({"data": 1, "model": 4})
    with pytest.raises(ValueError, match="n_kv_heads = 2"):
        Trainer(t_reg.smoke_variant("mixtral-8x7b"), t_adamw.AdamWConfig(),
                TrainerConfig(ckpt_dir=str(tmp_path)), mesh=four,
                device="cpu")
    Trainer(t_reg.smoke_variant("xlstm-1.3b"), t_adamw.AdamWConfig(),
            TrainerConfig(ckpt_dir=str(tmp_path)), mesh=four, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="a card per rank"):
            t_train.main(["--arch", ARCH, "--smoke", "--devices", "2",
                          "--ckpt-dir", str(tmp_path)])


def test_train_step_moves_every_parameter():
    """One step of the port's own init moves every leaf (tests/
    test_models.py's check), with the model's parameters now trainable
    and a serving model's frozen."""
    cfg = t_reg.smoke_variant(ARCH)
    model = t_lm.build_model(cfg, generator=torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in model.parameters())
    before = {k: p.detach().clone()
              for k, p in t_lm.trainable_params(model).items()}
    step = t_lm.make_train_step(model, t_adamw.AdamWConfig(lr=1e-3))
    params = t_lm.trainable_params(model)
    assert all(p.requires_grad for p in params.values())
    _, m = step(t_adamw.adamw_init(params),
                TokenPipeline(cfg.vocab_size, 2, 16).batch_at(0))
    assert np.isfinite(float(m["loss"]))
    assert all(not torch.equal(before[k], p) for k, p in params.items())
