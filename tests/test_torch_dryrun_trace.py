"""The port's traced dry-run (``roofline.hlo.analyze_step``,
``launch.dryrun.trace_step`` and its extrapolation) at smoke widths,
against the JAX package's ``analyze_hlo``, a live gloo world and full
traces.

The module is also its own script:

  * ``--jax-ref OUT`` (4 fake XLA devices) compiles JAX's step for every
    case of ``JAX_CASES`` in one process and writes ``analyze_hlo``'s
    flops, the flops of the products named below, and XLA's temp bytes;
  * ``--gloo-worker OUT`` runs as one rank of a two-rank gloo world on
    the CPU (``repro_torch.dist.launcher``) and writes the collectives
    (``collectives.collective_trace``) of one train step and one decode
    step of the same smoke config on (1, 2).

Bars, each with its reason:

  * flops against ``analyze_hlo``: 2% of the rest once the products that
    only one package computes are taken out of both counts.  Named:
      - every train step: the reference's ``vocab_parallel_ce`` pads a
        rank's tokens to a chunk of 8192 (``src/repro/models/lm.py:
        115-133``) and runs the unembedding's products (logits, and their
        gradients) over the padded chunk, while the port's loss runs over
        the batch's own tokens, its forward once more under the chunk's
        checkpoint where the vocabulary is split (``lm.vocab_parallel_ce``).
        JAX's are the dots with a dimension of the chunk, the port's
        ``ce_flops``;
      - moe: the reference's one-hot dispatch and combine einsums
        (``src/repro/models/moe.py:98-103``, the dots with a dimension of
        experts x capacity), where the port scatters and gathers rows
        (``moe.moe_apply``);
      - ssm: the mLSTM step's products over a contraction of one.  Both
        packages form the memory's update k v^T and the normalizer q.n as
        products (the reference's einsums ``bhk,bhv->bhkv``,
        ``bhk,bhk->bh``; the port's plain step, ``kernels.ref.mlstm_step``,
        as matmuls), and both count their contracted products (k v^T's
        gradients, q.n itself).  But XLA rewrites a dot without a
        contraction into a multiply, which ``analyze_hlo`` does not count,
        while the port's autograd keeps such products as matmuls over a
        contraction of one: k v^T itself, the memory's gradient from
        ``q @ C`` and q.n's gradients.  Those are the port's named
        products; the reference names none for the ssm family on one
        card.
    On (1, 4) the two partitionings also put some products on a card
    differently; each is named (``MOVED``, ``moved_flops``) and taken out
    of both counts at its own share:
      - x @ W of the weights the port keeps whole on every card, over
        all the tokens, where the reference's partitioner splits the
        tokens four ways: MLA's latent down-projection ``w_dkv`` (moe),
        Mamba2's ``w_B`` and ``w_C`` (hybrid), the mLSTM's gates ``wi``
        and ``wf`` (ssm).  Each is 6 x tokens x its parameters (the
        product and its two gradients) on a port card, a quarter of that
        on a reference card;
      - ssm: the mLSTM cell's readout q C (``bhk,bhkv->bhv``), which the
        reference keeps whole on every card and the port splits over the
        value dim: 2 x 2 x tokens x heads x head_dim x head_dim / 4 a
        mLSTM layer on a port card (the product and the query's
        gradient; the memory's is the rank-one product above); and the
        contracted products of k v^T and q.n, which the two partitioners
        place differently: on a port card k v^T's two gradients over the
        value dim's block, 2 x 2 x tokens x heads x head_dim x head_dim /
        4, and q.n whole, 2 x tokens x heads x head_dim, a mLSTM layer;
        on a reference card the einsums' dots named above;
  * JAX's temp bytes are printed beside the port's, not held: XLA
    schedules and fuses its own buffers;
  * the traced collectives equal a live world's, kind for kind, size for
    size and in order: both come from the same ``record_collective``
    calls, so anything but equality is a fault;
  * a trace over fake tensors equals the same tracer over the real CPU
    step: the same ops and the same live-bytes timeline, whatever the
    data;
  * the extrapolated flops, bytes and collectives equal a full trace
    (each is a polynomial in the length at a fixed structure, solved
    exactly); the extrapolated peak is held to 10% of the full trace's,
    as the largest of its phases' fits (measured: 1.6% under for zamba2
    at 256 tokens, 9.3% over for xlstm at 128).
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
SRC = REPO / "src"
THIS = pathlib.Path(__file__).resolve()
SEQ, BATCH = 32, 4
CE_CHUNK_JAX = 8192
# the recurrent families' smoke configs cut to one period of blocks (two
# shared-block applications, one mLSTM + sLSTM group) and 16 tokens:
# their steps loop over time, and a trace dispatches every iteration
CUT = {"zamba2-1.2b": (16, {"n_layers": 4}),
       "xlstm-1.3b": (16, {"n_layers": 4})}
# (arch, kind, data, model): every family's train step on (1, 4), the
# moe, hybrid and ssm ones' on one card too, and the dense family's
# prefill and decode on 1 and (1, 4)
JAX_CASES = [(arch, "train", 1, m) for arch in (
    "deepseek-v2-lite-16b", "zamba2-1.2b", "xlstm-1.3b") for m in (1, 4)] + [
    ("phi4-mini-3.8b", "train", 1, 4),
    ("llama-3.2-vision-11b", "train", 1, 4),
    ("whisper-tiny", "train", 1, 4)] + [
    ("phi4-mini-3.8b", kind, 1, m) for kind in ("prefill", "decode")
    for m in (1, 4)]
# the weights whose products the port keeps whole on every card of (1, M)
# and the reference splits M ways (module docstring)
MOVED = {"moe": ("w_dkv",), "hybrid": ("w_B", "w_C"), "ssm": ("wi", "wf")}
WORLD_TIMEOUT_S = 240


def _key(case) -> str:
    arch, kind, d, m = case
    return f"{arch}/{kind}/{d}x{m}"


def _seq(arch) -> int:
    return CUT.get(arch, (SEQ, {}))[0]


def _over(arch) -> dict:
    return CUT.get(arch, (SEQ, {}))[1]


# ---------------------------------------------------------------------------
# JAX's side (fake devices)
# ---------------------------------------------------------------------------

def _jax_named_flops(mod, dims, names=()) -> float:
    """Flops of the dots with a dimension of ``dims`` in their result or an
    operand, or with one of ``names`` in their op name, weighted by their
    trips."""
    import collections
    import re

    from repro.roofline import hlo as H
    mult = collections.Counter()

    def walk(name, k):
        mult[name] += k
        for op in mod.comps.get(name, []):
            if op.kind == "while":
                body = re.search(r"body=%?([\w\.\-]+)", op.line)
                cond = re.search(r"condition=%?([\w\.\-]+)", op.line)
                walk(body.group(1), k * (mod._trip_count(cond.group(1))
                                         if cond else 1.0))
            elif op.kind in ("call", "conditional", "async-start",
                             "fusion"):
                for c in mod._callees(op):
                    walk(c, k)

    walk(mod.entry, 1.0)
    total = 0.0
    for name, k in mult.items():
        for op in mod.comps[name]:
            if op.kind != "dot":
                continue
            shapes = [H._sig_dims(op.result_sig)[1]] + [
                H._sig_dims(mod.shape_of.get(o, ""))[1]
                for o in op.operands if o not in mod.comps]
            if any(d in shp for shp in shapes for d in dims) or any(
                    f"/{n}/" in op.line for n in names):
                total += mod._dot_flops(op) * k
    return total


def _jax_named(cfg, mod, tokens) -> dict:
    """The named products' flops of a compiled step (module docstring)."""
    out = {"ce": _jax_named_flops(mod, (CE_CHUNK_JAX,))}
    if cfg.family == "moe":
        from repro.models import moe
        n_g = min(moe.GROUP_SIZE, tokens) if hasattr(
            moe, "GROUP_SIZE") else min(256, tokens)
        cap = moe._capacity(n_g, cfg.n_experts, cfg.top_k)
        out["family"] = _jax_named_flops(mod, (cfg.n_experts * cap,))
    elif cfg.family == "ssm":
        out["family"] = _jax_named_flops(
            mod, (), ("bhk,bhv->bhkv", "bhk,bhk->bh"))
        out["readout"] = _jax_named_flops(mod, (), ("bhk,bhkv->bhv",))
    return out


def _jax_ref(out: str) -> int:
    import jax
    from jax.sharding import Mesh

    from repro.configs.base import ShapeSpec, tp_pad_config
    from repro.configs.registry import smoke_variant
    from repro.models import lm
    from repro.optim import adamw
    from repro.roofline.hlo import HLOModule

    devs = np.array(jax.devices()[:4])
    res = {}
    for case in JAX_CASES:
        arch, kind, d, m = case
        mesh = Mesh(devs[:d * m].reshape(d, m), ("data", "model"))
        cfg, _ = tp_pad_config(smoke_variant(arch).replace(**_over(arch)),
                               m)
        shape = ShapeSpec(f"smoke_{kind}", _seq(arch), BATCH, kind)
        with mesh:
            batch, caches, cache_len, token = lm.input_specs(cfg, shape,
                                                             mesh)
            params, opt = lm.abstract_state(cfg, mesh,
                                            with_opt=kind == "train")
            if kind == "train":
                step, _ = lm.make_train_step(cfg, adamw.AdamWConfig())
                lowered = jax.jit(step, donate_argnums=(0, 1)).lower(
                    params, opt, batch)
            elif kind == "prefill":
                step, _ = lm.make_prefill_step(cfg)
                lowered = jax.jit(step, donate_argnums=(1,)).lower(
                    params, caches, batch)
            else:
                step, _ = lm.make_decode_step(cfg)
                lowered = jax.jit(step, donate_argnums=(1,)).lower(
                    params, caches, token, cache_len, batch)
        compiled = lowered.compile()
        mod = HLOModule(compiled.as_text())
        res[_key(case)] = {
            "flops": mod.analyze().flops,
            **_jax_named(cfg, mod, BATCH * shape.seq_len),
            "temp_bytes": int(compiled.memory_analysis().temp_size_in_bytes)}
    pathlib.Path(out).write_text(json.dumps(res))
    return 0


@pytest.fixture(scope="module", autouse=True)
def jax_run(tmp_path_factory):
    """JAX's compiles, started with the module's first test so that they
    run beside the port's traces; ``jax_ref`` waits for them."""
    out = tmp_path_factory.mktemp("dryrun_trace") / "jax.json"
    env = dict(os.environ, PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, str(THIS), "--jax-ref",
                             str(out)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_ref(jax_run):
    proc, out = jax_run
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-6000:]
    return json.loads(out.read_text())


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

def _cfg(arch, m, **kw):
    from repro_torch.configs.base import tp_pad_config
    from repro_torch.configs.registry import smoke_variant
    cfg, _ = tp_pad_config(smoke_variant(arch), m)
    return cfg.replace(**kw) if kw else cfg


def _shape(kind, seq=SEQ, batch=BATCH):
    from repro_torch.configs.base import ShapeSpec
    return ShapeSpec(f"smoke_{kind}", seq, batch, kind)


def _trace(arch, kind, d, m, **kw):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    return dryrun.trace_step(_cfg(arch, m, **kw),
                             _shape(kind, seq=_seq(arch)),
                             AbstractMesh((d, m)))


def ce_flops(cfg, kind, m, tokens) -> float:
    """The port's unembedding products of the loss: the logits and their
    two gradients over the batch's tokens, and the logits once more under
    the chunk's checkpoint where the vocabulary is split."""
    if kind != "train":
        return 0.0
    n = 4 if m > 1 else 3
    return n * 2.0 * tokens * cfg.d_model * cfg.vocab_size / m


def moved_flops(cfg, kind, m, tokens) -> tuple:
    """(a port card's, a reference card's) flops of the products the two
    partitionings place differently on (1, ``m``), but the reference's
    readout, which is read from its module (module docstring)."""
    if kind != "train" or m == 1 or cfg.family not in MOVED:
        return 0.0, 0.0
    import math

    from repro_torch.models import lm
    from repro_torch.models.common import flatten
    params = sum(math.prod(d.shape) for name, d in
                 flatten(lm.param_defs(cfg)).items()
                 if name.split(".")[-1] in MOVED[cfg.family])
    port = 6.0 * tokens * params
    ref = port / m
    if cfg.family == "ssm":
        from repro_torch.models import xlstm
        H, hd = xlstm._heads(cfg)
        n_mlstm = cfg.n_layers // cfg.slstm_period * (cfg.slstm_period - 1)
        # the readout and the query's gradient; k v^T's two gradients and
        # q.n (whole)
        port += 2 * 2.0 * tokens * H * hd * hd / m * n_mlstm
        port += (2 * 2.0 * tokens * H * hd * hd / m
                 + 2.0 * tokens * H * hd) * n_mlstm
    return port, ref


def test_a_loop_is_counted_by_its_trips():
    """test_roofline.py's scan of matmuls: k matmuls in a loop count k
    times, and the bytes of each."""
    import torch

    from repro_torch.roofline import hlo
    with hlo.fake_mode():
        a, w = torch.empty(8, 16), torch.empty(16, 16)

        def loop(a, w, k=10):
            for _ in range(k):
                a = a @ w
            return a
        tr = hlo.analyze_step(loop, a, w)
    assert tr.stats.flops == 10 * 2 * 8 * 16 * 16
    assert tr.stats.bytes_accessed == 10 * 4 * (8 * 16 + 16 * 16 + 8 * 16)


def test_a_backward_is_counted():
    """A matmul's backward adds its two products (dx, dw); one input
    without a gradient drops its product."""
    import torch

    from repro_torch.roofline import hlo
    for x_grad, products in ((True, 3), (False, 2)):
        with hlo.fake_mode():
            x = torch.empty(8, 16, requires_grad=x_grad)
            w = torch.empty(16, 4, requires_grad=True)

            def step(x):
                (x @ w).sum().backward()
            tr = hlo.analyze_step(step, x, state={"w": w})
        assert tr.stats.flops == products * 2 * 8 * 16 * 4
        assert tr.phase_peak.keys() == {"forward", "backward:"}


def test_a_view_is_not_charged_for_its_buffer():
    """An op on a slice of a large buffer reads the slice, and the slice
    itself moves nothing."""
    import torch

    from repro_torch.roofline import hlo
    with hlo.fake_mode():
        big = torch.empty(1024, 64)
        tr = hlo.analyze_step(lambda t: t[:4] * 2.0, big)
    assert tr.stats.bytes_accessed == 2 * 4 * 64 * 4
    assert tr.memory["argument_bytes"] == 1024 * 64 * 4
    assert tr.memory["peak_bytes_est"] == (1024 + 4) * 64 * 4
    assert tr.memory["output_bytes"] == 4 * 64 * 4


def test_in_place_updates_are_aliases():
    """The train step writes its parameters and moments in place: they
    are the aliases, and the outputs hold them and the metrics."""
    tr = _trace("phi4-mini-3.8b", "train", 1, 1)
    mem = tr.memory
    assert 0 < mem["alias_bytes"] <= mem["output_bytes"]
    assert mem["output_bytes"] - mem["alias_bytes"] < 64 * 1024
    assert mem["peak_bytes_est"] == mem["argument_bytes"] + \
        mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"]


def test_fake_trace_equals_the_real_cpu_step():
    """analyze_step over the real CPU train step of the smoke config
    (weights from a generator, random tokens) counts what the fake trace
    counts: flops, bytes, every memory field and the phases' peaks."""
    import torch

    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.roofline import hlo
    from repro_torch.sharding import tensor_parallel as tp
    cfg = _cfg("phi4-mini-3.8b", 1, remat=True)
    fake = _trace("phi4-mini-3.8b", "train", 1, 1, remat=True)
    lay = tp.Layout.dry((1, 1))
    model = lm.build_model(cfg, generator=torch.Generator().manual_seed(0),
                           layout=lay)
    step = lm.make_train_step(model, adamw.AdamWConfig(), layout=lay)
    params = lm.trainable_params(model)
    opt = adamw.adamw_init(params)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, SEQ),
                                        dtype=np.int32))
    batch = {"tokens": tok, "targets": tok.roll(-1, 1),
             "loss_mask": torch.ones((BATCH, SEQ))}
    real = hlo.analyze_step(step, opt, batch, state=params)
    assert real.stats.as_dict() == fake.stats.as_dict()
    assert real.memory == fake.memory
    assert real.phase_peak == fake.phase_peak
    assert real.n_ops == fake.n_ops


# the smoke configs with a shorter period, so that the depth holds two
# and a half shared blocks (zamba2) or two mLSTM + sLSTM groups (xlstm);
# 96 tokens, the shortest length past the fit's five units of 16 (the
# scans' checkpoint stride, ``kernels.ref.CKPT_EVERY``; zamba2's
# attention in two chunks of 48)
EXTRAPOLATED = [("zamba2-1.2b", 96, {"n_layers": 5, "shared_attn_every": 2,
                                     "attn_chunk": 48}),
                ("xlstm-1.3b", 96, {"n_layers": 4, "slstm_period": 2})]


@pytest.mark.parametrize("arch,seq,over", EXTRAPOLATED,
                         ids=[c[0] for c in EXTRAPOLATED])
def test_extrapolation_equals_a_full_trace(arch, seq, over):
    """A train step whose model loops over time, solved from short traces
    and depth cuts (``dryrun.fit_plan``), against the full trace at a
    moderate length: flops, bytes and collectives equal; the peak within
    10% (module docstring).  The fit's own two held-out traces (a longer
    length, a deeper cut) matched it exactly."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    cfg = _cfg(arch, 1, **over)
    shape, mesh = _shape("train", seq=seq, batch=2), AbstractMesh((1, 1))
    plan = dryrun.fit_plan(cfg, shape, mesh)
    assert plan is not None and 5 * plan.unit < seq
    assert plan.held_layers not in plan.cuts
    st, memory, rec = dryrun.extrapolate(cfg, shape, mesh, plan)
    assert [(h["seq"], h["layers"], h["exact"]) for h in rec["held_out"]] \
        == [(5 * plan.unit, plan.cuts[0], True),
            (2 * plan.unit, plan.held_layers, True)]
    full = dryrun.trace_step(cfg, shape, mesh)
    assert st.as_dict() == full.stats.as_dict()
    for k in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert memory[k] == full.memory[k], k
    assert memory["peak_bytes_est"] == pytest.approx(
        full.memory["peak_bytes_est"], rel=0.10)


def test_decode_and_prefill_trace_whole():
    """Decode runs no loop over time and is traced whole; so is every
    family without a time loop."""
    from repro_torch.configs import SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract_mesh
    for arch in ("zamba2-1.2b", "xlstm-1.3b", "phi4-mini-3.8b"):
        for shape in ("decode_32k", "long_500k"):
            assert dryrun.fit_plan(get_arch(arch), SHAPES[shape],
                                   abstract_mesh(4)) is None
    plan = dryrun.fit_plan(get_arch("zamba2-1.2b"), SHAPES["train_4k"],
                           abstract_mesh(4))
    assert plan.n_attn_chunks == 4 and plan.n_ce_chunks == 128
    assert dryrun.fit_plan(get_arch("phi4-mini-3.8b"), SHAPES["train_4k"],
                           abstract_mesh(4)) is None


# ---------------------------------------------------------------------------
# collectives against a live two-rank world
# ---------------------------------------------------------------------------

def _gloo_worker(out: pathlib.Path) -> int:
    import torch

    from repro_torch.dist import bootstrap
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.sharding import collectives
    from repro_torch.sharding import tensor_parallel as tp

    ctx = bootstrap.initialize(device="cpu", backend="gloo", timeout_s=60)
    lay = tp.Layout(bootstrap.make_dist_mesh(1, 2))
    cfg = _cfg("phi4-mini-3.8b", 2)
    model = lm.build_model(cfg, generator=torch.Generator().manual_seed(0),
                           layout=lay)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int32)
    batch = {"tokens": tok, "targets": np.roll(tok, -1, 1),
             "loss_mask": np.ones((BATCH, SEQ), np.float32)}
    step = lm.make_train_step(model, adamw.AdamWConfig(), layout=lay)
    opt = adamw.adamw_init(lm.trainable_params(model))
    with collectives.collective_trace() as train_ev:
        step(opt, batch)
    caches = lm.init_cache(cfg, BATCH, SEQ, device="cpu", layout=lay)
    token = torch.from_numpy(tok[:, :1]).long()
    with collectives.collective_trace() as decode_ev, torch.no_grad():
        lm.make_decode_step(model)(caches, token, SEQ - 1)
    (out / f"rank{ctx.process_id}.json").write_text(json.dumps(
        {"train": train_ev, "decode": decode_ev}))
    bootstrap.shutdown()
    return 0


def test_collectives_equal_a_live_gloo_world(tmp_path):
    """Rank 0's traced collectives on the dry (1, 2) world equal what
    ``collective_trace`` records on a live two-rank gloo world running
    the same train step and decode step: op, mesh dim, group size,
    elements and dtype, in order; and their StepStats (kinds, counts and
    result bytes) too."""
    from repro_torch.dist import launcher
    from repro_torch.roofline import hlo
    res = launcher.run_local(2, THIS, args=["--gloo-worker", str(tmp_path)],
                             timeout_s=WORLD_TIMEOUT_S, grace_s=20)
    assert res.ok, res.summary()
    live = json.loads((tmp_path / "rank0.json").read_text())
    for kind in ("train", "decode"):
        tr = _trace("phi4-mini-3.8b", kind, 1, 2)
        got = [list(e) for e in tr.collectives]
        assert got == live[kind], kind
        st = hlo.collective_stats([tuple(e) for e in live[kind]])
        assert st.as_dict() == hlo.collective_stats(
            tr.collectives).as_dict()
        assert tr.stats.collective_counts == st.collective_counts
        assert sum(st.collective_counts.values()) > 0


# ---------------------------------------------------------------------------
# flops against JAX's analyze_hlo (last: JAX compiles meanwhile)
# ---------------------------------------------------------------------------

def port_named(cfg, tr) -> float:
    """The port's products of its family named in the module docstring:
    the ssm's matmuls over a contraction of one (a multiply in XLA)."""
    if cfg.family != "ssm":
        return 0.0
    return sum(f for (op, k), f in tr.products.items() if k == 1)


@pytest.mark.parametrize("case", JAX_CASES, ids=_key)
def test_flops_match_jaxs_analyze_hlo(jax_ref, case):
    """StepStats.flops of the port's step against analyze_hlo's of JAX's
    compiled step, same config and mesh, the named products out."""
    arch, kind, d, m = case
    want = jax_ref[_key(case)]
    cfg = _cfg(arch, m, **_over(arch))
    tr = _trace(arch, kind, d, m, **_over(arch))
    tokens = BATCH * _seq(arch)
    named = port_named(cfg, tr)
    named_ref = want.get("family", 0.0) if cfg.family == "moe" else 0.0
    moved, moved_ref = moved_flops(cfg, kind, m, tokens)
    if moved and cfg.family == "ssm":
        moved_ref += want["readout"] + want["family"]
    got = tr.stats.flops - ce_flops(cfg, kind, m, tokens) - named - moved
    rest = want["flops"] - want["ce"] - named_ref - moved_ref
    print(f"{_key(case)}: flops {got:.6g} (jax {rest:.6g}); named "
          f"{named:.6g} (jax {named_ref:.6g}); moved "
          f"{moved:.6g} (jax {moved_ref:.6g}); temp bytes "
          f"{tr.memory['temp_bytes']} (jax {want['temp_bytes']})")
    assert got == pytest.approx(rest, rel=0.02)
    assert (want["ce"] > 0) == (kind == "train")
    assert (want.get("family", 0.0) > 0) == (cfg.family in ("moe", "ssm"))
    assert (named > 0) == (cfg.family == "ssm")
    assert (moved > 0) == (m > 1 and cfg.family in MOVED)



if __name__ == "__main__":
    if "--jax-ref" in sys.argv:
        sys.exit(_jax_ref(sys.argv[sys.argv.index("--jax-ref") + 1]))
    if "--gloo-worker" in sys.argv:
        sys.path.insert(0, str(SRC))
        sys.exit(_gloo_worker(pathlib.Path(
            sys.argv[sys.argv.index("--gloo-worker") + 1])))
