"""The LM template's moe, hybrid, ssm, vlm and audio families of the port
(``repro_torch.models``: MLA and cross attention, ``moe``, ``ssm``,
``xlstm``, ``whisper``, the family branches of ``transformer`` and
``lm``) against the JAX package's (``repro.models``) on the CPU, at the
smoke configs.

The same numpy inputs and the JAX package's own initial weights (carried
across by ``convert.lm_params_from_numpy``) go to both packages.

Tolerances, each relative to the largest |value| of the reference's
output:
- the blocks (MLA, cross attention, MoE, Mamba2, mLSTM, sLSTM) on
  N(0, 1) inputs with weights of std 1/sqrt(fan_in): 1e-5, float32 with
  the sums in another order;
- a model's logits and hidden states: 5e-4, the dense family's bar
  (tests/test_torch_models.py: the reference's init gives the attention
  logits a std of tens, so each layer amplifies the float32 roundings of
  the last);
- prefill plus decode against the full forward within the port: the
  reference's own ``_DECODE_TOL`` (tests/test_models.py: 1e-3, 5e-3 for
  zamba2, 2e-2 for xlstm), with ``moe.CAPACITY_FACTOR = 16`` in both
  packages so that no token drops, as that test does;
- greedy tokens: equal.
"""
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_reg
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import lm as j_lm
from repro.models import moe as j_moe
from repro.models import ssm as j_ssm
from repro.models import xlstm as j_xlstm
from repro_torch import convert
from repro_torch.configs import registry as t_reg
from repro_torch.launch import serve as t_serve
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import lm as t_lm
from repro_torch.models import moe as t_moe
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tf
from repro_torch.models import whisper as t_whisper
from repro_torch.models import xlstm as t_xlstm

REPO = pathlib.Path(__file__).resolve().parents[1]
# moe (two), hybrid, ssm, vlm, audio
NEW = ["deepseek-v2-lite-16b", "llama-3.2-vision-11b", "mixtral-8x7b",
       "whisper-tiny", "xlstm-1.3b", "zamba2-1.2b"]
B, S = 2, 24
OP_TOL = 1e-5
MODEL_TOL = 5e-4
DECODE_TOL = {"xlstm-1.3b": 2e-2, "zamba2-1.2b": 5e-3}   # else 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke widths: torch's intra-op threads buy nothing here and, beside
    the other test workers, spin on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_drops(monkeypatch):
    """Both packages' MoE with capacity for every token."""
    monkeypatch.setattr(j_moe, "CAPACITY_FACTOR", 16.0)
    monkeypatch.setattr(t_moe, "CAPACITY_FACTOR", 16.0)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / max(np.max(np.abs(want)), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tokens(vocab: int, shape=(B, S), seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _weights(defs_tree, seed: int) -> dict:
    """numpy weights for a (JAX) ParamDef tree: normal with std
    1/sqrt(fan_in) (fan_in the second-to-last dim), 0.1 for vectors."""
    rng = np.random.default_rng(seed)

    def mk(d):
        if len(d.shape) < 2:
            return (rng.normal(size=d.shape) * 0.1).astype(np.float32)
        return (rng.normal(size=d.shape) / np.sqrt(d.shape[-2])).astype(
            np.float32)
    return jax.tree.map(mk, defs_tree,
                        is_leaf=lambda x: isinstance(x, j_common.ParamDef))


def _both(tree):
    """(JAX arrays, torch tensors) of a numpy tree."""
    return (jax.tree.map(jnp.asarray, tree),
            t_common.unflatten({k: _t(v) for k, v in
                                t_common.flatten(tree).items()}))


@functools.lru_cache(maxsize=None)
def _pair(name: str):
    """(JAX config, JAX model, JAX params, port model) of a smoke config,
    the port over the JAX package's initial weights."""
    j_cfg = j_reg.smoke_variant(name)
    j_model = j_lm.build_model(j_cfg)
    defs = j_model.param_defs()
    params = jax.jit(lambda key: j_common.init_params(defs, key))(
        jax.random.PRNGKey(0))
    state = convert.lm_params_from_numpy(
        t_reg.smoke_variant(name), jax.tree.map(np.asarray, params),
        device="cpu")
    return j_cfg, j_model, params, t_lm.build_model(
        t_reg.smoke_variant(name), state=state)


def _extra(cfg, batch: int = B, seed: int = 7) -> dict:
    """The modality stubs as numpy arrays (none for a text family)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"image_embeds": rng.normal(
            size=(batch, cfg.n_image_tokens, cfg.d_model)).astype(
                np.float32)}
    if cfg.family == "audio":
        return {"audio_embeds": rng.normal(
            size=(batch, cfg.n_audio_frames, cfg.d_model)).astype(
                np.float32)}
    return {}


def _jx(extra):
    return {k: jnp.asarray(v) for k, v in extra.items()}


def _tx(extra):
    return {k: torch.from_numpy(v) for k, v in extra.items()}


@functools.lru_cache(maxsize=None)
def _jax_decode(j_cfg):
    """The reference's decode step, jitted as its serve loop jits it."""
    j_model = j_lm.build_model(j_cfg)
    return jax.jit(lambda p, c, t, i, kw: j_model.forward(
        p, t, mode="decode", caches=c, cache_len=i, **kw))


@functools.lru_cache(maxsize=None)
def _jax_forward(j_cfg, mode: str = "train", hidden: bool = False):
    """The reference's forward in ``mode``, jitted (its eager dispatch is
    several times slower here)."""
    j_model = j_lm.build_model(j_cfg)
    return jax.jit(lambda p, t, c, kw: j_model.forward(
        p, t, mode=mode, caches=c, return_hidden=hidden, **kw))


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def test_mla_full_and_decode_match_jax():
    """deepseek's MLA at the smoke widths (16 + 8 query/key channels, 16
    value channels), 37 positions in chunks of 16, then decode steps at
    positions 37-39 against the latent cache."""
    cfg = j_reg.smoke_variant("deepseek-v2-lite-16b")
    tcfg = t_reg.smoke_variant("deepseek-v2-lite-16b")
    jp, tp = _both(_weights(j_attn.mla_defs(cfg), 1))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, 40, cfg.d_model)).astype(np.float32)
    s_max = 40
    j_cache = {k: jnp.zeros(d.shape) for k, d in
               j_attn.mla_cache_defs(cfg, B, s_max).items()}
    t_cache = {k: torch.zeros(d.shape) for k, d in
               t_attn.mla_cache_defs(tcfg, B, s_max).items()}
    want, j_cache = jax.jit(lambda p, x_, c: j_attn.mla_full(
        p, x_, cfg, cache=c))(jp, jnp.asarray(x[:, :37]), j_cache)
    got, t_cache = t_attn.mla_full(tp, _t(x[:, :37]), tcfg, cache=t_cache)
    assert got.shape == (B, 37, cfg.d_model)
    assert _rel(got, want) <= OP_TOL
    for k in ("ckv", "kpe"):
        assert _rel(t_cache[k], j_cache[k]) <= OP_TOL
    j_decode = jax.jit(lambda p, x_, c, i: j_attn.mla_decode(p, x_, cfg, c,
                                                             i))
    for i in range(37, 40):
        want, j_cache = j_decode(jp, jnp.asarray(x[:, i:i + 1]), j_cache,
                                 jnp.int32(i))
        got, t_cache = t_attn.mla_decode(tp, _t(x[:, i:i + 1]), tcfg,
                                         t_cache, i)
        assert _rel(got, want) <= OP_TOL, i
    full, _ = t_attn.mla_full(tp, _t(x), tcfg)
    assert _rel(got[:, 0], full[:, -1]) <= OP_TOL


def test_cross_apply_matches_jax():
    """37 image tokens in chunks of 16: the padded tail of the last chunk
    is masked; no causal mask, no rope; GQA rep 2."""
    cfg = j_reg.smoke_variant("llama-3.2-vision-11b")
    jp, tp = _both(_weights(j_attn.cross_defs(cfg), 3))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 11, cfg.d_model)).astype(np.float32)
    img = rng.normal(size=(B, 37, cfg.d_model)).astype(np.float32)
    want = j_attn.cross_apply(jp, jnp.asarray(x), jnp.asarray(img), cfg)
    got = t_attn.cross_apply(tp, _t(x), _t(img),
                             t_reg.smoke_variant("llama-3.2-vision-11b"))
    assert _rel(got, want) <= OP_TOL


MOE_CASES = {"deepseek_no_drop": ("deepseek-v2-lite-16b", 16.0, False),
             "deepseek_default": ("deepseek-v2-lite-16b", 1.5, False),
             "mixtral_default": ("mixtral-8x7b", 1.5, False),
             "deepseek_skewed_drops": ("deepseek-v2-lite-16b", 1.5, True),
             "mixtral_skewed_drops": ("mixtral-8x7b", 1.5, True)}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_jax(case, monkeypatch):
    """B x S = 2 x 256 tokens: two groups of 256.  The skewed cases add a
    large bias toward expert 0 to the router, so its capacity overflows
    and tokens drop: the same slots, drops and gates in both packages."""
    name, cap, skewed = MOE_CASES[case]
    monkeypatch.setattr(j_moe, "CAPACITY_FACTOR", cap)
    monkeypatch.setattr(t_moe, "CAPACITY_FACTOR", cap)
    cfg, tcfg = j_reg.smoke_variant(name), t_reg.smoke_variant(name)
    w = _weights(j_moe.moe_defs(cfg), 5)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, 256, cfg.d_model)).astype(np.float32)
    if skewed:
        # expert 0's logit is raised by 3 x |x_0|: most tokens pick it
        w["router"][0, 0] += 3.0
        x[..., 0] = np.abs(x[..., 0])
    jp, tp = _both(w)
    want = jax.jit(lambda p, x_: j_moe.moe_apply(p, x_, cfg))(
        jp, jnp.asarray(x))
    got = t_moe.moe_apply(tp, _t(x), tcfg)
    assert _rel(got, want) <= OP_TOL
    _, _, slot, C = t_moe.route(tp, _t(x), tcfg)
    dropped = int((slot >= C).sum())
    if skewed:
        assert dropped > 0, "the skewed router dropped no token"
        # the drops show: the same input at capacity for every token
        monkeypatch.setattr(t_moe, "CAPACITY_FACTOR", 16.0)
        assert _rel(t_moe.moe_apply(tp, _t(x), tcfg), got) > 1e-2
    elif cap == 16.0:
        assert dropped == 0


def test_moe_groups_must_divide_the_tokens():
    """3 x 100 tokens in groups of 256: the reference's reshape to (G, n_g,
    d) fails, and the port raises ValueError there (ROADMAP Queue 3 item
    12)."""
    name = "deepseek-v2-lite-16b"
    cfg, tcfg = j_reg.smoke_variant(name), t_reg.smoke_variant(name)
    jp, tp = _both(_weights(j_moe.moe_defs(cfg), 5))
    x = np.random.default_rng(7).normal(size=(3, 100, cfg.d_model)).astype(
        np.float32)
    with pytest.raises(TypeError):
        j_moe.moe_apply(jp, jnp.asarray(x), cfg)
    with pytest.raises(ValueError, match="do not split into groups of 256"):
        t_moe.moe_apply(tp, _t(x), tcfg)
    # 2 x 100 tokens fit one group of 200
    assert _rel(t_moe.moe_apply(tp, _t(x[:2]), tcfg),
                j_moe.moe_apply(jp, jnp.asarray(x[:2]), cfg)) <= OP_TOL


def test_moe_aux_loss_and_capacity_match_jax():
    name = "mixtral-8x7b"
    cfg, tcfg = j_reg.smoke_variant(name), t_reg.smoke_variant(name)
    jp, tp = _both(_weights(j_moe.moe_defs(cfg), 8))
    x = np.random.default_rng(9).normal(size=(B, 16, cfg.d_model)).astype(
        np.float32)
    assert float(t_moe.moe_aux_loss(tp, _t(x), tcfg)) == pytest.approx(
        float(j_moe.moe_aux_loss(jp, jnp.asarray(x), cfg)), rel=1e-6)
    for n_g, E, k in ((256, 64, 6), (256, 8, 2), (2, 8, 2), (2, 64, 6)):
        assert t_moe._capacity(n_g, E, k) == j_moe._capacity(n_g, E, k)


def test_mamba_full_and_decode_match_jax():
    """zamba2's Mamba2 block at the smoke widths: the full form (from an
    empty history, whatever the cache holds) and three decode steps."""
    cfg = j_reg.smoke_variant("zamba2-1.2b")
    tcfg = t_reg.smoke_variant("zamba2-1.2b")
    w = _weights(j_ssm.mamba_defs(cfg), 10)
    w["A_log"] = (np.random.default_rng(11).normal(size=w["A_log"].shape)
                  * 0.5).astype(np.float32)
    jp, tp = _both(w)
    x = np.random.default_rng(12).normal(size=(B, 27, cfg.d_model)).astype(
        np.float32)
    defs = j_ssm.mamba_cache_defs(cfg, B)
    j_cache = {k: jnp.ones(d.shape) for k, d in defs.items()}
    t_cache = {k: torch.ones(d.shape) for k, d in defs.items()}
    want, j_cache = jax.jit(lambda p, x_, c: j_ssm.mamba_full(
        p, x_, cfg, cache=c))(jp, jnp.asarray(x[:, :24]), j_cache)
    got, t_cache = t_ssm.mamba_full(tp, _t(x[:, :24]), tcfg, cache=t_cache)
    assert _rel(got, want) <= OP_TOL
    for k in ("conv", "state"):
        assert _rel(t_cache[k], j_cache[k]) <= OP_TOL
    j_decode = jax.jit(lambda p, x_, c: j_ssm.mamba_decode(p, x_, cfg, c))
    for i in range(24, 27):
        want, j_cache = j_decode(jp, jnp.asarray(x[:, i:i + 1]), j_cache)
        got, t_cache = t_ssm.mamba_decode(tp, _t(x[:, i:i + 1]), tcfg,
                                          t_cache)
        assert _rel(got, want) <= OP_TOL, i
    full, _ = t_ssm.mamba_full(tp, _t(x), tcfg)
    assert _rel(got[:, 0], full[:, -1]) <= OP_TOL


def _xlstm_inputs(seed):
    cfg = j_reg.smoke_variant("xlstm-1.3b")
    x = np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)) \
        .astype(np.float32)
    return cfg, t_reg.smoke_variant("xlstm-1.3b"), x


@pytest.mark.parametrize("form", ["step", "chunkwise"])
def test_mlstm_apply_matches_jax(form):
    """The step scan, and the chunkwise form (ssm_chunk=8 at S=24) held
    against JAX's chunkwise form and against the step scan; then decode
    steps from the cache the full form leaves."""
    cfg, tcfg, x = _xlstm_inputs(13)
    if form == "chunkwise":
        cfg, tcfg = cfg.replace(ssm_chunk=8), tcfg.replace(ssm_chunk=8)
    jp, tp = _both(_weights(j_xlstm.mlstm_defs(cfg), 14))
    defs = j_xlstm.mlstm_cache_defs(cfg, B)
    j_cache = j_lm.init_cache(j_reg.smoke_variant("xlstm-1.3b"), B, S)[
        "layers"]
    j_cache = {k: v[0] for k, v in j_cache.items()}
    t_cache = {k: torch.zeros(d.shape) for k, d in defs.items()}
    t_cache["m"].fill_(-1e30)
    j_apply = jax.jit(lambda p, x_, c, decode: j_xlstm.mlstm_apply(
        p, x_, cfg, cache=c, decode=decode), static_argnums=3)
    want, j_cache = j_apply(jp, jnp.asarray(x[:, :16]), j_cache, False)
    got, t_cache = t_xlstm.mlstm_apply(tp, _t(x[:, :16]), tcfg,
                                       cache=t_cache)
    assert _rel(got, want) <= OP_TOL
    for k in ("C", "n", "m"):
        assert _rel(t_cache[k], j_cache[k]) <= OP_TOL
    for i in range(16, 19):
        want, j_cache = j_apply(jp, jnp.asarray(x[:, i:i + 1]), j_cache,
                                True)
        got, t_cache = t_xlstm.mlstm_apply(tp, _t(x[:, i:i + 1]), tcfg,
                                           cache=t_cache, decode=True)
        assert _rel(got, want) <= OP_TOL, i
    full, _ = t_xlstm.mlstm_apply(tp, _t(x), tcfg)
    assert _rel(full, j_apply(jp, jnp.asarray(x), None, False)[0]) \
        <= OP_TOL
    if form == "chunkwise":
        step, _ = t_xlstm.mlstm_apply(tp, _t(x), tcfg.replace(ssm_chunk=0))
        assert _rel(full, step) <= OP_TOL
        # the chunkwise form ran: it is not the step scan's arithmetic
        assert not torch.equal(full, step)


def test_slstm_apply_matches_jax():
    cfg, tcfg, x = _xlstm_inputs(15)
    jp, tp = _both(_weights(j_xlstm.slstm_defs(cfg), 16))
    defs = j_xlstm.slstm_cache_defs(cfg, B)
    j_cache = {k: (jnp.full(d.shape, -1e30) if k == "m"
                   else jnp.zeros(d.shape)) for k, d in defs.items()}
    t_cache = {k: (torch.full(d.shape, -1e30) if k == "m"
                   else torch.zeros(d.shape)) for k, d in defs.items()}
    j_apply = jax.jit(lambda p, x_, c, decode: j_xlstm.slstm_apply(
        p, x_, cfg, cache=c, decode=decode), static_argnums=3)
    want, j_cache = j_apply(jp, jnp.asarray(x[:, :20]), j_cache, False)
    got, t_cache = t_xlstm.slstm_apply(tp, _t(x[:, :20]), tcfg,
                                       cache=t_cache)
    assert _rel(got, want) <= OP_TOL
    for k in ("c", "n", "h", "m"):
        assert _rel(t_cache[k], j_cache[k]) <= OP_TOL
    for i in range(20, 24):
        want, j_cache = j_apply(jp, jnp.asarray(x[:, i:i + 1]), j_cache,
                                True)
        got, t_cache = t_xlstm.slstm_apply(tp, _t(x[:, i:i + 1]), tcfg,
                                           cache=t_cache, decode=True)
        assert _rel(got, want) <= OP_TOL, i
    full, _ = t_xlstm.slstm_apply(tp, _t(x), tcfg)
    assert _rel(got[:, 0], full[:, -1]) <= OP_TOL


# ---------------------------------------------------------------------------
# definitions, weights, caches
# ---------------------------------------------------------------------------

def _j_flat_defs(defs):
    leaves = jax.tree_util.tree_flatten_with_path(
        defs, is_leaf=lambda x: isinstance(x, j_common.ParamDef))[0]
    return {".".join(p.key for p in path): d for path, d in leaves}


FULL_COUNTS = {"deepseek-v2-lite-16b": 15_709_498_368,
               "mixtral-8x7b": 46_702_792_704,
               "zamba2-1.2b": 1_170_138_240, "xlstm-1.3b": 1_238_632_448,
               "llama-3.2-vision-11b": 11_536_830_464,
               "whisper-tiny": 37_203_072}


@pytest.mark.parametrize("name", NEW)
def test_param_defs_and_count_of_full_configs(name):
    """Shapes, mesh axes and counts of the full configs, nothing
    allocated: the port's model of a full config lies on the meta
    device."""
    t_cfg, j_cfg = t_reg.get_arch(name), j_reg.get_arch(name)
    t_defs = t_common.flatten(t_lm.param_defs(t_cfg))
    j_defs = _j_flat_defs(j_lm.build_model(j_cfg).param_defs())
    assert sorted(t_defs) == sorted(j_defs)
    for k, d in t_defs.items():
        assert d.shape == j_defs[k].shape, k
        assert d.spec == tuple(j_defs[k].spec), k
        assert d.init_scale == j_defs[k].init_scale, k
    count = t_common.param_count(t_lm.param_defs(t_cfg))
    assert count == j_common.param_count(
        j_lm.build_model(j_cfg).param_defs()) == FULL_COUNTS[name]
    model = t_lm.build_model(t_cfg)
    assert isinstance(model, t_whisper.EncDecModel if t_cfg.family ==
                      "audio" else t_tf.DecoderModel)
    assert all(p.device.type == "meta" for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == count


@pytest.mark.parametrize("name", NEW)
def test_cache_defs_and_init_cache_match_the_reference(name):
    """The stacked cache trees of the smoke configs leaf for leaf, and
    ``init_cache``'s values: -1e30 in the xLSTM stabilizers ``m``, zeros
    everywhere else."""
    j_cfg, t_cfg = j_reg.smoke_variant(name), t_reg.smoke_variant(name)
    want = _j_flat_defs(j_lm.build_model(j_cfg).cache_defs(B, 40))
    got = t_common.flatten(t_lm.build_model(t_cfg).cache_defs(B, 40))
    assert sorted(got) == sorted(want)
    for k, d in got.items():
        assert d.shape == want[k].shape and d.spec == tuple(want[k].spec), k
    j_init = jax.tree_util.tree_flatten_with_path(
        j_lm.init_cache(j_cfg, B, 40))[0]
    j_init = {".".join(p.key for p in path): np.asarray(v)
              for path, v in j_init}
    t_init = t_common.flatten(t_lm.init_cache(t_cfg, B, 40, device="cpu"))
    assert sorted(t_init) == sorted(j_init)
    for k, v in t_init.items():
        np.testing.assert_array_equal(v.numpy(), j_init[k])
        assert v.dtype == torch.float32
    ms = [v for k, v in t_init.items() if k.endswith(".m")]
    assert bool(ms) == (t_cfg.family == "ssm")
    assert all(bool((m == -1e30).all()) for m in ms)


def test_unstack_covers_every_stacked_subtree():
    """convert.lm_params_from_numpy unstacks ``layers``, ``dense_layers``,
    ``cross``, ``slstm``, ``enc_layers`` and ``dec_layers`` one layer a
    view; zamba's ``shared_attn`` and the VLM's ``img_proj`` stay whole."""
    seen = set()
    for name in NEW:
        _, _, params, model = _pair(name)
        tree = jax.tree.map(np.asarray, params)
        state = model.state_dict()
        for key in t_tf.STACKED:
            if key not in tree:
                continue
            seen.add(key)
            for leaf_name, leaf in t_common.flatten(tree[key]).items():
                for i in range(leaf.shape[0]):
                    np.testing.assert_array_equal(
                        state[f"{key}.{i}.{leaf_name}"].numpy(), leaf[i])
        for key in ("shared_attn", "img_proj"):
            if key in tree:
                for leaf_name, leaf in t_common.flatten({key: tree[key]}) \
                        .items():
                    np.testing.assert_array_equal(
                        state[leaf_name].numpy(), leaf)
    assert seen == set(t_tf.STACKED)


def test_build_model_draws_from_the_stacked_defs():
    """``build_model(generator=...)`` draws the reference's stacked leaves
    (fan_in = shape[-2], so a stacked vector such as ``A_log (L, H)`` has
    std 1/sqrt(L)) and unstacks them: the same tensors as ``init_params``
    on the stacked defs from the same seed."""
    cfg = t_reg.smoke_variant("zamba2-1.2b")
    defs = t_lm.param_defs(cfg)
    tree = t_common.init_params(defs, torch.Generator().manual_seed(3))
    model = t_lm.build_model(cfg, generator=torch.Generator().manual_seed(3))
    for i in range(cfg.n_layers):
        assert torch.equal(model.layers[i]["mixer"]["A_log"],
                           tree["layers"]["mixer"]["A_log"][i])
    assert torch.equal(model.shared_attn["attn"]["wq"],
                       tree["shared_attn"]["attn"]["wq"])
    a_log = t_common.init_params(
        {"a": t_tf.stack_defs(t_ssm.mamba_defs(cfg.replace(
            d_model=2048, ssm_head_dim=8)), 64)["A_log"]},
        torch.Generator().manual_seed(4))["a"]
    assert a_log.shape == (64, 512)
    assert float(a_log.std()) == pytest.approx(1 / 8, rel=0.05)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW)
def test_train_logits_and_hidden_match_jax(name):
    j_cfg, j_model, params, model = _pair(name)
    tok = _tokens(j_cfg.vocab_size)
    extra = _extra(j_cfg)
    want_h, _ = _jax_forward(j_cfg, hidden=True)(
        params, jnp.asarray(tok), None, _jx(extra))
    want = j_model.unembed(params, want_h)
    got, caches = model(torch.from_numpy(tok), mode="train", **_tx(extra))
    assert caches is None and got.dtype == torch.float32
    assert got.shape == (B, S, j_cfg.vocab_size)
    assert _rel(got, want) <= MODEL_TOL
    got_h, _ = model(torch.from_numpy(tok), return_hidden=True,
                     **_tx(extra))
    assert _rel(got_h, want_h) <= MODEL_TOL
    assert _rel(model.unembed(got_h), got) <= OP_TOL


def test_vlm_without_image_skips_the_cross_blocks():
    """Without ``image_embeds`` the cross blocks are not applied: the
    model is its self layers, as the reference's."""
    j_cfg, j_model, params, model = _pair("llama-3.2-vision-11b")
    tok = _tokens(j_cfg.vocab_size, seed=3)
    want, _ = _jax_forward(j_cfg)(params, jnp.asarray(tok), None, {})
    got, _ = model(torch.from_numpy(tok))
    assert _rel(got, want) <= MODEL_TOL
    with_img, _ = model(torch.from_numpy(tok), **_tx(_extra(j_cfg)))
    assert _rel(with_img, got) > 1e-2


@pytest.mark.parametrize("name", NEW)
def test_prefill_and_decode_match_the_forward_and_jax(name, no_drops):
    j_cfg, j_model, params, model = _pair(name)
    tok = _tokens(j_cfg.vocab_size, seed=2)
    extra = _extra(j_cfg)
    full, _ = model(torch.from_numpy(tok), **_tx(extra))
    s0 = S - 3
    j_caches = j_lm.init_cache(j_cfg, B, S)
    caches = t_lm.init_cache(model.cfg, B, S, device="cpu")
    want, j_caches = _jax_forward(j_cfg, "prefill")(
        params, jnp.asarray(tok[:, :s0]), j_caches, _jx(extra))
    got, caches = model(torch.from_numpy(tok[:, :s0]), mode="prefill",
                        caches=caches, **_tx(extra))
    assert _rel(got, want) <= MODEL_TOL
    errs = [float((got - full[:, :s0]).abs().max())]
    for i in range(s0, S):
        want, j_caches = _jax_decode(j_cfg)(
            params, j_caches, jnp.asarray(tok[:, i:i + 1]), jnp.int32(i),
            _jx(extra))
        got, caches = model(torch.from_numpy(tok[:, i:i + 1]),
                            mode="decode", caches=caches, cache_len=i,
                            **_tx(extra))
        assert _rel(got, want) <= MODEL_TOL, i
        errs.append(float((got[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < DECODE_TOL.get(name, 1e-3), errs
    j_flat = jax.tree_util.tree_flatten_with_path(j_caches)[0]
    t_flat = t_common.flatten(caches)
    for path, v in j_flat:
        k = ".".join(p.key for p in path)
        assert _rel(t_flat[k], v) <= MODEL_TOL, k


def _jax_greedy(j_model, params, prompts, gen, extra):
    """The reference's serve loop (repro/launch/serve.py) on given
    prompts."""
    cfg = j_model.cfg
    Bp, Sp = prompts.shape
    caches = j_lm.init_cache(cfg, Bp, Sp + gen)
    logits, caches = _jax_forward(cfg, "prefill")(
        params, jnp.asarray(prompts), caches, extra)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    outs = [tok]
    for i in range(Sp, Sp + gen - 1):
        logits, caches = _jax_decode(cfg)(params, caches, tok, jnp.int32(i),
                                          extra)
        tok = jnp.argmax(logits[:, 0], axis=-1)[:, None]
        outs.append(tok)
    return np.asarray(jnp.concatenate(outs, axis=1))


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "zamba2-1.2b",
                                  "whisper-tiny"])
def test_greedy_tokens_equal_jax(name):
    """``serve.generate`` at the default capacity (MoE tokens may drop in
    the prefill's one group of 32, as in the reference)."""
    j_cfg, j_model, params, model = _pair(name)
    prompts = _tokens(j_cfg.vocab_size, (2, 16), seed=4)
    extra = _extra(j_cfg)
    want = _jax_greedy(j_model, params, prompts, 8, _jx(extra))
    rec = t_serve.generate(model, torch.from_numpy(prompts), 8,
                           extra=_tx(extra), keep_logits=True)
    np.testing.assert_array_equal(np.asarray(rec["tokens"]), want)
    assert torch.equal(rec["logits"].argmax(-1), rec["seq"])


def test_whisper_positions_wrap_in_prefill_and_clamp_in_decode():
    """Prefill positions are arange(S) % max_target_positions (64 at the
    smoke size); decode reads pos_dec[cache_len], which the reference's
    gather clamps to the last row past the table.  Both packages: a
    72-token prefill, then decode steps at positions 72-74 (row 63), held
    to each other; and past the table decode and prefill disagree (in
    both)."""
    name = "whisper-tiny"
    j_cfg, j_model, params, model = _pair(name)
    assert j_cfg.max_target_positions == 64
    assert t_whisper.decode_position(model.cfg, 80) == 63
    assert t_whisper.decode_position(model.cfg, 12) == 12
    tok = _tokens(j_cfg.vocab_size, (2, 75), seed=6)
    extra = _extra(j_cfg)
    want_full, _ = _jax_forward(j_cfg)(params, jnp.asarray(tok), None,
                                       _jx(extra))
    got_full, _ = model(torch.from_numpy(tok), **_tx(extra))
    assert _rel(got_full, want_full) <= MODEL_TOL
    j_caches = j_lm.init_cache(j_cfg, 2, 75)
    caches = t_lm.init_cache(model.cfg, 2, 75, device="cpu")
    _, j_caches = _jax_forward(j_cfg, "prefill")(
        params, jnp.asarray(tok[:, :72]), j_caches, _jx(extra))
    _, caches = model(torch.from_numpy(tok[:, :72]), mode="prefill",
                      caches=caches, **_tx(extra))
    for i in range(72, 75):
        want, j_caches = _jax_decode(j_cfg)(
            params, j_caches, jnp.asarray(tok[:, i:i + 1]), jnp.int32(i),
            _jx(extra))
        got, caches = model(torch.from_numpy(tok[:, i:i + 1]),
                            mode="decode", caches=caches, cache_len=i,
                            **_tx(extra))
        assert _rel(got, want) <= MODEL_TOL, i
        # the prefill read row i % 64, the decode row 63: they part
        assert _rel(want[:, 0], want_full[:, i]) > 1e-2
        assert _rel(got[:, 0], got_full[:, i]) > 1e-2


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_serve_cli_of_the_modality_families(arch):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--batch", "2", "--prompt-len", "8", "--gen", "4",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "prefill 8 tokens x2" in out.stdout
    assert "decoded 4 tokens x2" in out.stdout and "sample:" in out.stdout


def test_modality_inputs_follow_the_config():
    gen = torch.Generator().manual_seed(2)
    vlm = t_serve.modality_inputs(t_reg.smoke_variant(
        "llama-3.2-vision-11b"), 3, gen)
    assert vlm["image_embeds"].shape == (3, 16, 64)
    audio = t_serve.modality_inputs(t_reg.smoke_variant("whisper-tiny"), 1,
                                    gen)
    assert audio["audio_embeds"].shape == (1, 32, 64)
    assert t_serve.modality_inputs(t_reg.smoke_variant("zamba2-1.2b"), 1,
                                   gen) == {}


def test_full_width_slstm_overflows_in_both_packages():
    """xlstm-1.3b's sLSTM at full width (d 2048, 4 heads of 512) under the
    reference's init: ``w_gates (d, 4, H, hd)`` draws std 1/sqrt(H), so
    the gate inputs of unit-scale inputs have a std near 22.7 and stray
    more than 88.7 (float32 exp's range) from their head mean; exp
    overflows and c / n turns NaN.  Both packages give NaN at the same
    positions, and agree where finite (ROADMAP Queue 3 item 13)."""
    cfg = j_reg.get_arch("xlstm-1.3b")
    params = jax.jit(lambda k: j_common.init_params(
        j_xlstm.slstm_defs(cfg), k))(jax.random.PRNGKey(0))
    x = np.random.default_rng(0).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)
    want, _ = jax.jit(lambda p, x_: j_xlstm.slstm_apply(p, x_, cfg))(
        params, jnp.asarray(x))
    want = np.asarray(want)
    got, _ = t_xlstm.slstm_apply(
        {k: _t(v) for k, v in params.items()}, _t(x),
        t_reg.get_arch("xlstm-1.3b"))
    got = got.numpy()
    # the mechanism: the input gates' pre-activations (the recurrent part
    # is 0 at the first step) stray past exp's range from their head mean
    H = cfg.n_heads
    i_pre = (x @ np.asarray(params["w_gates"]).reshape(cfg.d_model, -1)) \
        .reshape(2, 16, 4, H, cfg.d_model // H)[:, :, 1]
    assert 20 < i_pre.std() < 25
    assert (i_pre - i_pre.mean(-1, keepdims=True)).max() > 88.8
    bad_j, bad_t = ~np.isfinite(want).all(-1), ~np.isfinite(got).all(-1)
    assert bad_j.any() and bad_j[:, 0].sum() == 0
    np.testing.assert_array_equal(bad_t, bad_j)
    ok = ~bad_j
    assert _rel(got[ok], want[ok]) <= OP_TOL
    # a tenth of the input keeps the gates in range
    small, _ = t_xlstm.slstm_apply(
        {k: _t(v) for k, v in params.items()}, _t(x * 0.1),
        t_reg.get_arch("xlstm-1.3b"))
    assert bool(torch.isfinite(small).all())
