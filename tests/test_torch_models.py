"""The port's LM template (``repro_torch.models``, ``launch/serve.py``)
against the JAX package's (``repro.models``, ``repro.launch.serve``) on the
CPU, at the smoke configs (a few layers, narrow widths).

The same numpy inputs and the JAX package's own initial weights (carried
across by ``convert.lm_params_from_numpy``) go to both packages.

Tolerances, each relative to the largest |value| of the reference's output:
- norms, rope, SwiGLU and attention on N(0, 1) inputs: 1e-5 (float32 with
  the sums in another order);
- a model's logits and hidden states: 5e-4.  The reference's init draws
  ``wq`` with std 1/sqrt(H) (fan_in is the second-to-last dim), so at the
  smoke widths the attention logits have a std of tens and the softmax is
  sharp, so each layer amplifies the float32 roundings of the last.  The
  reference's own two attention forms (``attn_impl`` flash and naive)
  part by a few 1e-5 of the largest logit on these models; a wrong mask,
  position, rotation or head map moves the logits by a large share of
  the largest;
- prefill plus decode against the full forward within the port: 1e-3,
  the reference's own bar (tests/test_models.py);
- greedy tokens: equal.
"""
import dataclasses
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
from repro.models import common as j_common
from repro.models import lm as j_lm
from repro.models import mlp as j_mlp
from repro_torch import convert
from repro_torch.configs import registry as t_reg
from repro_torch.models import common as t_common
from repro_torch.models import lm as t_lm
from repro_torch.models import mlp as t_mlp
from repro_torch.models import transformer as t_tf
from repro_torch.launch import serve as t_serve

REPO = pathlib.Path(__file__).resolve().parents[1]
DENSE = ["gemma3-12b", "mistral-large-123b", "phi4-mini-3.8b",
         "qwen2.5-32b"]
B, S = 2, 24
OP_TOL = 1e-5
MODEL_TOL = 5e-4
DECODE_TOL = 1e-3


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


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


@functools.lru_cache(maxsize=None)
def _pair(name: str):
    """(JAX config, JAX model, JAX params, port model) of a smoke config,
    the port over the JAX package's initial weights."""
    j_cfg = j_reg.smoke_variant(name)
    t_cfg = t_reg.smoke_variant(name)
    j_model = j_lm.build_model(j_cfg)
    defs = j_model.param_defs()
    params = jax.jit(lambda key: j_common.init_params(defs, key))(
        jax.random.PRNGKey(0))
    if j_cfg.qkv_bias:       # the biases start at 0: give them values
        rng = np.random.default_rng(5)
        attn = dict(params["layers"]["attn"])
        for k in ("bq", "bk", "bv"):
            attn[k] = jnp.asarray(rng.normal(size=attn[k].shape) * 0.1,
                                  jnp.float32)
        params = {**params, "layers": {**params["layers"], "attn": attn}}
    tree = jax.tree.map(np.asarray, params)
    state = convert.lm_params_from_numpy(t_cfg, tree, device="cpu")
    return j_cfg, j_model, params, t_lm.build_model(t_cfg, state=state)


@functools.lru_cache(maxsize=None)
def _jax_decode(j_cfg):
    """The reference's decode step, jitted as its serve loop jits it (one
    compile for every position)."""
    j_model = j_lm.build_model(j_cfg)
    return jax.jit(lambda p, c, t, i: j_model.forward(
        p, t, mode="decode", caches=c, cache_len=i))


def _tokens(vocab: int, shape=(B, S), seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

def test_rms_norm_rope_swiglu_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 24, 64)) * 3).astype(np.float32)
    sc = (rng.normal(size=64) * 0.1).astype(np.float32)
    assert _rel(t_common.rms_norm(_t(x), _t(sc), 1e-6),
                j_common.rms_norm(jnp.asarray(x), jnp.asarray(sc))) <= OP_TOL
    xb = x.astype(jnp.bfloat16)
    got = t_common.rms_norm(_t(x, torch.bfloat16), _t(sc))
    want = j_common.rms_norm(jnp.asarray(xb), jnp.asarray(sc))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    q = rng.normal(size=(2, 24, 4, 16)).astype(np.float32)
    for theta, pos in ((10_000.0, np.arange(24)[None]),
                       (1_000_000.0, np.arange(1500, 1524)[None]),
                       (10_000.0, np.full((2, 1), 1535))):
        qq = q[:, :pos.shape[1]]
        assert _rel(t_common.rope(_t(qq), torch.from_numpy(pos), theta),
                    j_common.rope(jnp.asarray(qq), jnp.asarray(pos),
                                  theta)) <= OP_TOL
    w = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (64, 96)), ("w_up", (64, 96)),
                      ("w_down", (96, 64)))}
    assert _rel(t_mlp.swiglu_apply({k: _t(v) for k, v in w.items()}, _t(x)),
                j_mlp.swiglu_apply({k: jnp.asarray(v) for k, v in w.items()},
                                   jnp.asarray(x))) <= OP_TOL
    wg = {"w_in": w["w_gate"], "b_in": (rng.normal(size=96) * 0.1)
          .astype(np.float32), "w_out": w["w_down"],
          "b_out": (rng.normal(size=64) * 0.1).astype(np.float32)}
    assert _rel(t_mlp.gelu_apply({k: _t(v) for k, v in wg.items()}, _t(x)),
                j_mlp.gelu_apply({k: jnp.asarray(v) for k, v in wg.items()},
                                 jnp.asarray(x))) <= OP_TOL


ATTN_CASES = {
    "causal": dict(),
    "int_window": dict(window=8),
    "per_layer_window": dict(window="layer"),
    "softcap": dict(softcap=20.0),
    "q_offset": dict(q_offset=5, sq=20),
    "not_causal": dict(causal=False),
    "mha": dict(hkv=4),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_attention_matches_jax(case, impl):
    """37 keys in chunks of 16 (the last padded), GQA rep 2 unless "mha";
    a per-layer window is an int here and a traced int32 in the
    reference's scan."""
    kw = dict(ATTN_CASES[case])
    hkv = kw.pop("hkv", 2)
    sq = kw.pop("sq", 37)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 37, hkv, 16)).astype(np.float32)
    v = rng.normal(size=(2, 37, hkv, 16)).astype(np.float32)
    j_kw = dict(kw)
    if kw.get("window") == "layer":
        kw["window"], j_kw["window"] = 12, jnp.int32(12)
    got = t_common.chunked_attention(_t(q), _t(k), _t(v), chunk=16,
                                     impl=impl, **kw)
    want = j_common.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), chunk=16, impl=impl,
                                      **j_kw)
    assert got.shape == tuple(want.shape)
    assert _rel(got, want) <= OP_TOL


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("length", ["int", "tensor"])
def test_decode_attention_matches_jax(window, length):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    kc = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    n = 29 if length == "int" else torch.tensor(29)
    got = t_common.decode_attention(_t(q), _t(kc), _t(vc), n, window=window)
    want = j_common.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                     jnp.asarray(vc), jnp.int32(29),
                                     window=window)
    assert _rel(got, want) <= OP_TOL


# ---------------------------------------------------------------------------
# definitions, weights, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DENSE)
def test_param_defs_and_count_of_full_configs(name):
    """Shapes, mesh axes and counts of the full configs, nothing
    allocated: the port's model of a full config lies on the meta
    device."""
    t_cfg, j_cfg = t_reg.get_arch(name), j_reg.get_arch(name)
    t_defs = t_common.flatten(t_tf.param_defs(t_cfg))
    j_defs = jax.tree_util.tree_flatten_with_path(
        j_lm.build_model(j_cfg).param_defs(),
        is_leaf=lambda x: isinstance(x, j_common.ParamDef))[0]
    j_defs = {".".join(p.key for p in path): d for path, d in j_defs}
    assert sorted(t_defs) == sorted(j_defs)
    for k, d in t_defs.items():
        assert d.shape == j_defs[k].shape, k
        assert d.spec == tuple(j_defs[k].spec), k
        assert d.init_scale == j_defs[k].init_scale, k
    count = t_common.param_count(t_tf.param_defs(t_cfg))
    assert count == j_common.param_count(
        j_lm.build_model(j_cfg).param_defs())
    model = t_lm.build_model(t_cfg)
    assert all(p.device.type == "meta" for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == count
    if name == "gemma3-12b":
        assert count == 11_765_395_200


def test_cache_defs_and_flags_match_the_reference():
    cfg = t_reg.get_arch("gemma3-12b")
    j_model = j_lm.build_model(j_reg.get_arch("gemma3-12b"))
    model = t_lm.build_model(cfg)
    t_c = model.cache_defs(2, 1568)["layers"]
    j_c = j_model.cache_defs(2, 1568)["layers"]
    for k in ("k", "v"):
        assert t_c[k].shape == j_c[k].shape == (48, 2, 1568, 8, 256)
        assert t_c[k].spec == tuple(j_c[k].spec)
    for t, j in zip(model._gemma_flags(), j_model._gemma_flags()):
        np.testing.assert_array_equal(t, np.asarray(j))
    assert model._layer_flags()[5] == (2**30, 1_000_000.0)
    assert model._layer_flags()[0] == (1024, 10_000.0)


def test_init_params_follows_the_reference_rule():
    """std = init_scale / sqrt(shape[-2]) (wq (d, H, hd): 1/sqrt(H)), norms
    and biases exactly 0, the same draw from the same seed."""
    cfg = t_reg.smoke_variant("qwen2.5-32b").replace(d_model=192,
                                                     n_layers=2)
    defs = t_tf.param_defs(cfg)
    tree = t_common.init_params(defs, torch.Generator().manual_seed(3))
    again = t_common.init_params(defs, torch.Generator().manual_seed(3))
    for (k, a), b in zip(t_common.flatten(tree).items(),
                         t_common.flatten(again).values()):
        assert torch.equal(a, b) and a.dtype == torch.float32, k
    lay = tree["layers"]
    assert float(lay["attn"]["wq"].std()) == pytest.approx(
        1 / np.sqrt(cfg.n_heads), rel=0.05)
    assert float(lay["ffn"]["w_down"].std()) == pytest.approx(
        1 / np.sqrt(cfg.d_ff), rel=0.05)
    assert float(tree["embed"].std()) == pytest.approx(
        1 / np.sqrt(cfg.vocab_size), rel=0.05)
    for z in (tree["final_norm"], lay["ln1"], lay["ln2"],
              lay["attn"]["bq"], lay["attn"]["bv"]):
        assert not z.any()
    bf = t_common.init_params(defs, torch.Generator().manual_seed(3),
                              torch.bfloat16)
    assert bf["embed"].dtype == torch.bfloat16


def test_lm_params_from_numpy_checks_names_and_shapes():
    j_cfg, _, params, _ = _pair("phi4-mini-3.8b")
    cfg = t_reg.smoke_variant("phi4-mini-3.8b")
    tree = jax.tree.map(np.asarray, params)
    state = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    assert state["layers.2.attn.wq"].shape == (96, 6, 16)
    np.testing.assert_array_equal(state["layers.2.attn.wq"].numpy(),
                                  tree["layers"]["attn"]["wq"][2])
    bad = {**tree, "embed": tree["embed"][:, :-1]}
    with pytest.raises(ValueError, match="embed"):
        convert.lm_params_from_numpy(cfg, bad, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="final_norm"):
        convert.lm_params_from_numpy(cfg, missing, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        t_lm.build_model(cfg.replace(n_layers=2), state=state)


def test_unknown_family_raises():
    """An unknown family raises ``ValueError``, as the reference's
    ``DecoderModel.param_defs`` does (every family of the registry is
    ported; tests/test_torch_families.py holds the other five)."""
    cfg = t_reg.smoke_variant("gemma3-12b").replace(family="rnn")
    for call in (lambda: t_lm.build_model(cfg),
                 lambda: t_tf.DecoderModel(cfg),
                 lambda: t_tf.param_defs(cfg),
                 lambda: t_lm.init_cache(cfg, 1, 8, device="cpu")):
        with pytest.raises(ValueError, match="family rnn"):
            call()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DENSE)
def test_train_logits_and_hidden_match_jax(name):
    j_cfg, j_model, params, model = _pair(name)
    tok = _tokens(j_cfg.vocab_size)
    want_h, _ = j_model.forward(params, jnp.asarray(tok), mode="train",
                                return_hidden=True)
    want = j_model.unembed(params, want_h)   # what forward's logits are
    got, caches = model(torch.from_numpy(tok), mode="train")
    assert caches is None and got.dtype == torch.float32
    assert got.shape == (B, S, j_cfg.vocab_size)
    assert _rel(got, want) <= MODEL_TOL
    got_h, _ = model(torch.from_numpy(tok), mode="train",
                     return_hidden=True)
    assert _rel(got_h, want_h) <= MODEL_TOL
    assert _rel(model.unembed(got_h), got) <= OP_TOL


def _jax_unrolled(j_model, params, tokens):
    """The reference's forward with its own embedding, layer, norm and
    unembedding functions, the layers in a Python loop instead of
    ``lax.scan`` (whose carry must keep one dtype)."""
    cfg = j_model.cfg
    h = params["embed"].astype(jnp.bfloat16)[tokens]
    h = h * jnp.asarray(np.sqrt(cfg.d_model), h.dtype)
    _, win, theta = j_model._gemma_flags()
    for i in range(cfg.n_layers):
        lp = jax.tree.map(lambda a: a[i], params["layers"])
        h, _ = j_model._attn_layer_apply(lp, h, cfg, "train", None, None,
                                         win[i], theta[i], False)
    h = j_common.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return j_model.unembed(params, h)


def test_bf16_config_with_f32_weights_matches_the_reference_layers():
    """gemma3 smoke with ``dtype="bfloat16"`` (the full config's dtype) and
    float32 weights: the embedding (and its sqrt(d) scale) in bf16, the
    first layer's norm in bf16, and float32 from the first residual add
    on (bf16 + f32 promotes), as the reference's layer functions give."""
    j_cfg, j_model, params, _ = _pair("gemma3-12b")
    cfg = t_reg.smoke_variant("gemma3-12b").replace(dtype="bfloat16")
    j_model16 = j_lm.build_model(j_cfg.replace(dtype="bfloat16"))
    model = t_lm.build_model(cfg, state=convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu"))
    tok = _tokens(j_cfg.vocab_size, seed=1)
    want = jax.jit(lambda p, t: _jax_unrolled(j_model16, p, t))(
        params, jnp.asarray(tok))
    got, _ = model(torch.from_numpy(tok))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= MODEL_TOL
    f32, _ = _pair("gemma3-12b")[3](torch.from_numpy(tok))
    assert _rel(got, f32) > 1e-4      # the bf16 embedding does show


def test_reference_scan_refuses_a_bf16_config_with_f32_weights():
    """Why the test above unrolls the reference: its scanned forward
    raises when the residual turns float32 inside the scan (ROADMAP Queue
    3 item 9)."""
    j_cfg, _, params, _ = _pair("gemma3-12b")
    j_model16 = j_lm.build_model(j_cfg.replace(dtype="bfloat16"))
    with pytest.raises(TypeError, match="carry"):
        j_model16.forward(params, jnp.asarray(_tokens(j_cfg.vocab_size)))


@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_match_the_forward_and_jax(name):
    j_cfg, j_model, params, model = _pair(name)
    tok = _tokens(j_cfg.vocab_size, seed=2)
    full, _ = model(torch.from_numpy(tok))
    s0 = S - 3
    j_caches = j_lm.init_cache(j_cfg, B, S)
    caches = t_lm.init_cache(model.cfg, B, S, device="cpu")
    want, j_caches = j_model.forward(params, jnp.asarray(tok[:, :s0]),
                                     mode="prefill", caches=j_caches)
    got, caches = model(torch.from_numpy(tok[:, :s0]), mode="prefill",
                        caches=caches)
    assert _rel(got, want) <= MODEL_TOL
    errs = [float((got - full[:, :s0]).abs().max())]
    for i in range(s0, S):
        want, j_caches = _jax_decode(j_cfg)(
            params, j_caches, jnp.asarray(tok[:, i:i + 1]), jnp.int32(i))
        got, caches = model(torch.from_numpy(tok[:, i:i + 1]),
                            mode="decode", caches=caches, cache_len=i)
        assert _rel(got, want) <= MODEL_TOL
        errs.append(float((got[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < DECODE_TOL, errs
    for k in ("k", "v"):
        assert _rel(caches["layers"][k], j_caches["layers"][k]) <= MODEL_TOL


def test_prefill_step_unembeds_the_last_position():
    j_cfg, _, _, model = _pair("gemma3-12b")
    tok = torch.from_numpy(_tokens(j_cfg.vocab_size, seed=3))
    full, _ = model(tok, mode="prefill",
                    caches=t_lm.init_cache(model.cfg, B, S, device="cpu"))
    step = t_lm.make_prefill_step(model)
    last, caches = step(t_lm.init_cache(model.cfg, B, S, device="cpu"),
                        {"tokens": tok})
    assert last.shape == (B, j_cfg.vocab_size)
    assert _rel(last, full[:, -1]) <= OP_TOL
    dec = t_lm.make_decode_step(model)
    nxt, _ = dec(caches, last.argmax(-1)[:, None], S - 1)
    assert nxt.shape == (B, j_cfg.vocab_size)


def _jax_greedy(j_model, params, prompts, gen):
    """The reference's serve loop (repro/launch/serve.py) on given
    prompts."""
    cfg = j_model.cfg
    Bp, Sp = prompts.shape
    caches = j_lm.init_cache(cfg, Bp, Sp + gen)
    logits, caches = j_model.forward(params, jnp.asarray(prompts),
                                     mode="prefill", caches=caches)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    outs = [tok]
    for i in range(Sp, Sp + gen - 1):
        logits, caches = _jax_decode(cfg)(params, caches, tok,
                                              jnp.int32(i))
        tok = jnp.argmax(logits[:, 0], axis=-1)[:, None]
        outs.append(tok)
    return np.asarray(jnp.concatenate(outs, axis=1))


@pytest.mark.parametrize("name", ["gemma3-12b", "qwen2.5-32b"])
def test_greedy_tokens_equal_jax(name):
    j_cfg, j_model, params, model = _pair(name)
    prompts = _tokens(j_cfg.vocab_size, (2, 16), seed=4)
    want = _jax_greedy(j_model, params, prompts, 8)
    rec = t_serve.generate(model, torch.from_numpy(prompts), 8,
                           keep_logits=True)
    np.testing.assert_array_equal(np.asarray(rec["tokens"]), want)
    assert rec["logits"].shape == (2, 8, j_cfg.vocab_size)
    assert torch.equal(rec["logits"].argmax(-1), rec["seq"])
    assert rec["decode_steps"] == 7 and rec["prompt_len"] == 16


def test_serve_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-12b", "--smoke", "--batch", "2", "--prompt-len", "8",
         "--gen", "4", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "prefill 8 tokens x2" in out.stdout
    assert "decoded 4 tokens x2" in out.stdout and "sample:" in out.stdout


def test_serve_cli_without_device_means_the_card():
    argv = ["--arch", "gemma3-12b", "--smoke", "--batch", "1",
            "--prompt-len", "4", "--gen", "2"]
    if torch.cuda.is_available():
        assert t_serve.main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_serve.main(argv)


def test_generate_record():
    _, _, _, model = _pair("phi4-mini-3.8b")
    rec = t_serve.generate(model, torch.zeros((1, 5), dtype=torch.int64), 1)
    assert rec["decode_steps"] == 0 and rec["decode_tok_per_s"] is None
    assert len(rec["tokens"][0]) == 1 and rec["prefill_s"] > 0
    with pytest.raises(ValueError, match="gen"):
        t_serve.generate(model, torch.zeros((1, 5), dtype=torch.int64), 0)


def test_dataclass_configs_build_the_same_model():
    """A config replaced field by field (the smoke route) is what the model
    reads: ``attn_impl="naive"`` runs the materialized-logits form."""
    j_cfg, j_model, params, model = _pair("phi4-mini-3.8b")
    naive = t_lm.build_model(
        dataclasses.replace(model.cfg, attn_impl="naive"),
        state=dict(model.state_dict()))
    tok = torch.from_numpy(_tokens(j_cfg.vocab_size, seed=5))
    assert _rel(naive(tok)[0], model(tok)[0]) <= MODEL_TOL
