"""The GLM head probe (``repro_torch.core.head_probe``) against the JAX
package's (``repro.core.head_probe``) on the CPU: feature extraction from
the gemma3 smoke backbone over the JAX package's own initial weights, the
binary and one-vs-rest probes, ``predict_proba``, and the pipeline of
``examples/lm_head_probe.py`` at its own (smoke) size.

Tolerances: probe beta within 1e-5 with the same n_iter and alphas (the
reference's bar for a fit on the same design); probabilities 1e-6.
Features are the mean (or last) of the backbone's final hidden states,
held to 5e-4 of the largest |feature|: the backbone's own bar in
tests/test_torch_models.py (float32 through attention whose logits have a
std of tens under the reference's init; the reference's flash and naive
attention part by a few 1e-5 there).  The example's features are held to
that bar as well, and the probe fitted on the very same features in both
packages to the fit's 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_reg
from repro.core import head_probe as j_hp
from repro.core.dglmnet import DGLMNETConfig as JConfig
from repro.data import synthetic as j_synth
from repro.models import common as j_common
from repro.models import lm as j_lm
from repro_torch import convert
from repro_torch.configs import registry as t_reg
from repro_torch.core import head_probe as t_hp
from repro_torch.core.dglmnet import DGLMNETConfig as TConfig
from repro_torch.models import lm as t_lm

FEATURE_TOL = 5e-4
BETA_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _backbones():
    """(JAX model, JAX params, port model) of the gemma3 smoke config, as
    examples/lm_head_probe.py builds it (PRNGKey(0))."""
    j_model = j_lm.build_model(j_reg.smoke_variant("gemma3-12b"))
    defs = j_model.param_defs()
    params = jax.jit(lambda k: j_common.init_params(defs, k))(
        jax.random.PRNGKey(0))
    cfg = t_reg.smoke_variant("gemma3-12b")
    state = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return j_model, params, t_lm.build_model(cfg, state=state)


def _j_hidden(j_model):
    return jax.jit(lambda p, t: j_model.forward(
        p, t, mode="train", return_hidden=True)[0])


def _t_hidden(model, tokens):
    return model(tokens, mode="train", return_hidden=True)[0]


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / np.max(np.abs(want)))


def _task(n: int, S: int = 32, vocab: int = 256, seed: int = 0):
    """examples/lm_head_probe.py's class-conditional unigram task: the
    positive class draws its tokens from the lower half of the vocabulary,
    the negative class from the upper half."""
    rng = np.random.default_rng(seed)
    labels = rng.choice([-1.0, 1.0], n)
    tokens = np.where(labels[:, None] > 0,
                      rng.integers(0, vocab // 2, (n, S)),
                      rng.integers(vocab // 2, vocab, (n, S))).astype(np.int32)
    return labels, tokens


@pytest.mark.parametrize("pool", ["mean", "last"])
def test_extract_features_matches_jax(pool):
    j_model, params, model = _backbones()
    _, tokens = _task(48, S=16, seed=1)
    batches = np.split(tokens, 3)
    want = j_hp.extract_features(_j_hidden(j_model), params,
                                 [jnp.asarray(b) for b in batches], pool=pool)
    got = t_hp.extract_features(_t_hidden, model,
                                [torch.from_numpy(b) for b in batches],
                                pool=pool)
    assert torch.is_tensor(got) and got.shape == (48, 64)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert _rel(got, want) <= FEATURE_TOL


def test_extract_features_refuses_an_unknown_pool():
    _, _, model = _backbones()
    with pytest.raises(ValueError, match="unknown pool 'max'"):
        t_hp.extract_features(_t_hidden, model,
                              [torch.zeros((1, 4), dtype=torch.int64)],
                              pool="max")


def test_fit_probe_matches_jax():
    """tests/test_dglmnet.py::test_head_probe_single_device on the port,
    beside the reference's fit on the same data."""
    ds = j_synth.make_dense(n=600, p=64, seed=9)
    kw = dict(lam1=0.2, lam2=0.2, tile_size=16, max_outer=40)
    want = j_hp.fit_probe(ds.train.X, ds.train.y, JConfig(**kw))
    X = torch.from_numpy(np.asarray(ds.train.X, np.float32))
    got = t_hp.fit_probe(X, ds.train.y, TConfig(**kw), device="cpu")
    assert got.n_iter == want.n_iter
    assert got.history["alpha"] == want.history["alpha"]
    np.testing.assert_allclose(got.beta, want.beta, rtol=0, atol=BETA_TOL)
    p = t_hp.predict_proba(ds.test.X, got.beta, device="cpu").numpy()
    acc = ((p > 0.5) == (ds.test.y > 0)).mean()
    assert acc > 0.8, acc
    np.testing.assert_allclose(
        p, np.asarray(j_hp.predict_proba(ds.test.X, want.beta)), rtol=0,
        atol=1e-6)
    # the session and fit keywords split as the reference's do
    again = t_hp.fit_probe(ds.train.X, ds.train.y, TConfig(**kw),
                           device="cpu", row_block=128, seed=3,
                           max_outer=5)
    assert again.n_iter == 5


def test_fit_probe_multiclass_and_predict_proba_match_jax():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(300, 40)).astype(np.float32)
    W = rng.normal(size=(3, 40)).astype(np.float32)
    labels = np.argmax(X @ W.T + rng.normal(size=(300, 3)), axis=1)
    # 10 supersteps: under the float32 plateau, where class 2's fits reach
    # f = 123.39574 at superstep 14 and the packages' Armijo tests tie
    # there (alpha 0.1 against 1; ROADMAP Queue 3 item 4)
    kw = dict(lam1=0.5, lam2=0.1, tile_size=16, max_outer=10)
    want = j_hp.fit_probe_multiclass(X, labels, 3, JConfig(**kw))
    got = t_hp.fit_probe_multiclass(torch.from_numpy(X), labels, 3,
                                    TConfig(**kw), device="cpu")
    assert got.shape == want.shape == (3, 40)
    np.testing.assert_allclose(got, want, rtol=0, atol=BETA_TOL)
    for c in range(3):
        p = t_hp.predict_proba(torch.from_numpy(X), got[c])
        assert p.device.type == "cpu"
        np.testing.assert_allclose(
            p.numpy(), np.asarray(j_hp.predict_proba(X, want[c])), rtol=0,
            atol=1e-6)


def test_the_example_pipeline_at_smoke_size():
    """examples/lm_head_probe.py in both packages: n = 512 sequences of 32
    tokens, features in 8 batches, the probe on the first 400."""
    j_model, params, model = _backbones()
    labels, tokens = _task(512)
    j_fn = _j_hidden(j_model)
    want = j_hp.extract_features(j_fn, params,
                                 [jnp.asarray(t) for t in np.split(tokens, 8)])
    got = t_hp.extract_features(_t_hidden, model,
                                [torch.from_numpy(t)
                                 for t in np.split(tokens, 8)])
    assert got.shape == (512, 64)
    assert _rel(got, want) <= FEATURE_TOL
    n_tr = 400
    kw = dict(lam1=0.05, lam2=0.05, tile_size=16, max_outer=40)
    j_res = j_hp.fit_probe(want[:n_tr], labels[:n_tr], JConfig(**kw))
    t_res = t_hp.fit_probe(torch.from_numpy(want[:n_tr]), labels[:n_tr],
                           TConfig(**kw), device="cpu")
    assert t_res.n_iter == j_res.n_iter
    np.testing.assert_allclose(t_res.beta, j_res.beta, rtol=0,
                               atol=BETA_TOL)
    # the port end to end: its own features, its own fit
    own = t_hp.fit_probe(got[:n_tr], labels[:n_tr], TConfig(**kw),
                         device="cpu")
    p = t_hp.predict_proba(got[n_tr:], own.beta).numpy()
    acc = ((p > 0.5) == (labels[n_tr:] > 0)).mean()
    assert np.isfinite(own.beta).all() and acc > 0.5, acc


def test_fused_jacobi_probe_on_deepseek_features_matches_jax():
    """The probe on a smoke deepseek's (MoE with MLA) mean-pooled features,
    by the fused Jacobi superstep (the plain versions of the
    stats_gram_solve and margin_ls kernels here): the features held to
    the backbone's bar, then the fit on the very same (the reference's)
    features in both packages, beta within 1e-5 and the same n_iter and
    alphas."""
    name = "deepseek-v2-lite-16b"
    j_model = j_lm.build_model(j_reg.smoke_variant(name))
    defs = j_model.param_defs()
    params = jax.jit(lambda k: j_common.init_params(defs, k))(
        jax.random.PRNGKey(0))
    cfg = t_reg.smoke_variant(name)
    model = t_lm.build_model(cfg, state=convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu"))
    labels, tokens = _task(256, S=16, seed=3)
    batches = np.split(tokens, 4)          # 64 x 16 tokens: 4 MoE groups
    want = np.asarray(j_hp.extract_features(
        _j_hidden(j_model), params, [jnp.asarray(b) for b in batches]))
    got = t_hp.extract_features(_t_hidden, model,
                                [torch.from_numpy(b) for b in batches])
    assert got.shape == (256, cfg.d_model)
    assert _rel(got, want) <= FEATURE_TOL
    kw = dict(lam1=0.05, lam2=0.05, tile_size=16, coupling="jacobi",
              fuse_superstep=True)
    y = labels.astype(np.float32)
    r_j = j_hp.fit_probe(want, y, JConfig(**kw))
    r_t = t_hp.fit_probe(torch.from_numpy(want), y, TConfig(**kw),
                         device="cpu")
    assert r_t.n_iter == r_j.n_iter
    assert r_t.history["alpha"] == r_j.history["alpha"]
    np.testing.assert_allclose(r_t.beta, r_j.beta, rtol=0, atol=BETA_TOL)
    assert np.abs(r_t.beta).max() > 0
