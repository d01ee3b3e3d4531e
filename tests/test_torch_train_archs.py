"""One train step of the port's LM template (``repro_torch.models.lm.
make_train_step``: the loss, the gradients through every layer kind and
the flash backward, AdamW) against the JAX package's ``jax.jit(
make_train_step(...))`` on the CPU: here the dense family (phi4-mini,
gemma3, qwen2.5, mistral-large) at the smoke configs, ``microbatches=2``
against the reference's scan, and remat on against off in every family;
``tests/test_torch_train_moe.py`` and ``test_torch_train_families.py``
hold the other six architectures.

The same numpy weights go to both packages (``convert.lm_params_from_
numpy``): N(0, 0.02^2) matrices and N(0, 0.1^2) vectors.  The reference's
own init (std 1/sqrt(fan_in), with fan_in the head count for the
attention projections) gives attention logits a std of tens at smoke
width, where float32 roundings grow layer by layer: there the port's flash
and naive attention part by up to 5e-4 of a gradient's largest entry, and
two float32 runs drift apart over a few steps
(``test_reference_init_step`` holds that init to its own bars).

Tolerances, each stated where it is used:
- loss 1e-5 relative; grad norm 1e-4 relative; every gradient leaf 1e-4
  of its largest |entry| (the sums run in another order);
- updated parameters within 1e-7 absolute, except where the reference's
  gradient lies within the gradient bar of 0 (1e-4 of its leaf's largest
  entry), or its clipped value within 1000 eps of 0, and is not exactly 0
  in both packages: AdamW's first step is g s / (|g s| + eps), near
  sign(g) * lr, so there two correct gradients move the entry by up to
  2 lr apart.  Those entries are counted per leaf (``EXCLUDED``); the
  gradients themselves are held everywhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_reg
from repro.models import common as j_common
from repro.models import lm as j_lm
from repro.models import moe as j_moe
from repro.models.common import init_params as j_init_params
from repro.optim import adamw as j_adamw
from repro_torch import convert
from repro_torch.configs import registry as t_reg
from repro_torch.models import common as t_common
from repro_torch.models import lm as t_lm
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.optim import adamw as t_adamw

DENSE = ["gemma3-12b", "mistral-large-123b", "phi4-mini-3.8b",
         "qwen2.5-32b"]
B, S = 2, 24
LOSS_TOL = 1e-5
GNORM_TOL = 1e-4
GRAD_TOL = 1e-4
PARAM_ATOL = 1e-7
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=8)


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


def weights(defs, seed: int = 0) -> dict:
    """numpy weights for a JAX ParamDef tree: N(0, 0.02^2) for matrices,
    N(0, 0.1^2) for vectors."""
    rng = np.random.default_rng(seed)

    def mk(d):
        std = 0.1 if len(d.shape) < 2 else 0.02
        return (rng.normal(size=d.shape) * std).astype(np.float32)
    return jax.tree.map(mk, defs,
                        is_leaf=lambda x: isinstance(x, j_common.ParamDef))


def batch_for(cfg, seed: int = 0, b: int = B) -> dict:
    """A numpy batch of ``cfg``'s smoke model, with its modality input."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size,
                                   (b, S)).astype(np.int32),
           "loss_mask": (rng.random((b, S)) < 0.9).astype(np.float32)}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.normal(
            size=(b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["audio_embeds"] = rng.normal(
            size=(b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return out


def jax_step(name, np_params, batch, microbatches=1, opt=OPT):
    """The reference: (loss, grads as a flat {name: array}, metrics,
    updated params flat) of one jitted ``make_train_step`` step; the
    gradients from ``jax.value_and_grad`` of its loss."""
    cfg = j_reg.smoke_variant(name)
    step, model = j_lm.make_train_step(cfg, j_adamw.AdamWConfig(**opt),
                                       microbatches=microbatches)
    params = jax.tree.map(jnp.asarray, np_params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = None
    if microbatches == 1:
        def loss_fn(p):
            kw = {k: jb[k] for k in ("image_embeds", "audio_embeds")
                  if k in jb}
            h, _ = model.forward(p, jb["tokens"], mode="train",
                                 return_hidden=True, **kw)
            w, tw = model.unembed_weights(p)
            return j_lm.vocab_parallel_ce(h, w, tw, jb["targets"],
                                          jb["loss_mask"])
        _, g = jax.jit(jax.value_and_grad(loss_fn))(params)
        grads = t_common.flatten(jax.tree.map(np.asarray, g))
    p2, _, m = jax.jit(step)(params, j_adamw.adamw_init(params), jb)
    return ({k: float(v) for k, v in m.items()}, grads,
            t_common.flatten(jax.tree.map(np.asarray, p2)))


def port_model(name, np_params, **replace):
    cfg = t_reg.smoke_variant(name).replace(**replace)
    return t_lm.build_model(cfg, state=convert.lm_params_from_numpy(
        cfg, np_params, device="cpu"))


def port_step(name, np_params, batch, microbatches=1, opt=OPT, **replace):
    """The port: (metrics, grads, updated params), grads and params flat
    in the reference's stacked layout."""
    model = port_model(name, np_params, **replace)
    step = t_lm.make_train_step(model, t_adamw.AdamWConfig(**opt),
                                microbatches=microbatches)
    params = t_lm.trainable_params(model)
    # the step's gradients: the mean over the microbatches' row blocks
    n = batch["tokens"].shape[0] // microbatches
    parts = [t_lm.loss_and_grads(model, params, t_lm.batch_to_device(
        {k: v[i * n:(i + 1) * n] for k, v in batch.items()}, "cpu"))[1]
        for i in range(microbatches)]
    grads = stacked(model.cfg, {k: sum(g[k] for g in parts).numpy()
                                / microbatches for k in parts[0]})
    _, m = step(t_adamw.adamw_init(params), batch)
    new = stacked(model.cfg, {k: p.detach().numpy().copy()
                              for k, p in params.items()})
    return {k: float(v) for k, v in m.items()}, grads, new


def stacked(cfg, flat: dict) -> dict:
    """A port state ({name: array}, one entry a layer) as the reference's
    flat stacked leaves."""
    out = {}
    for key, sub in t_lm.param_defs(cfg).items():
        for name in t_common.flatten({key: sub}):
            if key in t_tf.STACKED:
                rest = name[len(key) + 1:]
                n = t_common.flatten(sub)[rest].shape[0]
                out[name] = np.stack([flat[f"{key}.{i}.{rest}"]
                                      for i in range(n)])
            else:
                out[name] = flat[name]
    return out


def rel_max(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / max(np.max(np.abs(want)), 1e-30))


# entries whose AdamW step the optimizer's eps still moves: |g * clip
# scale| below 1000 eps
STEP_FLOOR = 1e3 * t_adamw.AdamWConfig().eps
EXCLUDED: dict = {}     # {(arch, leaf): entries left out, compared}


def assert_step_matches(name, jm, jg, jp, tm, tg, tp, np_grads=None):
    """The bars of the module docstring.  Updated parameters are compared
    where the reference's gradient (or, with ``np_grads``, the port's
    one-batch gradient) is off 0 by more than the gradient bar and its
    clipped value is past ``STEP_FLOOR``, or where both packages'
    gradients are exactly 0 (a row no token reads: weight decay alone);
    the entries left out are counted in ``EXCLUDED`` (zamba2's Mamba
    layers, whose gradients are small, leave most out)."""
    assert abs(tm["loss"] - jm["loss"]) <= LOSS_TOL * abs(jm["loss"]), \
        (name, tm["loss"], jm["loss"])
    assert abs(tm["grad_norm"] - jm["grad_norm"]) \
        <= GNORM_TOL * jm["grad_norm"], (name, tm["grad_norm"],
                                         jm["grad_norm"])
    assert abs(tm["lr"] - jm["lr"]) <= 1e-6 * jm["lr"]
    if jg is not None:
        assert set(tg) == set(jg)
        for k in jg:
            assert rel_max(tg[k], jg[k]) <= GRAD_TOL, (name, k,
                                                       rel_max(tg[k], jg[k]))
    ref_grads = jg if jg is not None else np_grads
    port_grads = tg if tg is not None else np_grads
    scale = min(1.0, 1.0 / max(jm["grad_norm"], 1e-9))   # clip_norm 1
    n_kept = 0
    for k, want in jp.items():
        diff = np.abs(tp[k].astype(np.float64) - want)
        g = np.abs(ref_grads[k])
        keep = ((g > GRAD_TOL * max(g.max(), 1e-30))
                & (g * scale > STEP_FLOOR)) \
            | ((g == 0) & (port_grads[k] == 0))
        EXCLUDED[(name, k)] = (int((~keep).sum()), int(keep.sum()))
        n_kept += int(keep.sum())
        assert diff[keep].max(initial=0.0) <= PARAM_ATOL, \
            (name, k, diff[keep].max())
    assert n_kept > 0, name


@pytest.mark.parametrize("name", DENSE)
def test_train_step_matches_jax(name):
    cfg = j_reg.smoke_variant(name)
    np_params = weights(j_lm.build_model(cfg).param_defs())
    batch = batch_for(cfg)
    jm, jg, jp = jax_step(name, np_params, batch)
    tm, tg, tp = port_step(name, np_params, batch)
    assert_step_matches(name, jm, jg, jp, tm, tg, tp)


@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "zamba2-1.2b"])
def test_microbatches_match_jax_scan(name):
    """``microbatches=2``: float32 gradient sums over the two row blocks,
    loss and gradients averaged, against the reference's scan; updated
    parameters held where the microbatches' mean gradient (the port's,
    from ``loss_and_grads`` on each block) is off 0."""
    cfg = j_reg.smoke_variant(name)
    np_params = weights(j_lm.build_model(cfg).param_defs(), seed=1)
    batch = batch_for(cfg, seed=1, b=4)
    jm, _, jp = jax_step(name, np_params, batch, microbatches=2)
    tm, tg, tp = port_step(name, np_params, batch, microbatches=2)
    assert_step_matches(name, jm, None, jp, tm, None, tp, np_grads=tg)


@pytest.mark.parametrize("name", sorted(j_reg.ARCHS))
def test_remat_changes_no_number(name, no_drops):
    """Remat (per layer, and grouped every 2 layers) recomputes the same
    forward: loss and every gradient equal to the run without it."""
    cfg = j_reg.smoke_variant(name)
    np_params = weights(j_lm.build_model(cfg).param_defs(), seed=2)
    batch = t_lm.batch_to_device(batch_for(cfg, seed=2), "cpu")
    runs = []
    for remat, group in ((False, 1), (True, 1), (True, 2)):
        model = port_model(name, np_params, remat=remat, remat_group=group)
        model.requires_grad_(True)
        params = t_lm.trainable_params(model)
        loss, g = t_lm.loss_and_grads(model, params, batch)
        runs.append((float(loss), g))
    for loss, g in runs[1:]:
        assert loss == runs[0][0], name
        for k, v in g.items():
            assert torch.equal(v, runs[0][1][k]), (name, k)


def test_reference_init_step():
    """phi4-mini at the reference's own init (``init_params``, PRNGKey 0):
    loss within 1e-5 (the forward is not yet chaotic at one step), grad
    norm and every gradient within 2e-3 (the float32 floor of that init:
    the port's flash against its own naive attention part by 4e-5 here,
    and by up to 5e-4 on gemma3 and llama-vision)."""
    name = "phi4-mini-3.8b"
    cfg = j_reg.smoke_variant(name)
    params = j_init_params(j_lm.build_model(cfg).param_defs(),
                           jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    batch = batch_for(cfg)
    jm, jg, _ = jax_step(name, np_params, batch)
    tm, tg, _ = port_step(name, np_params, batch)
    assert abs(tm["loss"] - jm["loss"]) <= LOSS_TOL * abs(jm["loss"])
    assert abs(tm["grad_norm"] - jm["grad_norm"]) <= 2e-3 * jm["grad_norm"]
    for k in jg:
        assert rel_max(tg[k], jg[k]) <= 2e-3, (k, rel_max(tg[k], jg[k]))
