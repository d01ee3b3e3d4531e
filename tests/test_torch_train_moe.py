"""One train step of the port's moe family (deepseek-v2-lite with MLA
and a leading dense layer, mixtral) against the JAX package's ``jax.jit(
make_train_step(...))`` on the CPU, at the smoke configs: the gradients
through the router's top-k, the slot scatter into the experts' inputs
and the gather back, at the reference's ``CAPACITY_FACTOR`` (1.5), at 16
in both packages (nothing drops) and at 0.5 (half the assignments drop).

Weights, batches and bars are ``tests/test_torch_train_archs.py``'s: loss
1e-5 relative, grad norm 1e-4, every gradient leaf 1e-4 of its largest
entry, updated parameters 1e-7 where AdamW's step is not near sign(g).
"""
import numpy as np
import pytest
import torch

from repro.configs import registry as j_reg
from repro.models import lm as j_lm
from repro.models import moe as j_moe
from repro_torch import convert
from repro_torch.configs import registry as t_reg
from repro_torch.models import lm as t_lm
from repro_torch.models import moe as t_moe
from test_torch_train_archs import weights
from test_torch_train_families import step_case

MOE = ["deepseek-v2-lite-16b", "mixtral-8x7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke widths: torch's intra-op threads buy nothing here and, beside
    the other test workers, spin on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", MOE)
def test_train_step_matches_jax(name):
    """At the reference's ``CAPACITY_FACTOR`` (1.5)."""
    step_case(name)


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("capacity", [0.5, 16.0])
def test_moe_train_step_capacity(name, capacity, monkeypatch):
    """``CAPACITY_FACTOR`` patched in both packages: 16, nothing drops;
    0.5, at least half the assignments drop (48 tokens x top-2 = 96
    assignments for 48 slots: 8 experts x 6, or 4 x 12)."""
    monkeypatch.setattr(j_moe, "CAPACITY_FACTOR", capacity)
    monkeypatch.setattr(t_moe, "CAPACITY_FACTOR", capacity)
    step_case(name, seed=3)


@pytest.mark.parametrize("name", MOE)
def test_moe_drops_happen(name, monkeypatch):
    """At ``CAPACITY_FACTOR = 0.5`` the router's slots past capacity are
    there, so the step above runs through drops."""
    monkeypatch.setattr(t_moe, "CAPACITY_FACTOR", 0.5)
    cfg = t_reg.smoke_variant(name)
    np_params = weights(j_lm.build_model(j_reg.smoke_variant(name))
                        .param_defs(), seed=3)
    model = t_lm.build_model(cfg, state=convert.lm_params_from_numpy(
        cfg, np_params, device="cpu"))
    h = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 24, cfg.d_model)).astype(np.float32))
    _, _, slot, C = t_moe.route(model.layers[0]["ffn"], h, cfg)
    assert int((slot >= C).sum()) >= 48, name
