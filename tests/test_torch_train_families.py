"""One train step of the port's hybrid (zamba2), ssm (xlstm), vlm
(llama-3.2-vision, with image embeddings) and audio (whisper, with audio
embeddings) architectures against the JAX package's ``jax.jit(
make_train_step(...))`` on the CPU, at the smoke configs: the gradients
through the recurrences' loops over time against JAX's ``lax.scan``,
through cross attention and the encoder.  The moe family is
``tests/test_torch_train_moe.py``'s.

Weights, batches and bars are ``tests/test_torch_train_archs.py``'s: loss
1e-5 relative, grad norm 1e-4, every gradient leaf 1e-4 of its largest
entry, updated parameters 1e-7 where AdamW's step is not near sign(g).
"""
import pytest
import torch

from repro.configs import registry as j_reg
from repro.models import lm as j_lm
from test_torch_train_archs import (assert_step_matches, batch_for,
                                    jax_step, port_step, weights)

FAMILIES = ["llama-3.2-vision-11b", "whisper-tiny", "xlstm-1.3b",
            "zamba2-1.2b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke widths: torch's intra-op threads buy nothing here and, beside
    the other test workers, spin on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def step_case(name, seed=0):
    cfg = j_reg.smoke_variant(name)
    np_params = weights(j_lm.build_model(cfg).param_defs(), seed=seed)
    batch = batch_for(cfg, seed=seed)
    jm, jg, jp = jax_step(name, np_params, batch)
    tm, tg, tp = port_step(name, np_params, batch)
    assert_step_matches(name, jm, jg, jp, tm, tg, tp)


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_jax(name):
    step_case(name)
