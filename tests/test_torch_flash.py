"""The flash backward of the port's attention (``models.common.
FlashAttention``, the reference's ``custom_vjp`` as a
``torch.autograd.Function``) against the JAX package's on the CPU.

The forward and dq, dk, dv of ``chunked_attention(impl="flash")`` are
held to 1e-5 of the largest |entry| against ``jax.vjp`` of the
reference's ``chunked_attention(impl="flash")``, and against autograd
through the port's ``naive_attention``: causal and not, a sliding window,
a softcap, ``q_offset``, a key count that is not a multiple of the chunk
(padded keys masked), GQA with ``rep`` 2 and 3, and ``hd_v != hd`` (MLA).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as j_common
from repro_torch.models import common as t_common

FLASH_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: torch's intra-op threads buy nothing here and, beside
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


FLASH_CASES = {
    "causal": dict(),
    "non_causal": dict(causal=False),
    "window": dict(window=5),
    "softcap": dict(softcap=3.0),
    "q_offset": dict(Sq=6, q_offset=15),
    "padded_chunk": dict(Sq=21, Sk=21),
    "gqa_rep3": dict(H=6, Hkv=2),
    "mla_hd_v": dict(hd=12, hd_v=8, H=4, Hkv=4),
    "all": dict(Sq=19, Sk=19, window=7, softcap=2.0, H=6, Hkv=3),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_matches_jax(case):
    kw = dict(B=2, Sq=20, Sk=20, H=4, Hkv=2, hd=8, hd_v=8, causal=True,
              window=None, softcap=None, q_offset=0, chunk=8)
    kw.update(FLASH_CASES[case])
    if kw["q_offset"]:
        kw["Sk"] = kw["q_offset"] + kw["Sq"]
    rng = np.random.default_rng(sorted(FLASH_CASES).index(case))
    B, Sq, Sk, H, Hkv = kw["B"], kw["Sq"], kw["Sk"], kw["H"], kw["Hkv"]
    q = rng.normal(size=(B, Sq, H, kw["hd"])).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, kw["hd"])).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, kw["hd_v"])).astype(np.float32)
    dout = rng.normal(size=(B, Sq, H, kw["hd_v"])).astype(np.float32)
    opts = dict(causal=kw["causal"], window=kw["window"],
                q_offset=kw["q_offset"], softcap=kw["softcap"])

    def j_out(q_, k_, v_):
        return j_common.chunked_attention(q_, k_, v_, chunk=kw["chunk"],
                                          impl="flash", **opts)
    j_o, vjp = jax.vjp(j_out, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    j_grads = vjp(jnp.asarray(dout))

    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    t_o = t_common.chunked_attention(tq, tk, tv, chunk=kw["chunk"],
                                     impl="flash", **opts)
    t_grads = torch.autograd.grad(t_o, (tq, tk, tv), _t(dout))
    assert _rel(t_o.detach(), j_o) <= FLASH_TOL
    for name, got, want in zip("qkv", t_grads, j_grads):
        assert _rel(got, want) <= FLASH_TOL, (case, name)
    n_o = t_common.chunked_attention(tq, tk, tv, impl="naive", **opts)
    n_grads = torch.autograd.grad(n_o, (tq, tk, tv), _t(dout))
    for name, got, want in zip("qkv", t_grads, n_grads):
        assert _rel(got, want) <= FLASH_TOL, (case, name, "naive")


def test_flash_saves_only_raw_inputs():
    """The Function keeps q, k, v for the backward, nothing of chunk
    size; without gradients it builds no graph."""
    q = torch.randn(1, 12, 2, 4, requires_grad=True)
    k = torch.randn(1, 12, 2, 4)
    v = torch.randn(1, 12, 2, 4)
    out = t_common.chunked_attention(q, k, v, chunk=4)
    saved = out.grad_fn.next_functions[0][0].saved_tensors
    assert [tuple(t.shape) for t in saved] == [(1, 12, 2, 4)] * 3
    with torch.no_grad():
        assert t_common.chunked_attention(q, k, v, chunk=4).grad_fn is None
