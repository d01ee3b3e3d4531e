"""The plain versions of the recurrences' scan kernels
(``repro_torch.kernels.ref``: ``ssm_scan``, ``mlstm_scan``, ``slstm_scan``)
against the JAX package's own scans on the CPU, and their routing through
``kernels.ops``.

The same numpy inputs, drawn from a seed, go to both packages:
``repro.models.ssm._ssm_scan``, ``repro.models.xlstm._mlstm_core`` and
``_mlstm_step``, and a ``jax.lax.scan`` over
``repro.models.xlstm._slstm_step`` (what ``slstm_apply`` runs).  Cases:
zero and non-zero initial states, S = 1 (a decode step), an mLSTM whose
values are a block of the keys' head dim (hd_v < hd_k, a tensor-parallel
rank's), and an sLSTM whose input gates overflow float32's exp.

Bar: outputs and final states within 1e-5 of the largest |value| of the
reference's (float32, the sums in another order), over the positions
where both are finite, and the non-finite positions equal.  The kernels
themselves run only on the card (``tests/test_torch_gpu.py``, marked
``gpu``; ``chip_smoke.py``'s ``scans`` part at full width).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as j_ssm
from repro.models import xlstm as j_xlstm
from repro_torch.kernels import ops, ref

TOL = 1e-5


def _rel(got, want) -> float:
    """max |got - want| over the positions where both are finite, over
    the largest finite |want|; the non-finite positions must be equal."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    if not fin.any():
        return 0.0
    return float(np.abs(got - want)[fin].max() / max(np.abs(want[fin]).max(),
                                                     1e-30))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# Mamba2's selective scan
# ---------------------------------------------------------------------------

def _ssm_inputs(seed, B, S, H, hd, ds, warm):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xh = rng.normal(size=(B, S, H, hd)).astype(f32)
    Bm = rng.normal(size=(B, S, ds)).astype(f32)
    Cm = rng.normal(size=(B, S, ds)).astype(f32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(f32)
    A = np.exp(rng.normal(size=H) * 0.5).astype(f32)
    D = rng.normal(size=H).astype(f32)
    state0 = (rng.normal(size=(B, H, hd, ds)) if warm
              else np.zeros((B, H, hd, ds))).astype(f32)
    return xh, Bm, Cm, dt, A, D, state0


@pytest.mark.parametrize("S,warm", [(9, False), (9, True), (1, True)],
                         ids=["zero_state", "warm_state", "decode"])
def test_ssm_scan_matches_jax(S, warm):
    args = _ssm_inputs(0, 2, S, 3, 8, 5, warm)
    want_y, want_h = jax.jit(j_ssm._ssm_scan)(*map(_j, args))
    got_y, got_h = ref.ssm_scan(*map(_t, args))
    assert _rel(got_y, want_y) <= TOL
    assert _rel(got_h, want_h) <= TOL


# ---------------------------------------------------------------------------
# the mLSTM step scan
# ---------------------------------------------------------------------------

def _mlstm_inputs(seed, B, S, H, hd_k, hd_v, warm):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    q = rng.normal(size=(B, S, H, hd_k)).astype(f32)
    k = rng.normal(size=(B, S, H, hd_k)).astype(f32)
    v = rng.normal(size=(B, S, H, hd_v)).astype(f32)
    i_pre = (rng.normal(size=(B, S, H)) * 2).astype(f32)
    f_pre = (rng.normal(size=(B, S, H)) * 2 + 1).astype(f32)
    if warm:
        state = (rng.normal(size=(B, H, hd_k, hd_v)).astype(f32),
                 rng.normal(size=(B, H, hd_k)).astype(f32),
                 rng.normal(size=(B, H)).astype(f32))
    else:
        state = (np.zeros((B, H, hd_k, hd_v), f32),
                 np.zeros((B, H, hd_k), f32), np.full((B, H), -1e30, f32))
    return (q, k, v, i_pre, f_pre), state


@pytest.mark.parametrize("S,hd_v,warm", [
    (11, 16, False), (11, 16, True), (11, 8, True), (1, 16, True)],
    ids=["zero_state", "warm_state", "hd_v_block", "decode"])
def test_mlstm_scan_matches_jax(S, hd_v, warm):
    hd_k = 16
    xs, state = _mlstm_inputs(1, 2, S, 3, hd_k, hd_v, warm)
    q, k, v, i_pre, f_pre = xs
    want_h, want_st = jax.jit(j_xlstm._mlstm_core)(
        *map(_j, xs), tuple(map(_j, state)))
    got_h, got_st = ref.mlstm_scan(_t(q), _t(k) / math.sqrt(hd_k), _t(v),
                                   _t(i_pre), _t(f_pre),
                                   tuple(map(_t, state)))
    assert _rel(got_h, want_h) <= TOL
    for g, w in zip(got_st, want_st):
        assert _rel(g, w) <= TOL
    if S == 1:
        # a decode step is the reference's _mlstm_step
        ks = k[:, 0] / np.float32(math.sqrt(hd_k))
        want_st1, want_h1 = jax.jit(j_xlstm._mlstm_step)(
            tuple(map(_j, state)), (_j(q[:, 0]), _j(ks), _j(v[:, 0]),
                                    _j(i_pre[:, 0]), _j(f_pre[:, 0])))
        assert _rel(got_h[:, 0], want_h1) <= TOL
        for g, w in zip(got_st, want_st1):
            assert _rel(g, w) <= TOL


# ---------------------------------------------------------------------------
# the sLSTM scan
# ---------------------------------------------------------------------------

def _slstm_inputs(seed, B, S, H, hd, warm, gate_scale=1.0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    r = (rng.normal(size=(H, 4, hd, hd)) * 0.3 / np.sqrt(hd)).astype(f32)
    gates = (rng.normal(size=(B, S, 4, H, hd)) * gate_scale).astype(f32)
    if warm:
        state = (rng.normal(size=(B, H, hd)).astype(f32),
                 np.abs(rng.normal(size=(B, H, hd))).astype(f32) + 0.5,
                 rng.normal(size=(B, H, hd)).astype(f32),
                 rng.normal(size=(B, H)).astype(f32))
    else:
        z = np.zeros((B, H, hd), f32)
        state = (z, z, z, np.full((B, H), -1e30, f32))
    return r, gates, state


def _jax_slstm(r, gates, state):
    p_r = _j(r)

    def run(st, g):
        return jax.lax.scan(lambda s, gt: j_xlstm._slstm_step(p_r, s, gt),
                            st, jnp.transpose(g, (1, 0, 2, 3, 4)))
    st, hs = jax.jit(run)(tuple(map(_j, state)), _j(gates))
    return np.transpose(np.asarray(hs), (1, 0, 2, 3)), st


@pytest.mark.parametrize("S,warm,scale", [
    (10, False, 1.0), (10, True, 1.0), (1, True, 1.0), (10, False, 60.0)],
    ids=["zero_state", "warm_state", "decode", "overflow"])
def test_slstm_scan_matches_jax(S, warm, scale):
    r, gates, state = _slstm_inputs(2, 2, S, 3, 12, warm, scale)
    want_h, want_st = _jax_slstm(r, gates, state)
    got_h, got_st = ref.slstm_scan(_t(r), tuple(map(_t, state)), _t(gates),
                                   S)
    assert _rel(got_h, want_h) <= TOL
    for g, w in zip(got_st, want_st):
        assert _rel(g, w) <= TOL
    if scale > 1:
        # exp overflowed: c / n = inf / inf, as in the reference
        bad = ~np.isfinite(np.asarray(want_h))
        assert bad.any() and not bad.all()


def test_slstm_scan_block_with_given_stabilizers():
    """One step of a block of hd with the head-level means given (``sc``,
    what a rank of a model axis past 1 runs) equals that block of the
    whole step."""
    hd, half = 12, 6
    r, gates, state = _slstm_inputs(3, 2, 1, 3, hd, True)
    r, gates = _t(r), _t(gates)
    c, n, h, m = map(_t, state)
    whole_h, whole_st = ref.slstm_scan(r, (c, n, h, m), gates, 1)
    pre = gates[:, 0] + torch.einsum("bhk,hgkv->bghv", h, r)
    sc = torch.stack([pre[:, 1].mean(-1), pre[:, 2].mean(-1)], dim=1)
    blk_h, blk_st = ref.slstm_scan(
        r[..., :half], (c[..., :half], n[..., :half], h, m),
        gates[..., :half], 1, sc=sc)
    assert _rel(blk_h, whole_h[..., :half]) <= TOL
    for g, w in zip(blk_st[:3], whole_st[:3]):
        assert _rel(g, w[..., :half]) <= TOL
    assert _rel(blk_st[3], whole_st[3]) <= TOL


# ---------------------------------------------------------------------------
# routing (kernels.ops): the CPU runs the plain version; the rest of the
# rule needs the card (tests/test_torch_gpu.py)
# ---------------------------------------------------------------------------

def _ops_calls():
    """(name, ops call, ref call) of each scan on small inputs."""
    ssm = tuple(map(_t, _ssm_inputs(4, 2, 5, 2, 8, 4, True)))
    xs, st = _mlstm_inputs(5, 2, 5, 2, 8, 8, True)
    mx, mst = tuple(map(_t, xs)), tuple(map(_t, st))
    r, gates, sst = _slstm_inputs(6, 2, 5, 2, 8, True)
    r, gates, sst = _t(r), _t(gates), tuple(map(_t, sst))
    return [
        ("ssm_scan", lambda **kw: ops.ssm_scan(*ssm, **kw),
         lambda: ref.ssm_scan(*ssm)),
        ("mlstm_scan", lambda **kw: ops.mlstm_scan(*mx, mst, **kw),
         lambda: ref.mlstm_scan(*mx, mst)),
        ("slstm_scan", lambda **kw: ops.slstm_scan(r, sst, gates, 5, **kw),
         lambda: ref.slstm_scan(r, sst, gates, 5)),
    ]


@pytest.mark.parametrize("case", range(3), ids=["ssm", "mlstm", "slstm"])
def test_ops_scan_on_the_cpu_is_the_plain_version(case):
    name, call, plain = _ops_calls()[case]
    with ops.launch_trace() as events:
        got = call()
    assert events == [name]
    want = plain()
    assert torch.equal(got[0], want[0])
    got_st = got[1] if isinstance(got[1], tuple) else (got[1],)
    want_st = want[1] if isinstance(want[1], tuple) else (want[1],)
    assert all(torch.equal(g, w) for g, w in zip(got_st, want_st))
    # a cache's leaves take the final state in place
    outs = tuple(torch.full_like(w, 7.0) for w in want_st)
    got = call(out=outs[0] if name == "ssm_scan" else outs)
    got_st = got[1] if isinstance(got[1], tuple) else (got[1],)
    assert all(g is o and torch.equal(o, w)
               for g, o, w in zip(got_st, outs, want_st))
    # no kernel launched and no plain route counted on the CPU
    counts = ops.launch_counts()
    assert counts[name] == 0 and counts[f"{name}/plain"] == 0


def test_ops_scan_raises_off_the_cpu_and_the_card():
    xh, Bm, Cm, dt, A, D, s0 = (t.to("meta") for t in map(
        _t, _ssm_inputs(7, 1, 2, 1, 4, 4, False)))
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        ops.ssm_scan(xh, Bm, Cm, dt, A, D, s0)
