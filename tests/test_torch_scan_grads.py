"""The backward of the recurrences' scans (``repro_torch.kernels.ref``:
``ssm_scan_bwd``, ``mlstm_scan_bwd``, ``slstm_scan_bwd``) against
``jax.vjp`` of the JAX package's own scans on the CPU, and the autograd
Functions of ``kernels.ops`` (``SsmScan``, ``MlstmScan``, ``SlstmScan``)
that route a training call through them.

The same numpy inputs and cotangents, drawn from a seed, go to both
packages: ``repro.models.ssm._ssm_scan``, ``repro.models.xlstm.
_mlstm_core`` (which scales k itself) and a ``jax.lax.scan`` over
``repro.models.xlstm._slstm_step``.  Cases: zero and non-zero initial
states, S = 1, S not a multiple of the checkpoint stride
(``ref.CKPT_EVERY``), an mLSTM whose values are a block of the keys'
head dim (hd_v < hd_k), and the sLSTM's block of hd with its head-level
stabilizers given (``sc``), composed as a rank of a model axis past 1
composes it, against the whole step.

Bar: every gradient within 1e-5 of its largest |entry| (float32, the
sums in another order).  Beside JAX: the plain backward against autograd
through the plain forward loop; ``torch.autograd.gradcheck`` of each
Function in float64; ``ops.<scan>`` under grad on the CPU (through the
Function) against autograd of the plain loop; and a call without a
gradient saves nothing.  The backward kernels run only on the card
(``tests/test_torch_gpu.py -m gpu -k scan``; ``chip_smoke.py``'s train
phase).
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
L = ref.CKPT_EVERY


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _close(got, want, tol=TOL):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().numpy() if torch.is_tensor(g) else g
        assert _rel(g, w) <= tol, (i, _rel(g, w))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _cot(rng, like):
    return rng.normal(size=np.shape(like)).astype(np.float32)


# ---------------------------------------------------------------------------
# Mamba2's selective scan
# ---------------------------------------------------------------------------

def _ssm_inputs(seed, B, S, H, hd, ds, warm):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xh = rng.normal(size=(B, S, H, hd)).astype(f32)
    Bm = rng.normal(size=(B, S, ds)).astype(f32)
    Cm = rng.normal(size=(B, S, ds)).astype(f32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(f32) * 0.5
    A = np.exp(rng.normal(size=H) * 0.5).astype(f32)
    D = rng.normal(size=H).astype(f32)
    state0 = (rng.normal(size=(B, H, hd, ds)) if warm
              else np.zeros((B, H, hd, ds))).astype(f32)
    args = (xh, Bm, Cm, dt, A, D, state0)
    cots = (_cot(rng, xh), _cot(rng, state0))
    return args, cots


SSM_CASES = {"zero_state": (9, False), "warm_state": (9, True),
             "one_step": (1, True), "ragged_segments": (2 * L + 5, True)}


@pytest.mark.parametrize("case", sorted(SSM_CASES))
def test_ssm_scan_bwd_matches_jax_vjp(case):
    S, warm = SSM_CASES[case]
    args, (dy, dh) = _ssm_inputs(0, 2, S, 3, 8, 5, warm)
    _, vjp = jax.vjp(j_ssm._ssm_scan, *map(_j, args))
    want = vjp((_j(dy), _j(dh)))
    targs = tuple(map(_t, args))
    _, _, ckpts = ref.ssm_scan(*targs, ckpt_every=L)
    assert ckpts.shape[0] == -(-S // L)
    got = ref.ssm_scan_bwd(*targs[:6], ckpts, _t(dy), _t(dh), L)
    _close(got, want)


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
    cots = (_cot(rng, v), *(_cot(rng, s) for s in state))
    return (q, k, v, i_pre, f_pre), state, cots


MLSTM_CASES = {"zero_state": (11, 16, False), "warm_state": (11, 16, True),
               "hd_v_block": (11, 8, True), "one_step": (1, 16, True),
               "ragged_segments": (2 * L + 3, 16, True)}


@pytest.mark.parametrize("case", sorted(MLSTM_CASES))
def test_mlstm_scan_bwd_matches_jax_vjp(case):
    S, hd_v, warm = MLSTM_CASES[case]
    hd_k = 16
    xs, state, (dhs, *dst) = _mlstm_inputs(1, 2, S, 3, hd_k, hd_v, warm)
    _, vjp = jax.vjp(j_xlstm._mlstm_core, *map(_j, xs),
                     tuple(map(_j, state)))
    *want, want_st = vjp((_j(dhs), tuple(map(_j, dst))))
    q, k, v, i_pre, f_pre = map(_t, xs)
    ks = k / math.sqrt(hd_k)
    st = tuple(map(_t, state))
    hs, _, saved = ref.mlstm_scan(q, ks, v, i_pre, f_pre, st, ckpt_every=L)
    dq, dk, dv, di, df, *dst0 = ref.mlstm_scan_bwd(
        q, ks, v, i_pre, f_pre, st[2], saved, hs, _t(dhs),
        *map(_t, dst), L)
    got = (dq, dk / math.sqrt(hd_k), dv, di, df)
    _close(got, want)
    _close(dst0, want_st)


# ---------------------------------------------------------------------------
# the sLSTM scan
# ---------------------------------------------------------------------------

def _slstm_inputs(seed, B, S, H, hd, warm):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    r = (rng.normal(size=(H, 4, hd, hd)) * 0.3 / np.sqrt(hd)).astype(f32)
    gates = rng.normal(size=(B, S, 4, H, hd)).astype(f32)
    if warm:
        state = (rng.normal(size=(B, H, hd)).astype(f32),
                 np.abs(rng.normal(size=(B, H, hd))).astype(f32) + 0.5,
                 rng.normal(size=(B, H, hd)).astype(f32),
                 rng.normal(size=(B, H)).astype(f32))
    else:
        z = np.zeros((B, H, hd), f32)
        state = (z, z, z, np.full((B, H), -1e30, f32))
    cots = (_cot(rng, gates[:, :, 0]), *(_cot(rng, s) for s in state))
    return r, gates, state, cots


def _jax_slstm(r, gates, state):
    def run(st, g):
        return jax.lax.scan(lambda s, gt: j_xlstm._slstm_step(r, s, gt),
                            st, jnp.transpose(g, (1, 0, 2, 3, 4)))
    st, hs = run(state, gates)
    return jnp.transpose(hs, (1, 0, 2, 3)), st


SLSTM_CASES = {"zero_state": (10, False), "warm_state": (10, True),
               "one_step": (1, True), "ragged_segments": (L + 5, True)}


@pytest.mark.parametrize("case", sorted(SLSTM_CASES))
def test_slstm_scan_bwd_matches_jax_vjp(case):
    S, warm = SLSTM_CASES[case]
    r, gates, state, (dhs, *dst) = _slstm_inputs(2, 2, S, 3, 12, warm)
    _, vjp = jax.vjp(_jax_slstm, _j(r), _j(gates), tuple(map(_j, state)))
    want_r, want_g, want_st = vjp((_j(dhs), tuple(map(_j, dst))))
    tr, tg, st = _t(r), _t(gates), tuple(map(_t, state))
    hs, _, saved = ref.slstm_scan(tr, st, tg, S, save=True)
    dpre, dr, dst0, dsc = ref.slstm_scan_bwd(tr, st, None, saved, hs,
                                             _t(dhs), *map(_t, dst))
    assert dsc is None
    _close((dr, dpre), (want_r, want_g))
    _close(dst0, want_st)


def test_slstm_scan_bwd_block_with_given_stabilizers():
    """Two halves of hd, each one step through ``SlstmScan`` with the
    head-level means given (``sc``, made by autograd-tracked ops as
    ``xlstm._slstm_scan`` makes them on a layout), compose to the whole
    step's gradients by JAX's vjp: dsc carries the means' share."""
    hd, half = 12, 6
    r, gates, state, (dhs, *dst) = _slstm_inputs(3, 2, 1, 3, hd, True)
    _, vjp = jax.vjp(_jax_slstm, _j(r), _j(gates), tuple(map(_j, state)))
    want_r, want_g, want_st = vjp((_j(dhs), tuple(map(_j, dst))))
    tr = _t(r).requires_grad_(True)
    tg = _t(gates).requires_grad_(True)
    st = tuple(_t(s).requires_grad_(True) for s in state)
    c, n, h, m = st
    pre = tg[:, 0] + torch.einsum("bhk,hgkv->bghv", h, tr)
    sc = torch.stack([pre[:, 1].mean(-1), pre[:, 2].mean(-1)], dim=1)
    loss = 0.0
    for blk in (slice(0, half), slice(half, hd)):
        hs, (c1, n1, h1, m1) = ops.slstm_scan(
            tr[..., blk], (c[..., blk], n[..., blk], h, m), tg[..., blk], 1,
            sc=sc)
        loss = loss + (hs * _t(dhs)[..., blk]).sum() \
            + (c1 * _t(dst[0])[..., blk]).sum() \
            + (n1 * _t(dst[1])[..., blk]).sum() \
            + (h1 * _t(dst[2])[..., blk]).sum() \
            + (m1 * _t(dst[3])).sum() / 2
    got = torch.autograd.grad(loss, (tr, tg, *st))
    _close(got[:2], (want_r, want_g))
    _close(got[2:], want_st)


# ---------------------------------------------------------------------------
# the plain backward against autograd through the plain forward loop
# ---------------------------------------------------------------------------

def _ssm_case(dtype=torch.float32, S=2 * L + 3):
    args, cots = _ssm_inputs(4, 2, S, 2, 6, 4, True)
    return tuple(_t(a, dtype) for a in args), tuple(_t(c, dtype)
                                                     for c in cots)


def _mlstm_case(dtype=torch.float32, S=2 * L + 3, hd_v=6):
    xs, st, cots = _mlstm_inputs(5, 2, S, 2, 8, hd_v, True)
    xs = tuple(_t(a, dtype) for a in xs)
    xs = (xs[0], xs[1] / math.sqrt(8), *xs[2:])
    return xs + tuple(_t(s, dtype) for s in st), tuple(_t(c, dtype)
                                                        for c in cots)


def _slstm_case(dtype=torch.float32, S=L + 3):
    r, gates, st, cots = _slstm_inputs(6, 2, S, 2, 6, True)
    return (_t(r, dtype), *(_t(s, dtype) for s in st), _t(gates, dtype)), \
        tuple(_t(c, dtype) for c in cots)


def _plain(name):
    """The plain forward of each scan over the Functions' argument
    order, returning a flat tuple of outputs."""
    if name == "ssm":
        return lambda *a: ref.ssm_scan(*a)
    if name == "mlstm":
        return lambda q, k, v, i, f, C, n, m: (lambda o: (o[0], *o[1]))(
            ref.mlstm_scan(q, k, v, i, f, (C, n, m)))
    return lambda r, c, n, h, m, g: (lambda o: (o[0], *o[1]))(
        ref.slstm_scan(r, (c, n, h, m), g, g.shape[1]))


def _function(name):
    if name == "ssm":
        return ops.SsmScan.apply
    if name == "mlstm":
        return ops.MlstmScan.apply
    return lambda r, c, n, h, m, g: ops.SlstmScan.apply(
        r, c, n, h, m, g, None, g.shape[1])


CASES = {"ssm": _ssm_case, "mlstm": _mlstm_case, "slstm": _slstm_case}


def _grads(fn, args, cots):
    args = tuple(a.clone().requires_grad_(True) for a in args)
    outs = fn(*args)
    return torch.autograd.grad(outs, args, cots)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_bwd_matches_autograd_of_the_plain_loop(name):
    args, cots = CASES[name]()
    want = _grads(_plain(name), args, cots)
    if name == "ssm":
        _, _, ck = ref.ssm_scan(*args, ckpt_every=L)
        got = ref.ssm_scan_bwd(*args[:6], ck, *cots, L)
    elif name == "mlstm":
        hs, _, saved = ref.mlstm_scan(*args[:5], args[5:], ckpt_every=L)
        got = ref.mlstm_scan_bwd(*args[:5], args[7], saved, hs, *cots, L)
    else:
        r, st, g = args[0], args[1:5], args[5]
        hs, _, saved = ref.slstm_scan(r, st, g, g.shape[1], save=True)
        dpre, dr, dst, _ = ref.slstm_scan_bwd(r, st, None, saved, hs, *cots)
        got = (dr, *dst, dpre)
    _close(got, [w.numpy() for w in want])


@pytest.mark.parametrize("name", sorted(CASES))
def test_ops_scan_under_grad_goes_through_the_function(name):
    """``ops.<scan>`` with an input that requires a gradient, on the CPU:
    the Function (plain forward, plain backward) against autograd of the
    plain loop, and its outputs the plain loop's bit for bit."""
    args, cots = CASES[name]()
    want = _grads(_plain(name), args, cots)
    targs = tuple(a.clone().requires_grad_(True) for a in args)
    if name == "ssm":
        outs = ops.ssm_scan(*targs)
    elif name == "mlstm":
        hs, st = ops.mlstm_scan(*targs[:5], targs[5:])
        outs = (hs, *st)
    else:
        hs, st = ops.slstm_scan(targs[0], targs[1:5], targs[5],
                                targs[5].shape[1])
        outs = (hs, *st)
    fn_name = {"ssm": "SsmScan", "mlstm": "MlstmScan", "slstm": "SlstmScan"}
    assert type(outs[0].grad_fn).__name__ == fn_name[name] + "Backward"
    with torch.no_grad():
        plain = _plain(name)(*args)
    assert all(torch.equal(o, p) for o, p in zip(outs, plain))
    got = torch.autograd.grad(outs, targs, cots)
    _close(got, [w.numpy() for w in want])
    counts = ops.launch_counts()
    assert counts[f"{name}_scan/plain"] == 0
    assert counts[f"{name}_scan_bwd"] == 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_gradcheck_float64(name):
    """Each Function's backward against finite differences in float64 on
    tiny shapes (random inputs: no tie at a max), the scans with
    checkpoints over two segments."""
    S = L + 2
    if name == "ssm":
        args, _ = _ssm_inputs(7, 1, S, 1, 2, 2, True)
    elif name == "mlstm":
        xs, st, _ = _mlstm_inputs(8, 1, S, 1, 3, 2, True)
        args = (*xs, *st)
    else:
        r, gates, st, _ = _slstm_inputs(9, 1, 5, 1, 3, True)
        args = (r, *st, gates)
    args = tuple(_t(a, torch.float64).requires_grad_(True) for a in args)
    assert torch.autograd.gradcheck(_function(name), args, eps=1e-6,
                                    atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_call_without_a_gradient_saves_nothing(name):
    """Under no_grad, or with no input requiring a gradient, a scan call
    packs no tensor for a backward and its outputs carry no graph; with a
    gradient the Function saves its checkpoints."""
    args, _ = CASES[name]()
    packed = []

    def call(a):
        if name == "ssm":
            return ops.ssm_scan(*a)[0]
        if name == "mlstm":
            return ops.mlstm_scan(*a[:5], a[5:])[0]
        return ops.slstm_scan(a[0], a[1:5], a[5], a[5].shape[1])[0]

    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: packed.append(t) or t, lambda t: t):
        out = call(args)
        assert out.grad_fn is None and not packed
        req = tuple(a.clone().requires_grad_(True) for a in args)
        with torch.no_grad():
            out = call(req)
        assert out.grad_fn is None and not packed
        out = call(req)
    assert out.grad_fn is not None and packed
