"""The paper's competing algorithms (``repro_torch.baselines``) against
the reference's (``repro.baselines``) on the CPU: the two sequential scans'
plain versions, every ``fit_*``, the configs, and the reference's own
sanity contracts (tests/test_baselines.py) on the port.

The same numpy inputs go to both packages.  Tolerances: the scans 1e-6 of
the largest entry (float32, sums in another order); fits at equal
iteration counts beta within 1e-5 and each f within 1e-6 relative (an f is
a float32 sum of a few hundred losses, which the two packages add in
another order: 4.4e-7 apart at beta = 0), nnz equal.  Past the float32
plateau an Armijo test or a stop test can tie in one package and not the
other: L-BFGS at lam2 = 0.8 parts there after 25 iterations (both then
take no step: beta 1.3e-4 apart, f one float32 step apart), so beta is
held at 25 iterations and the 80-iteration run by its f.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import admm as j_admm
from repro.baselines import lbfgs as j_lbfgs
from repro.baselines import online_tg as j_tg
from repro.data import synthetic as j_synth
from repro_torch.baselines import admm as t_admm
from repro_torch.baselines import lbfgs as t_lbfgs
from repro_torch.baselines import online_tg as t_tg
from repro_torch.baselines import (fit_admm, fit_lbfgs,
                                   fit_online_warmstart_lbfgs, fit_online_tg)
from repro_torch.core import prox_ref
from repro_torch.kernels import ops, ref

DS = j_synth.make_dense(n=500, p=60, seed=21)
FAMS = ["logistic", "squared", "probit", "poisson"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These problems are a few hundred rows: torch's intra-op threads buy
    nothing there and, beside the other test workers, spin on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labels(rng, family, n):
    if family == "poisson":
        return rng.poisson(1.5, n).astype(np.float32)
    if family == "squared":
        return rng.normal(size=n).astype(np.float32)
    return rng.choice([-1.0, 1.0], n).astype(np.float32)


def _hist_close(h_t, h_j, f_rel=1e-6):
    assert len(h_t["f"]) == len(h_j["f"])
    np.testing.assert_allclose(h_t["f"], h_j["f"], rtol=f_rel, atol=0)
    assert h_t["nnz"] == h_j["nnz"]


@pytest.mark.parametrize("cls", [(t_admm.ADMMConfig, j_admm.ADMMConfig),
                                 (t_tg.OnlineTGConfig, j_tg.OnlineTGConfig),
                                 (t_lbfgs.LBFGSConfig, j_lbfgs.LBFGSConfig)],
                         ids=["admm", "online_tg", "lbfgs"])
def test_config_fields_and_defaults_match_reference(cls):
    mine, theirs = cls
    assert [(f.name, f.default) for f in dataclasses.fields(mine)] == \
        [(f.name, f.default) for f in dataclasses.fields(theirs)]
    assert mine.__dataclass_params__.frozen


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("lam1,lam2", [(0.4, 0.0), (0.4, 0.3), (0.0, 0.7)])
def test_shooting_pass_matches_jax(passes, lam1, lam2):
    """ref.shooting_pass of every block against the reference's
    ``_shooting_pass`` under ``vmap``, pass by pass; n = 45 and p_block =
    13 are not multiples of 32."""
    rng = np.random.default_rng(passes)
    M, n, pb = 3, 45, 13
    A = rng.normal(size=(M, n, pb)).astype(np.float32)
    A[1, :, 4] = 0.0                       # a dead column
    x0 = (0.3 * rng.normal(size=(M, pb))).astype(np.float32)
    v = rng.normal(size=(M, n)).astype(np.float32)
    csq = np.einsum("mnp,mnp->mp", A, A).astype(np.float32)
    one = jax.vmap(j_admm._shooting_pass, in_axes=(0, 0, 0, None, None, 0))
    xj = jnp.asarray(x0)
    for _ in range(passes):
        xj = one(jnp.asarray(A), xj, jnp.asarray(v), lam1, lam2,
                 jnp.asarray(csq))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = ops.admm_shooting(t(A.transpose(0, 2, 1)), t(x0), t(v), t(csq),
                            lam1, lam2, passes)
    want = np.asarray(xj)
    assert got.shape == (M, pb)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want).max()))
    assert got[1, 4].item() == 0.0          # S(0, lam1) / max(lam2, 1e-30)


def test_shooting_pass_zero_passes_keeps_x():
    rng = np.random.default_rng(0)
    At = torch.from_numpy(rng.normal(size=(2, 5, 7)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 5)).astype(np.float32))
    got = ref.shooting_pass(At, x, torch.zeros(2, 7), (At * At).sum(2),
                            0.1, 0.0, 0)
    assert torch.equal(got, x)


@pytest.mark.parametrize("family", FAMS)
def test_online_tg_epoch_matches_jax(family):
    """ref.online_tg_epoch against the reference's ``_epoch`` (4 shards of
    37 rows, p = 45), from a nonzero start at a late global step."""
    rng = np.random.default_rng(len(family))
    M, n_per, p = 4, 37, 45
    X = (0.3 * rng.normal(size=(M, n_per, p))).astype(np.float32)
    y = _labels(rng, family, M * n_per).reshape(M, n_per)
    w0 = (0.1 * rng.normal(size=p)).astype(np.float32)
    cfg = j_tg.OnlineTGConfig(lam1=0.01, lam2=0.05, lr=0.3, family=family)
    t0 = np.float32(1.0 + 3 * n_per)
    want = np.asarray(j_tg._epoch(jnp.asarray(X), jnp.asarray(y),
                                  jnp.asarray(w0), jnp.float32(t0), cfg))
    got = ops.online_tg_epoch(torch.from_numpy(X), torch.from_numpy(y),
                              torch.from_numpy(w0), t0, family, lr=cfg.lr,
                              power=cfg.lr_decay_power, lam1=cfg.lam1,
                              lam2=cfg.lam2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


def test_online_tg_steps_count_in_float32():
    """t stops growing at 2^24, as the reference's float32 scan carries
    it."""
    etas = ref.online_tg_steps(np.float32(2.0 ** 24 - 2), 5, 0.3, 0.6)
    t = np.float32(2.0 ** 24 - 2)
    want = []
    for _ in range(5):
        want.append(np.float32(0.3) / np.power(t, np.float32(0.6)))
        t = np.float32(t + np.float32(1.0))
    assert np.array_equal(etas, np.array(want, np.float32))
    assert ref.online_tg_steps(1.0, 0, 0.3, 0.6).shape == (0,)


@pytest.mark.parametrize("p", [60, 61])
@pytest.mark.parametrize("lam2", [0.0, 0.3])
def test_fit_admm_matches_jax(p, lam2):
    """p = 61 pads one zero column into the last of the 4 blocks."""
    X = DS.train.X if p == 60 else np.concatenate(
        [DS.train.X, 0.5 * DS.train.X[:, :1]], axis=1)
    cfg = j_admm.ADMMConfig(lam1=0.5, lam2=lam2, rho=1.0, n_blocks=4,
                            max_outer=30)
    b_j, h_j = j_admm.fit_admm(X, DS.train.y, cfg)
    b_t, h_t = fit_admm(X, DS.train.y,
                        t_admm.ADMMConfig(**dataclasses.asdict(cfg)),
                        device="cpu")
    assert b_t.shape == (p,)
    np.testing.assert_allclose(b_t, b_j, rtol=0, atol=1e-5)
    _hist_close(h_t, h_j)


@pytest.mark.parametrize("family", ["logistic", "poisson"])
def test_fit_online_tg_matches_jax(family):
    ds = DS if family == "logistic" else j_synth.make_dense(
        n=500, p=60, family=family, seed=21)
    cfg = j_tg.OnlineTGConfig(lam1=0.2, lam2=0.1, epochs=10, lr=0.3,
                              family=family)
    b_j, h_j = j_tg.fit_online_tg(ds.train.X, ds.train.y, cfg, seed=3)
    b_t, h_t = fit_online_tg(ds.train.X, ds.train.y,
                             t_tg.OnlineTGConfig(**dataclasses.asdict(cfg)),
                             seed=3, device="cpu")
    np.testing.assert_allclose(b_t, b_j, rtol=0, atol=1e-5)
    _hist_close(h_t, h_j)


@pytest.mark.parametrize("lam2,iters", [(0.8, 25), (0.5, 12)])
def test_fit_lbfgs_matches_jax(lam2, iters):
    cfg = j_lbfgs.LBFGSConfig(lam2=lam2, max_iter=iters)
    b_j, h_j = j_lbfgs.fit_lbfgs(DS.train.X, DS.train.y, cfg)
    b_t, h_t = fit_lbfgs(DS.train.X, DS.train.y,
                         t_lbfgs.LBFGSConfig(**dataclasses.asdict(cfg)),
                         device="cpu")
    np.testing.assert_allclose(b_t, b_j, rtol=0, atol=1e-5)
    _hist_close(h_t, h_j)


def test_fit_lbfgs_past_the_plateau_matches_jax_in_f():
    """80 iterations at lam2 = 0.8: an Armijo test ties in float32 near
    iteration 27 in one package only; from there neither moves.  Equal
    iteration counts, every f within 1e-6, the last within 1e-6."""
    cfg = j_lbfgs.LBFGSConfig(lam2=0.8, max_iter=80)
    b_j, h_j = j_lbfgs.fit_lbfgs(DS.train.X, DS.train.y, cfg)
    b_t, h_t = fit_lbfgs(DS.train.X, DS.train.y,
                         t_lbfgs.LBFGSConfig(**dataclasses.asdict(cfg)),
                         device="cpu")
    _hist_close(h_t, h_j)
    np.testing.assert_allclose(b_t, b_j, rtol=0, atol=1e-3)


def test_fit_online_warmstart_lbfgs_matches_jax():
    lc = j_lbfgs.LBFGSConfig(lam2=0.5, max_iter=5)
    oc = j_tg.OnlineTGConfig(lam1=0.0, lam2=0.5, epochs=3, lr=0.3)
    b_j, h_j = j_lbfgs.fit_online_warmstart_lbfgs(DS.train.X, DS.train.y,
                                                  lc, oc)
    b_t, h_t = fit_online_warmstart_lbfgs(
        DS.train.X, DS.train.y, t_lbfgs.LBFGSConfig(**dataclasses.asdict(lc)),
        t_tg.OnlineTGConfig(**dataclasses.asdict(oc)), device="cpu")
    np.testing.assert_allclose(b_t, b_j, rtol=0, atol=1e-5)
    _hist_close(h_t, h_j)


def test_fit_online_warmstart_default_online_config_matches_jax():
    lc = j_lbfgs.LBFGSConfig(lam2=0.5, max_iter=4)
    b_j, h_j = j_lbfgs.fit_online_warmstart_lbfgs(DS.train.X, DS.train.y, lc)
    b_t, h_t = fit_online_warmstart_lbfgs(
        DS.train.X, DS.train.y, t_lbfgs.LBFGSConfig(**dataclasses.asdict(lc)),
        device="cpu")
    np.testing.assert_allclose(b_t, b_j, rtol=0, atol=1e-5)
    _hist_close(h_t, h_j)


def test_fit_lbfgs_takes_a_tensor_w0():
    """w0 as numpy or as a tensor: the same fit."""
    cfg = t_lbfgs.LBFGSConfig(lam2=0.5, max_iter=4)
    w0 = np.linspace(-0.1, 0.1, DS.train.X.shape[1]).astype(np.float32)
    b_np, h_np = fit_lbfgs(DS.train.X, DS.train.y, cfg, w0=w0, device="cpu")
    b_t, h_t = fit_lbfgs(DS.train.X, DS.train.y, cfg,
                         w0=torch.from_numpy(w0), device="cpu")
    assert np.array_equal(b_np, b_t) and h_np == h_t


# --- the reference's contracts (tests/test_baselines.py) on the port ------

def test_admm_decreases_objective():
    beta, hist = fit_admm(DS.train.X, DS.train.y,
                          t_admm.ADMMConfig(lam1=0.5, lam2=0.0, rho=1.0,
                                            n_blocks=4, max_outer=30),
                          device="cpu")
    f = hist["f"]
    assert f[-1] < f[0]
    _, oh = prox_ref.fit_fista(DS.train.X, DS.train.y, lam1=0.5, lam2=0.0,
                               max_iter=2000, device="cpu")
    # ADMM converges slowly but must be in the right basin
    assert f[-1] < 1.6 * oh[-1]


def test_online_tg_learns():
    beta, hist = fit_online_tg(DS.train.X, DS.train.y,
                               t_tg.OnlineTGConfig(lam1=0.2, lam2=0.1,
                                                   epochs=10, lr=0.3),
                               device="cpu")
    # online SGD oscillates between epochs; it must beat the w=0 objective
    assert min(hist["f"][1:]) < hist["f"][0]
    assert np.isfinite(beta).all()


def test_lbfgs_matches_oracle_l2():
    lam2 = 0.8
    beta, hist = fit_lbfgs(DS.train.X, DS.train.y,
                           t_lbfgs.LBFGSConfig(lam2=lam2, max_iter=80),
                           device="cpu")
    _, oh = prox_ref.fit_fista(DS.train.X, DS.train.y, lam1=0.0, lam2=lam2,
                               max_iter=3000, device="cpu")
    assert hist["f"][-1] <= oh[-1] + 1e-3 * abs(oh[-1])


def test_online_warmstart_speeds_lbfgs():
    lam2 = 0.5
    _, h_plain = fit_lbfgs(DS.train.X, DS.train.y,
                           t_lbfgs.LBFGSConfig(lam2=lam2, max_iter=5),
                           device="cpu")
    _, h_warm = fit_online_warmstart_lbfgs(
        DS.train.X, DS.train.y, t_lbfgs.LBFGSConfig(lam2=lam2, max_iter=5),
        t_tg.OnlineTGConfig(lam1=0.0, lam2=lam2, epochs=3, lr=0.3),
        device="cpu")
    # after the same 5 L-BFGS iterations the warmstarted one is ahead
    assert h_warm["f"][-1] <= h_plain["f"][-1] + 1e-6


def test_fits_default_to_the_card():
    """``device=None`` is the card: without one every fit raises rather
    than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    X, y = DS.train.X[:40], DS.train.y[:40]
    for call in (lambda: fit_admm(X, y, t_admm.ADMMConfig(max_outer=1)),
                 lambda: fit_online_tg(X, y, t_tg.OnlineTGConfig(epochs=1)),
                 lambda: fit_lbfgs(X, y, t_lbfgs.LBFGSConfig(max_iter=1)),
                 lambda: prox_ref.fit_fista(X, y, max_iter=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
