"""The L1 comparison's d-GLMNET protocol (benchmarks/fig2_4_l1.py: fused
Jacobi, tile 256, 30 supersteps, tol 0, lam1 = 1) on a cut of the dense
split, in both packages on the CPU: the reference's fit and the port's
(``device="cpu"``) give the same objective history, and so sit the same
distance above FISTA's f*.  A gap to f* after 30 supersteps is then the
algorithm's on this data, not the port's.

Run as a script, it prints the same comparison on a larger cut (the full
split's generator, ``make_dense(..., p=2000, k_true=200, seed=0)``, with
fewer rows): the objective at 10 and 30 supersteps in each package,
both FISTA optima, and the port run on to more supersteps.

    PYTHONPATH=src python tests/test_torch_protocol_witness.py [n_rows]
"""
import json
import sys
import time

import numpy as np
import torch

import repro.core  # noqa: F401  (design <-> ops import cycle: core first)
from repro.core import prox_ref as j_prox
from repro.core.dglmnet import DGLMNETConfig as JConfig
from repro.core.solver import GLMSolver as JSolver
from repro.data import synthetic as j_synth
from repro_torch.core import prox_ref
from repro_torch.core.dglmnet import DGLMNETConfig as TConfig
from repro_torch.core.solver import GLMSolver as TSolver

LAM1 = 1.0          # fig2_4_l1.py's LAM1
ITERS = 30          # fig2_4_l1.py's ITERS


def _cut(n_rows, p):
    """The train split of the dense generator at n_rows rows (80% of
    ``n``, as the full split's 400,000 of 500,000)."""
    ds = j_synth.make_dense(n=n_rows * 5 // 4, p=p, k_true=p // 10, seed=0)
    return ds.train.X, ds.train.y


def _protocol(Solver, Config, X, y, supersteps, **kw):
    cfg = Config(tile_size=256, coupling="jacobi", max_outer=supersteps,
                 tol=0.0)
    res = Solver(X, y, config=cfg, **kw).fit(lam1=LAM1, lam2=0.0)
    return np.asarray(res.history["f"], np.float64)


def test_protocol_gap_is_the_references():
    """4,000 x 512: the two packages' 30-superstep histories within 1e-5
    relative (float32 sums in another order, as tests/test_torch_fused.py
    holds whole fits), and the last f of each the same distance above the
    port's FISTA f* (within 1e-5 of f*)."""
    X, y = _cut(4_000, 512)
    f_j = _protocol(JSolver, JConfig, X, y, ITERS)
    f_t = _protocol(TSolver, TConfig, X, y, ITERS, device="cpu")
    assert f_j.shape == f_t.shape == (ITERS,)
    np.testing.assert_allclose(f_t, f_j, rtol=1e-5, atol=0)
    _, h = prox_ref.fit_fista(X, y, lam1=LAM1, max_iter=500, device="cpu")
    f_star = h[-1]
    assert np.all(np.isfinite(f_t)) and f_t[-1] >= f_star * (1 - 1e-6)
    assert abs((f_t[-1] - f_j[-1]) / f_star) <= 1e-5


def main(n_rows: int = 40_000) -> None:
    X, y = _cut(n_rows, 2_000)
    out = {"shape": list(X.shape), "lam1": LAM1,
           "torch_threads": torch.get_num_threads()}
    t0 = time.perf_counter()
    f_j = _protocol(JSolver, JConfig, X, y, ITERS)
    out["jax_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    f_t = _protocol(TSolver, TConfig, X, y, ITERS, device="cpu")
    out["port_s"] = time.perf_counter() - t0
    _, h_t = prox_ref.fit_fista(X, y, lam1=LAM1, max_iter=500, device="cpu")
    _, h_j = j_prox.fit_fista(X, y, lam1=LAM1, max_iter=500)
    f_star = float(h_t[-1])
    out["fista"] = {"port_f_star": f_star, "port_iters": len(h_t) - 1,
                    "jax_f_star": float(h_j[-1]), "jax_iters": len(h_j) - 1}
    out["history_max_rel_diff"] = float(np.max(np.abs(f_t / f_j - 1)))
    for k in (10, ITERS):
        out[f"at_{k}"] = {"jax_f": float(f_j[k - 1]),
                          "port_f": float(f_t[k - 1]),
                          "jax_subopt": float((f_j[k - 1] - f_star)
                                              / abs(f_star)),
                          "port_subopt": float((f_t[k - 1] - f_star)
                                               / abs(f_star))}
    f_long = _protocol(TSolver, TConfig, X, y, 400, device="cpu")
    out["port_run_on"] = {str(k): {"f": float(f_long[k - 1]),
                                   "subopt": float((f_long[k - 1] - f_star)
                                                   / abs(f_star))}
                          for k in (50, 100, 200, 400)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
