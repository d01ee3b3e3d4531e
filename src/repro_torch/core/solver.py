"""GLMSolver: a single-device fitting session (mirrors ``repro.core.solver``).

    solver = GLMSolver(X, y, family="logistic", sample_weight=w, offset=o,
                       fit_intercept=True, penalty_factor=pf)
    res = solver.fit(lam1=0.05 * solver.lambda_max())
    yhat = solver.predict(X_test)

Construction packs the design once (a dense array becomes a ``DenseDesign``,
a ``SparseCOO`` the CSR-of-bricks ``BlockSparseDesign``) and moves it with
the observation model to the device: ``device=None`` means the CUDA card;
the CPU runs only when the caller passes ``device="cpu"``, and there is no
silent fall back to it.  On the card the solver turns TF32 off for matrix
products and cuDNN, since TF32 sums would miss the 1e-5 bar on beta.

The observation model: per-example ``sample_weight`` (the loss becomes
sum_i c_i l_i; padded rows weigh 0), margin ``offset``, an unpenalized
``fit_intercept`` column (penalty factor 0) and per-feature
``penalty_factor``.  ``lambda_max`` is the smallest lam1 with every
penalized coordinate at zero, taken at the null model (intercept fitted).

Not ported yet (each raises NotImplementedError): a mesh, streaming and
file inputs, ``standardize``, checkpoints, ``fit_path``, ``fit_cv`` and
``predict`` on a SparseCOO (which in the JAX package goes through the
serving kernel).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import dglmnet, glm
from repro_torch.core.dglmnet import DGLMNETConfig, FitResult, FitState
from repro_torch.data import design as design_lib
from repro_torch.data.design import DesignMatrix
from repro_torch.data.sparse import SparseCOO
from repro_torch.kernels import ops

_HISTORY_KEYS = ("f", "alpha", "mu", "nnz", "accepted_unit")
_PF_EPS = 1e-12          # pf below this counts as "unpenalized"


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # full fp32 Gram sums: TF32 would break the 1e-5 bar on beta
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (a later slice of the "
        "port); use the JAX package repro for it")


def _with_intercept_column(X, n: int):
    """Append the all-ones intercept column to a raw host input."""
    if isinstance(X, SparseCOO):
        p = X.shape[1]
        rows = np.concatenate([X.rows,
                               np.arange(n, dtype=np.asarray(X.rows).dtype)])
        cols = np.concatenate([X.cols, np.full((n,), p,
                                               np.asarray(X.cols).dtype)])
        vals = np.concatenate([np.asarray(X.vals, np.float32),
                               np.ones((n,), np.float32)])
        return SparseCOO(rows, cols, vals, (n, p + 1))
    if isinstance(X, DesignMatrix):
        raise ValueError(
            "fit_intercept=True needs a raw input (dense array or "
            "SparseCOO): the intercept column is appended before packing")
    X = np.asarray(X, np.float32)
    return np.concatenate([X, np.ones((X.shape[0], 1), np.float32)], axis=1)


class GLMSolver:
    """Reusable single-device solver session over one (X, y)."""

    def __init__(self, X, y, *, family=None,
                 config: Optional[DGLMNETConfig] = None, device=None,
                 mesh=None, row_block: int = 256, reorder: bool = True,
                 design_info=None, sample_weight=None, offset=None,
                 standardize: bool = False, fit_intercept: bool = False,
                 penalty_factor=None):
        if mesh is not None:
            raise _not_ported("a device mesh (multi-GPU fitting)")
        if standardize:
            raise _not_ported("standardize=True")
        if isinstance(X, (str, os.PathLike)) or y is None:
            raise _not_ported("streaming and file-backed designs")
        config = DGLMNETConfig() if config is None else config
        if family is not None:
            fam = glm.resolve_family(family)
            if fam.name != config.family:
                config = dataclasses.replace(config, family=fam.name)
        glm.get_family(config.family)
        self.config = config
        self.device = resolve_device(device)
        self.fit_intercept = bool(fit_intercept)
        self.beta_: Optional[np.ndarray] = None
        self.intercept_: float = 0.0
        self._state: Optional[FitState] = None
        self._lmax: Optional[float] = None

        y = np.asarray(y, np.float32)
        n = y.shape[0]
        T = config.tile_size
        sw = np.ones((n,), np.float32) if sample_weight is None else \
            np.asarray(sample_weight, np.float32)
        off = np.zeros((n,), np.float32) if offset is None else \
            np.asarray(offset, np.float32)
        if sw.shape != (n,) or off.shape != (n,):
            raise ValueError(
                f"sample_weight/offset must be ({n},); got {sw.shape} / "
                f"{off.shape}")
        if (sw < 0).any():
            raise ValueError("sample_weight must be nonnegative")
        if self.fit_intercept:
            X = _with_intercept_column(X, n)

        design, info = design_lib.as_design(
            X, T, row_block=row_block, reorder=reorder, info=design_info,
            device=self.device)
        self._Xs, self._info = design, info
        n_rows, p_pad = design.shape
        self._n_tot, self._p_tot = n_rows, p_pad
        self._n_tiles = design.n_tiles

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
                .to(self.device)

        self._ys = put(np.pad(y, (0, n_rows - n), constant_values=1.0))
        self._wobs = put(np.pad(sw, (0, n_rows - n)))      # padding -> 0
        self._offsets = put(np.pad(off, (0, n_rows - n)))

        self._p_model = info.shape[1]            # columns incl. intercept
        self._p_user = self._p_model - (1 if self.fit_intercept else 0)
        pf = np.ones((self._p_user,), np.float32) if penalty_factor is None \
            else np.asarray(penalty_factor, np.float32)
        if pf.shape != (self._p_user,):
            raise ValueError(
                f"penalty_factor must be ({self._p_user},); got {pf.shape}")
        if (pf < 0).any():
            raise ValueError("penalty_factor must be nonnegative")
        if self.fit_intercept:
            pf = np.concatenate([pf, np.zeros((1,), np.float32)])
        # padding columns keep pf = 1 so they stay pinned at zero
        self._penf_host = info.pack_cols(pf, p_pad, fill=1.0)
        self._penf = put(self._penf_host)
        self._superstep = dglmnet.make_superstep(
            config, n_tiles=self._n_tiles, device=self.device)

    @property
    def info(self):
        return self._info

    @property
    def design(self) -> DesignMatrix:
        return self._Xs

    # ------------------------------------------------------------ packing

    def _icol(self) -> int:
        """Packed column of the intercept."""
        if self._info.col_of_feature is None:
            return self._p_user
        return int(self._info.col_of_feature[self._p_user])

    def _unpack_user(self, beta_packed: np.ndarray):
        """Packed beta -> (beta in feature order (p_user,), intercept)."""
        unpacked = self._info.unpack_beta(
            np.asarray(beta_packed, np.float32))
        if self.fit_intercept:
            return unpacked[:self._p_user], float(unpacked[-1])
        return unpacked, 0.0

    def _pack_user(self, beta_user, intercept: float = 0.0) -> np.ndarray:
        beta_user = np.asarray(beta_user, np.float32)
        if beta_user.shape != (self._p_user,):
            raise ValueError(
                f"beta0 must be ({self._p_user},); got {beta_user.shape}")
        full = np.concatenate([beta_user, np.zeros((1,), np.float32)]) \
            if self.fit_intercept else beta_user
        packed = self._info.pack_beta(full, self._p_tot)
        if self.fit_intercept:
            packed[self._icol()] = float(intercept)
        return packed

    # ---------------------------------------------------------- outer loop

    def _init_state(self, beta0=None, intercept0: float = 0.0) -> FitState:
        dev = self.device
        if beta0 is not None:
            beta = torch.from_numpy(self._pack_user(beta0, intercept0)).to(dev)
            xb = self._Xs.matvec(beta)
        else:
            beta = torch.zeros(self._p_tot, dtype=torch.float32, device=dev)
            xb = torch.zeros(self._n_tot, dtype=torch.float32, device=dev)
        mu = torch.full((), self.config.mu_init, dtype=torch.float32,
                        device=dev)
        return FitState(beta=beta, xb=xb, mu=mu, cursor=0, step=0)

    def _run(self, state: FitState, lam1: float, lam2: float, *,
             active=None, max_outer=None, tol=None, verbose=False):
        """Supersteps at fixed (lam1, lam2) until the objective plateaus.

        ``active``: optional host (p_tot,) 0/1 mask in packed column order;
        coordinates at 0 stay frozen and tiles without an active coordinate
        are skipped.  Returns (state, history, n_iter, converged); the
        history also records each superstep's host seconds (``step_s``),
        taken after the one device-to-host read of its metrics.
        """
        cfg = self.config
        max_outer = cfg.max_outer if max_outer is None else int(max_outer)
        tol = cfg.tol if tol is None else float(tol)
        active_dev = tile_active = None
        if active is not None:
            act = np.asarray(active, np.float32)
            active_dev = torch.from_numpy(act).to(self.device)
            tile_active = act.reshape(self._n_tiles, cfg.tile_size) \
                .max(axis=1) > 0
        history = {k: [] for k in _HISTORY_KEYS + ("step_s",)}
        f_prev, converged, it = np.inf, False, 0
        t_prev = time.perf_counter()
        for it in range(1, max_outer + 1):
            state, m = self._superstep(
                self._Xs, self._ys, self._wobs, self._offsets, (lam1, lam2),
                self._penf, state, active=active_dev,
                tile_active=tile_active)
            # one device-to-host read per superstep, all metrics together
            vals = torch.stack([m[k].to(torch.float64)
                                for k in dglmnet.METRIC_KEYS]).cpu().numpy()
            mh = dict(zip(dglmnet.METRIC_KEYS, vals.tolist()))
            now = time.perf_counter()
            history["step_s"].append(now - t_prev)
            t_prev = now
            f = mh["f"]
            for k in _HISTORY_KEYS:
                history[k].append(mh[k])
            if verbose:
                print(f"[repro_torch] it={it} f={f:.8f} "
                      f"alpha={mh['alpha']:.4f} mu={mh['mu']:.3f} "
                      f"nnz={int(mh['nnz'])}")
            if np.isfinite(f_prev) and \
                    abs(f_prev - f) <= tol * max(1.0, abs(f)):
                converged = True
                break
            f_prev = f
        return state, history, it, converged

    def fit(self, lam1: Optional[float] = None, lam2: Optional[float] = None,
            *, beta0=None, intercept0: float = 0.0, max_outer=None, tol=None,
            verbose=False, ckpt_manager=None) -> FitResult:
        """Fit one (lam1, lam2) point; defaults come from the config.
        ``beta0`` (+ ``intercept0``) warm-starts from beta in feature order."""
        if ckpt_manager is not None:
            raise _not_ported("checkpointing")
        cfg = self.config
        lam1 = cfg.lam1 if lam1 is None else float(lam1)
        lam2 = cfg.lam2 if lam2 is None else float(lam2)
        state = self._init_state(beta0, intercept0)
        state, history, n_iter, converged = self._run(
            state, lam1, lam2, max_outer=max_outer, tol=tol, verbose=verbose)
        self._state = state
        self.beta_, self.intercept_ = self._unpack_user(
            state.beta.cpu().numpy())
        return FitResult(self.beta_, history, n_iter, converged)

    def _grad_state(self, state: FitState) -> np.ndarray:
        """g = X^T s(beta) in packed column order, on the host."""
        _, s, _ = ops.glm_stats(self._ys, state.xb, self.config.family,
                                weights=self._wobs, offset=self._offsets)
        return self._Xs.rmatvec(s).cpu().numpy()

    def lambda_max(self) -> float:
        """Smallest lam1 with every PENALIZED coordinate zero: max_j |g_j| /
        pf_j at the null model (unpenalized coordinates, the intercept, are
        fitted first; they are active at every lam1)."""
        if self._lmax is None:
            pen = self._penf_host > _PF_EPS
            if not pen.any():
                raise ValueError(
                    "lambda_max undefined: every feature is unpenalized")
            state = self._init_state(None)
            if (~pen).any():
                state, _, _, _ = self._run(
                    state, 0.0, 0.0, active=(~pen).astype(np.float32),
                    max_outer=50)
            g = np.abs(self._grad_state(state))
            self._lmax = float((g[pen] / self._penf_host[pen]).max())
        return self._lmax

    def fit_path(self, *args, **kwargs):
        raise _not_ported("fit_path (warm-started lambda paths)")

    def fit_cv(self, *args, **kwargs):
        raise _not_ported("fit_cv (K-fold cross-validation)")

    # ------------------------------------------------------------ predict

    def predict(self, X_new, *, beta=None, intercept=None, offset=None,
                kind: str = "response"):
        """Predict on new dense rows with the fitted (or a given) beta.
        ``kind="link"`` gives margins X beta + b0 + o, ``"response"`` the
        family's inverse link."""
        beta = self.beta_ if beta is None else np.asarray(beta, np.float32)
        if beta is None:
            raise ValueError("no fitted coefficients; call fit first or "
                             "pass beta=...")
        intercept = self.intercept_ if intercept is None else float(intercept)
        if kind not in ("link", "response"):
            raise ValueError(f"unknown kind {kind!r}; use 'link' or "
                             "'response'")
        if isinstance(X_new, SparseCOO):
            raise _not_ported("predict on SparseCOO rows (the serving "
                              "kernel predict_tile)")
        m = np.asarray(X_new, np.float32) @ beta + intercept
        if offset is not None:
            m = m + np.asarray(offset, np.float32)
        if kind == "link":
            return m
        fam = glm.get_family(self.config.family)
        return fam.predict(torch.from_numpy(np.asarray(m))).numpy()

    def score(self, X_new, y_new, *, beta=None, intercept=None,
              offset=None) -> float:
        """``glm.margin_score`` on held-out rows: accuracy for logistic and
        probit, R^2 for squared loss, mean negative loss for poisson."""
        m = self.predict(X_new, beta=beta, intercept=intercept,
                         offset=offset, kind="link")
        return glm.margin_score(self.config.family,
                                np.asarray(y_new, np.float32), m)
