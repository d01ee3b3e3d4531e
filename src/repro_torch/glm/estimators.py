"""sklearn-style estimators over the ``GLMSolver`` session (mirrors
``repro.glm.estimators``).

Construct with hyper-parameters, then ``fit(X, y)`` / ``predict(X)`` /
``score(X, y)``; the fitted state is ``coef_`` / ``intercept_``.  The
session (``repro_torch.core.solver.GLMSolver``) does the work; an
estimator builds one in ``fit`` and delegates.  ``device=None`` means the
CUDA card, ``device="cpu"`` the plain versions on the CPU.

``lam1=None`` selects lam1 by ``cv``-fold cross-validation over the
automatic lambda_max -> lambda_max * ``lam_ratio`` grid; ``cv_result_``
keeps the whole ``CVResult``.

``est.save(path)`` exports a serving artifact (``quantize="int8"`` for the
shared-scale int8 table) and ``ElasticNetGLM.load(path)`` rebuilds a
predict- and score-capable estimator over a ``ScoringEngine``: a SparseCOO
is scored by the fused gather-dot-link kernel (K7).

  * ``ElasticNetGLM``: any family (``family=`` a name or a GLMFamily);
  * ``LogisticRegressionCD``: binary classifier on any two labels, with
    ``predict_proba`` and class predictions;
  * ``PoissonRegressorCD``: count regression (log link), ``score`` the
    deviance ratio D^2;
  * ``MultinomialGLM``: softmax classifier by exact class cycling over one
    logistic session.

``fit(path_or_reader, y=None)`` trains out of core from a file
(``repro_torch.io``) with the labels it holds; a ``StreamingDesign`` works
as X too.  Not ported yet (raises NotImplementedError): ``mesh=``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core import glm
from repro_torch.core.dglmnet import DGLMNETConfig
from repro_torch.core.solver import GLMSolver


def _resolve_source(X, y):
    """``fit(path_or_reader, y=None)``: the labels come from the data source
    itself (``repro_torch.io``), and the opened reader goes on to the
    solver, which streams from it without scanning the file again."""
    if y is not None:
        return X, y
    from repro_torch import io as io_lib
    if isinstance(X, (str, os.PathLike)):
        X = io_lib.open_reader(X)
    if not io_lib.is_reader(X):
        raise ValueError(
            "y=None is only valid when X is a path or a repro_torch.io "
            "reader that can supply its own labels")
    return X, X.labels()


def _binary(fam) -> bool:
    return fam.name in ("logistic", "probit")


class ElasticNetGLM:
    """Elastic-net regularized GLM fit by distributed coordinate descent.

    ``lam1``/``lam2`` are the L1/L2 weights (``lam1=None``: select by
    ``cv``-fold cross-validation); ``penalty_factor`` rescales (lam1, lam2)
    per feature; ``standardize`` fits on weighted-variance-1 columns and
    returns original-scale coefficients; the intercept is never penalized.
    """

    _family: Optional[str] = None       # subclasses pin the family

    def __init__(self, *, family=None, lam1=None, lam2: float = 0.0,
                 fit_intercept: bool = True, standardize: bool = True,
                 penalty_factor=None, cv: int = 5, n_lambdas: int = 50,
                 lam_ratio: float = 1e-3,
                 config: Optional[DGLMNETConfig] = None,
                 mesh=None, tile_size: int = 64, max_outer: int = 200,
                 tol: float = 1e-10, device=None, **solver_kwargs):
        if self._family is not None:
            if family is not None and \
                    glm.resolve_family(family).name != self._family:
                raise ValueError(
                    f"{type(self).__name__} is fixed to the "
                    f"{self._family!r} family")
            family = self._family
        self.family = "logistic" if family is None else family
        self.lam1 = lam1
        self.lam2 = lam2
        self.fit_intercept = fit_intercept
        self.standardize = standardize
        self.penalty_factor = penalty_factor
        self.cv = cv
        self.n_lambdas = n_lambdas
        self.lam_ratio = lam_ratio
        self.mesh = mesh
        self.config = config if config is not None else DGLMNETConfig(
            tile_size=tile_size, max_outer=max_outer, tol=tol)
        self.device = device
        self.solver_kwargs = solver_kwargs

    # ------------------------------------------------------------- fitting

    def _encode_y(self, y):
        fam = glm.resolve_family(self.family)
        if _binary(fam):
            # the binary families fit on {-1, +1}: map any two-valued
            # encoding ({0, 1} would zero every y = 0 gradient)
            y = np.asarray(y)
            self.classes_ = np.unique(y)
            if len(self.classes_) != 2:
                raise ValueError(
                    f"{type(self).__name__} with the {fam.name!r} family "
                    f"needs exactly 2 classes; got {self.classes_!r}")
            return np.where(y == self.classes_[1], 1.0,
                            -1.0).astype(np.float32)
        y = np.asarray(y, np.float32)
        if fam.name == "poisson" and (y < 0).any():
            raise ValueError("poisson targets must be nonnegative counts")
        return y

    def fit(self, X, y=None, *, sample_weight=None, offset=None):
        X, y = _resolve_source(X, y)
        y_enc = self._encode_y(y)
        self.solver_ = GLMSolver(
            X, y_enc, family=self.family, config=self.config, mesh=self.mesh,
            sample_weight=sample_weight, offset=offset,
            standardize=self.standardize, fit_intercept=self.fit_intercept,
            penalty_factor=self.penalty_factor, device=self.device,
            **self.solver_kwargs)
        self.cv_result_ = None
        if self.lam1 is None:
            self.cv_result_ = self.solver_.fit_cv(
                self.cv, n_lambdas=self.n_lambdas, lam_ratio=self.lam_ratio,
                lam2=self.lam2)
            self.lam1_ = float(self.cv_result_.lam_best)
        else:
            self.lam1_ = float(self.lam1)
            self.solver_.fit(lam1=self.lam1_, lam2=self.lam2)
        self.coef_ = self.solver_.beta_
        self.intercept_ = self.solver_.intercept_
        return self

    def _check_fitted(self):
        if getattr(self, "solver_", None) is None and \
                getattr(self, "_engine_", None) is None:
            raise ValueError(f"{type(self).__name__} is not fitted yet; "
                             "call fit(X, y) or load(path) first")

    # ------------------------------------------------------ artifact I/O

    def save(self, path, *, quantize=None):
        """Export a serving artifact: original-scale coefficients,
        intercept, family, the penalty's provenance and, for the binary
        families, the label classes.  ``quantize="int8"`` writes the
        shared-scale int8 table (margins within the manifest's bound)."""
        self._check_fitted()
        from repro_torch.serve import artifact
        return artifact.export(self, path, quantize=quantize)

    @classmethod
    def load(cls, path, *, device=None):
        """A predict- and score-capable estimator from a saved artifact:
        ``coef_``, ``intercept_``, ``classes_`` and the provenance come
        back, and margins come from a ``ScoringEngine`` on ``device``
        (None: the CUDA card).  There is no training session to resume."""
        from repro_torch.serve.artifact import load_artifact
        from repro_torch.serve.engine import ScoringEngine
        model = load_artifact(path)
        if model.n_outputs != 1:
            raise ValueError(
                f"artifact at {path} holds {model.n_outputs} output "
                "columns (a λ-path / A-B stack); estimators serve exactly "
                "one — score it with repro_torch.serve.ScoringEngine "
                "instead")
        if cls._family is not None and model.family != cls._family:
            raise ValueError(
                f"{cls.__name__} is fixed to the {cls._family!r} family; "
                f"the artifact was fitted with {model.family!r}")
        est = cls(device=device) if cls._family is not None \
            else cls(family=model.family, device=device)
        est.solver_ = None
        est.cv_result_ = None
        est._servable_ = model
        est._engine_ = ScoringEngine(model, device=device)
        est.coef_ = np.array(model.betas[0])
        est.intercept_ = float(model.intercepts[0])
        # the manifest's provenance, so a re-export keeps it
        est.standardize = bool(model.standardized)
        if model.lam2 is not None:
            est.lam2 = float(model.lam2)
        pf = (model.penalty or {}).get("penalty_factor")
        if pf is not None:
            est.penalty_factor = np.asarray(pf, np.float32)
        if model.lambdas is not None and len(model.lambdas):
            est.lam1_ = float(model.lambdas[0])
            est.lam1 = est.lam1_
        extra = model.extra or {}
        if extra.get("classes") is not None:
            est.classes_ = np.asarray(extra["classes"])
        elif _binary(glm.resolve_family(est.family)):
            # saved by GLMSolver.save (no label state): the solver's binary
            # families train on {-1, +1}, so that is the encoding
            est.classes_ = np.asarray([-1.0, 1.0])
        return est

    # ---------------------------------------------------------- prediction

    def decision_function(self, X, *, offset=None):
        """Margins X beta + b0 (+ offset): from the training session when
        fitted here, from the serving engine when loaded (the same
        results)."""
        self._check_fitted()
        if getattr(self, "solver_", None) is not None:
            return self.solver_.predict(X, offset=offset, kind="link")
        return self._engine_.score(X, kind="link", offset=offset)[:, 0]

    def predict(self, X, *, offset=None):
        """The family's response (inverse link of the margins)."""
        m = self.decision_function(X, offset=offset)
        fam = glm.resolve_family(self.family)
        return fam.predict(torch.from_numpy(np.asarray(m))).numpy()

    def score(self, X, y, *, offset=None):
        """``glm.margin_score`` (``GLMSolver.score``'s metric): accuracy for
        the binary families on the fit's encoding, R^2 for squared loss,
        mean negative loss otherwise."""
        self._check_fitted()
        fam = glm.resolve_family(self.family)
        m = self.decision_function(X, offset=offset)
        y = np.asarray(y)
        if _binary(fam):
            y = np.where(y == self.classes_[1], 1.0, -1.0)
        return glm.margin_score(fam, y.astype(np.float32), m)


class LogisticRegressionCD(ElasticNetGLM):
    """L1/L2-regularized logistic regression on any two labels:
    ``classes_`` keeps them, ``predict`` returns them, ``predict_proba``
    the two-column probabilities, ``score`` the accuracy."""

    _family = "logistic"

    def predict_proba(self, X, *, offset=None):
        """(n, 2) probabilities, columns ordered like ``classes_``."""
        p1 = super().predict(X, offset=offset)   # P(y = classes_[1])
        return np.stack([1.0 - p1, p1], axis=1)

    def predict(self, X, *, offset=None):
        m = self.decision_function(X, offset=offset)
        return self.classes_[(m > 0).astype(np.int64)]

    def score(self, X, y, *, offset=None):
        """Accuracy on the original labels."""
        self._check_fitted()
        return float((self.predict(X, offset=offset)
                      == np.asarray(y)).mean())


class MultinomialGLM:
    """Elastic-net multinomial (softmax) classifier by exact class cycling.

    With the other classes held fixed, the class-k part of the softmax
    objective over M = X B is exactly a binary logistic fit with labels
    +1 where y_i = k and -1 elsewhere, at the margin offset -a_ik, a_ik =
    log sum_{j != k} exp(M_ij).  So one logistic ``GLMSolver`` session
    serves every class: a class visit swaps (y, offset) with
    ``set_observations`` and warm-starts ``fit`` from the class's
    coefficients.  Cycles over the classes repeat until the multinomial
    objective stops moving; each visit minimizes exactly, so the
    objective does not rise.

    ``coef_`` is (p, K), ``intercept_`` (K,); ``predict`` returns labels
    from ``classes_``, ``predict_proba`` the softmax matrix.
    """

    def __init__(self, *, lam1: float = 1e-3, lam2: float = 0.0,
                 fit_intercept: bool = True, standardize: bool = True,
                 penalty_factor=None,
                 config: Optional[DGLMNETConfig] = None,
                 tile_size: int = 64, max_outer: int = 200,
                 tol: float = 1e-10, max_cycles: int = 20,
                 cycle_tol: float = 1e-6, device=None, **solver_kwargs):
        self.lam1 = float(lam1)
        self.lam2 = float(lam2)
        self.fit_intercept = fit_intercept
        self.standardize = standardize
        self.penalty_factor = penalty_factor
        self.config = config if config is not None else DGLMNETConfig(
            tile_size=tile_size, max_outer=max_outer, tol=tol)
        self.max_cycles = int(max_cycles)
        self.cycle_tol = float(cycle_tol)
        self.device = device
        self.solver_kwargs = solver_kwargs

    def _objective(self, yk, M, sw):
        """The multinomial objective at margins M (n, K), on the session's
        device (the plain softmax statistics)."""
        dev = self.solver_.device
        put = lambda a: torch.from_numpy(np.ascontiguousarray(
            a, np.float32)).to(dev)
        w = None if sw is None else put(sw)
        loss = float(torch.sum(glm.MULTINOMIAL.stats(
            put(yk), put(M), weights=w)[0]))
        pf = None if self.penalty_factor is None else \
            torch.from_numpy(np.asarray(self.penalty_factor, np.float32))
        pen = sum(float(glm.penalty(torch.from_numpy(self.coef_[:, k]),
                                    self.lam1, self.lam2, pf))
                  for k in range(M.shape[1]))
        return loss + pen

    def fit(self, X, y=None, *, sample_weight=None):
        X, y = _resolve_source(X, y)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        K = len(self.classes_)
        if K < 2:
            raise ValueError(f"need >= 2 classes; got {self.classes_!r}")
        yk = np.searchsorted(self.classes_, y).astype(np.int64)
        n = yk.shape[0]

        # one logistic session; y and the offset are swapped per class
        self.solver_ = GLMSolver(
            X, np.ones((n,), np.float32), family="logistic",
            config=self.config, sample_weight=sample_weight,
            standardize=self.standardize, fit_intercept=self.fit_intercept,
            penalty_factor=self.penalty_factor, device=self.device,
            **self.solver_kwargs)
        p = self.solver_._p_user

        self.coef_ = np.zeros((p, K), np.float32)
        self.intercept_ = np.zeros((K,), np.float32)
        M = np.zeros((n, K), np.float32)
        prev_obj = self._objective(yk, M, sample_weight)
        self.n_cycles_ = 0
        for cycle in range(self.max_cycles):
            for k in range(K):
                others = np.delete(M, k, axis=1)
                a_k = np.logaddexp.reduce(others, axis=1).astype(np.float32)
                y_pm = np.where(yk == k, 1.0, -1.0).astype(np.float32)
                self.solver_.set_observations(y=y_pm, offset=-a_k)
                self.solver_.fit(lam1=self.lam1, lam2=self.lam2,
                                 beta0=self.coef_[:, k],
                                 intercept0=float(self.intercept_[k]))
                self.coef_[:, k] = self.solver_.beta_
                self.intercept_[k] = self.solver_.intercept_
                M[:, k] = self.solver_.training_margins()
            self.n_cycles_ = cycle + 1
            obj = self._objective(yk, M, sample_weight)
            done = abs(prev_obj - obj) <= self.cycle_tol * max(
                abs(prev_obj), 1.0)
            prev_obj = obj
            if done:
                break
        self.objective_ = prev_obj
        return self

    # ---------------------------------------------------------- prediction

    def _check_fitted(self):
        if getattr(self, "solver_", None) is None:
            raise ValueError(f"{type(self).__name__} is not fitted yet; "
                             "call fit(X, y) first")

    def decision_function(self, X):
        """(n, K) class margins X B + b0."""
        self._check_fitted()
        cols = [self.solver_.predict(X, beta=self.coef_[:, k],
                                     intercept=float(self.intercept_[k]),
                                     kind="link")
                for k in range(self.coef_.shape[1])]
        return np.stack(cols, axis=1)

    def predict_proba(self, X):
        """(n, K) softmax probabilities, columns ordered like
        ``classes_``."""
        m = self.decision_function(X)
        return glm.MULTINOMIAL.predict(torch.from_numpy(m)).numpy()

    def predict(self, X):
        m = self.decision_function(X)
        return self.classes_[np.argmax(m, axis=1)]

    def score(self, X, y):
        """Accuracy on the original labels."""
        self._check_fitted()
        return float((self.predict(X) == np.asarray(y)).mean())


class PoissonRegressorCD(ElasticNetGLM):
    """Elastic-net Poisson regression with the log link: ``predict``
    returns expected counts, ``score`` the deviance ratio D^2 = 1 -
    dev(y, mu_hat) / dev(y, y_bar)."""

    _family = "poisson"

    def score(self, X, y, *, offset=None):
        self._check_fitted()
        y = np.asarray(y, np.float32)
        fam = glm.get_family("poisson")
        m = self.decision_function(X, offset=offset)
        yt = torch.from_numpy(y)
        dev = float(fam.deviance(yt, torch.from_numpy(np.asarray(m))))
        m0 = np.full_like(y, np.log(max(float(y.mean()), 1e-30)))
        dev0 = float(fam.deviance(yt, torch.from_numpy(m0)))
        return 1.0 - dev / max(dev0, 1e-30)
