"""GLM loss families on torch tensors: per-example loss and margin derivatives.

Mirrors ``repro.core.glm``.  Every loss is a function of the margin
``m = beta^T x``; the solver needs, per example,

    loss_i = c_i * l(y_i, m_i + o_i)
    s_i    = -d loss_i / dm          (negative margin gradient)
    w_i    =  d2 loss_i / dm2        (curvature, the IRLS weight)

where ``c_i`` is the observation weight (sample weight x fold mask x row
padding) and ``o_i`` a fixed margin offset.  ``GLMFamily.stats`` applies both
and clips the poisson curvature at ``POISSON_W_CLIP``.

Labels: logistic and probit take y in {-1, +1}; squared takes real y;
poisson takes counts y >= 0 with the log link; multinomial takes integer
class ids over (n, K) margins.  ``register_family`` adds a family by name.
A family without a body in the kernels (multinomial, any registered one)
runs the plain versions on every device (``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

# Effective curvature bound for the poisson family: margins above
# log(POISSON_W_CLIP) ~= 13.8 contribute at most this much curvature to the
# Gram blocks and the line-search quadratic (loss and gradient stay exact).
POISSON_W_CLIP = 1e6


@dataclasses.dataclass(frozen=True)
class GLMFamily:
    """A GLM loss family.

    ``raw_stats(y, m) -> (loss_i, s_i, w_i)`` holds the unweighted, unclipped
    formulas; ``stats`` adds offsets, the ``w_clip`` curvature clip and the
    observation weights.  ``curvature_bound`` is the paper's Appendix-B bound
    on d2l/dm2 (None when unbounded, as for poisson, which is then clipped).
    ``saturated_loss(y)`` is the per-example loss of the saturated model
    (an exact fit), which ``deviance`` subtracts; None means zero.
    """

    name: str
    raw_stats: Callable
    predict: Callable
    curvature_bound: float | None
    w_clip: float | None = None
    saturated_loss: Optional[Callable] = None

    def stats(self, y, m, weights=None, offset=None):
        if offset is not None:
            m = m + offset
        loss, s, w = self.raw_stats(y, m)
        if self.w_clip is not None:
            w = torch.clamp(w, max=self.w_clip)
        if weights is not None:
            loss = loss * weights
            s = s * weights
            w = w * weights
        return loss, s, w

    def loss(self, y, m, weights=None, offset=None):
        """Per-example (weighted) loss, the first of ``stats``."""
        return self.stats(y, m, weights=weights, offset=offset)[0]

    def deviance(self, y, m, weights=None, offset=None):
        """Total (weighted) deviance 2 sum_i w_i (l_i - l_sat,i), a 0-d
        tensor on the inputs' device."""
        loss = self.loss(y, m, weights=weights, offset=offset)
        sat = torch.zeros_like(loss) if self.saturated_loss is None \
            else self.saturated_loss(y)
        if weights is not None:
            sat = sat * weights
        return 2.0 * torch.sum(loss - sat)


def _logistic_stats(y, m):
    ym = y * m
    loss = torch.logaddexp(torch.zeros_like(ym), -ym)
    sig = torch.sigmoid(-ym)           # = 1 - p(correct)
    return loss, y * sig, sig * (1.0 - sig)


def _squared_stats(y, m):
    r = y - m
    return 0.5 * r * r, r, torch.ones_like(m)


def _probit_stats(y, m):
    # dl/dm = -y phi(t)/Phi(t) with t = y m; the inverse Mills ratio is
    # exp(log phi - log Phi), stable deep into the left tail
    t = y * m
    log_cdf = torch.special.log_ndtr(t)
    log_pdf = -0.5 * t * t - 0.5 * math.log(2.0 * math.pi)
    ratio = torch.exp(log_pdf - log_cdf)
    w = torch.clamp(ratio * (ratio + t), min=0.0)
    return -log_cdf, y * ratio, w


def _poisson_stats(y, m):
    mu = torch.exp(m)
    return mu - y * m, y - mu, mu


def _poisson_saturated(y):
    # l at the saturated fit m = log y: y - y log y (0 at y = 0)
    return torch.where(y > 0, y - y * torch.log(torch.clamp(y, min=1e-30)),
                       torch.zeros_like(y))


LOGISTIC = GLMFamily("logistic", _logistic_stats, torch.sigmoid, 0.25)
SQUARED = GLMFamily("squared", _squared_stats, lambda m: m, 1.0)
PROBIT = GLMFamily("probit", _probit_stats,
                   lambda m: torch.exp(torch.special.log_ndtr(m)), 3.0)
POISSON = GLMFamily("poisson", _poisson_stats, torch.exp, None,
                    w_clip=POISSON_W_CLIP,
                    saturated_loss=_poisson_saturated)


# ---------------------------------------------------------------------------
# multinomial (softmax) over (n, K) margins; y holds class ids 0..K-1.
#
#   s = onehot(y) - softmax(M)     (n, K)  negative gradient per class
#   w = p (1 - p)                  (n, K)  diagonal curvature, <= 1/4
#
# The class-cycling estimator (glm/estimators.py MultinomialGLM) fits class
# k as a binary logistic problem at offset a_i = log sum_{j != k} exp(M_ij),
# which has the same s_k and w_k, so the logistic superstep serves it; this
# family is the K-column objective those fits are held to.
# ---------------------------------------------------------------------------

def _multinomial_stats(y, m):
    k = m.shape[-1]
    lse = torch.logsumexp(m, dim=-1)
    p = torch.softmax(m, dim=-1)
    onehot = torch.nn.functional.one_hot(y.long(), k).to(m.dtype)
    loss = lse - torch.sum(onehot * m, dim=-1)
    return loss, onehot - p, p * (1.0 - p)


@dataclasses.dataclass(frozen=True)
class MultinomialFamily(GLMFamily):
    """Softmax family over (n, K) margins: weights are (n,) while s and w
    are (n, K), and offsets are (n, K) (per class) or (n,) (shared)."""

    def stats(self, y, m, weights=None, offset=None):
        if offset is not None:
            if offset.dim() == m.dim() - 1:
                offset = offset[..., None]
            m = m + offset
        loss, s, w = self.raw_stats(y, m)
        if self.w_clip is not None:
            w = torch.clamp(w, max=self.w_clip)
        if weights is not None:
            loss = loss * weights
            s = s * weights[..., None]
            w = w * weights[..., None]
        return loss, s, w


MULTINOMIAL = MultinomialFamily("multinomial", _multinomial_stats,
                                lambda m: torch.softmax(m, dim=-1), 0.25)

FAMILIES = {f.name: f
            for f in (LOGISTIC, SQUARED, PROBIT, POISSON, MULTINOMIAL)}


def get_family(name: str) -> GLMFamily:
    try:
        return FAMILIES[name]
    except KeyError:
        raise ValueError(
            f"unknown GLM family {name!r}; have {sorted(FAMILIES)}") from None


def register_family(family: GLMFamily) -> GLMFamily:
    """Register a custom family so it resolves by name wherever a family
    name travels (configs, artifacts, the kernels' routing)."""
    FAMILIES[family.name] = family
    return family


def resolve_family(family) -> GLMFamily:
    """Accept a ``GLMFamily`` or a registered name."""
    if isinstance(family, GLMFamily):
        return family
    return get_family(family)


def penalty(beta, lam1, lam2, penalty_factor=None):
    """Elastic net R(beta) = sum_j pf_j (lam1 |b_j| + lam2/2 b_j^2)."""
    pf = 1.0 if penalty_factor is None else penalty_factor
    return (lam1 * torch.sum(pf * torch.abs(beta))
            + 0.5 * lam2 * torch.sum(pf * beta * beta))


def negloglik(family, y, margins, weights=None, offset=None):
    fam = resolve_family(family)
    return torch.sum(fam.stats(y, margins, weights=weights, offset=offset)[0])


def objective(family, y, X, beta, lam1, lam2, *, weights=None, offset=None,
              intercept=0.0, penalty_factor=None):
    """Full f(beta) = L + R for a dense X (test and reference helper)."""
    margins = X @ beta + intercept
    return (negloglik(family, y, margins, weights=weights, offset=offset)
            + penalty(beta, lam1, lam2, penalty_factor))


def soft_threshold(x, a):
    """T(x, a) = sgn(x) max(|x| - a, 0)."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - a, min=0.0)


def margin_score(family, y, margins) -> float:
    """Goodness of fit from raw margins: accuracy for multinomial (y class
    ids, (n, K) margins) and the binary families (y in {-1, +1}), R^2 for
    squared loss, mean negative loss otherwise."""
    fam = resolve_family(family)
    y = np.asarray(y, np.float32)
    m = np.asarray(margins, np.float32)
    if fam.name == "multinomial":
        return float((np.argmax(m, axis=-1) == y.astype(np.int64)).mean())
    if fam.name in ("logistic", "probit"):
        return float(((m > 0) == (y > 0)).mean())
    if fam.name == "squared":
        ss_res = float(np.sum((y - m) ** 2))
        ss_tot = float(np.sum((y - y.mean()) ** 2))
        return 1.0 - ss_res / max(ss_tot, 1e-30)
    loss = fam.stats(torch.from_numpy(y), torch.from_numpy(m))[0].numpy()
    return float(-loss.mean())
