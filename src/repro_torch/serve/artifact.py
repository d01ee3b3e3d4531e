"""Versioned on-disk model artifacts: the train -> export -> serve boundary.

The same format as the JAX package's ``repro.serve.artifact`` (a copy of its
numpy half), so an artifact written by either package loads in the other.
An artifact is a directory with two files:

  * ``manifest.json``: format name and schema version, family, shapes, the
    lambda grid the columns were fitted at, penalty metadata, intercepts,
    and for quantized artifacts the shared int8 scale with its error bound.
    Everything a server needs to validate and route traffic without
    touching the weight bytes.
  * ``weights.npz``: the (K, p) coefficient table, float32 or int8.

Schema rules:

  * Coefficients are stored on the original feature scale.
  * K >= 1 output columns: one fitted (beta, b0), a lambda path (one column
    per lambda) or any stack the exporter chooses; ``lambdas`` aligns with
    the columns when known.
  * int8 quantization: ONE symmetric scale amax / 127 for the whole table,
    round to nearest, so every coefficient dequantizes within scale / 2 and
    a scored margin <x, beta> within (scale / 2) ||x||_1 of the float32
    one, the bound the manifest records.
  * Loaders reject unknown format names and versions newer than they
    understand.

``load_artifact`` returns an immutable ``ServableModel`` (read-only arrays);
``serve/engine.py`` builds the scoring engine from it.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional

import numpy as np

from repro_torch.core import glm as glm_lib

FORMAT = "repro-glm-artifact"
VERSION = 1

MANIFEST = "manifest.json"
WEIGHTS = "weights.npz"

# int8 shared-scale quantization: per-element dequant error is <= scale/2
# with scale = max(amax, 1e-30)/127
_INT8_EPS = 1e-30


def quantize_int8(w: np.ndarray):
    """(q int8, scale) under ONE shared symmetric scale for the table.

    scale = max(|w|)/127 (floored at 1e-30 so all-zero tables round-trip to
    exactly zero), deterministic round-to-nearest, clip to +-127.  Dequant
    error is <= scale/2 per element.
    """
    w = np.asarray(w, np.float32)
    amax = float(np.abs(w).max()) if w.size else 0.0
    scale = max(amax, _INT8_EPS) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8(q: np.ndarray, scale: float) -> np.ndarray:
    return q.astype(np.float32) * np.float32(scale)


@dataclasses.dataclass(frozen=True)
class ServableModel:
    """An immutable, loaded artifact: everything scoring needs, nothing it
    can mutate (the arrays are read-only views)."""

    betas: np.ndarray            # (K, p) f32, ORIGINAL feature scale
    intercepts: np.ndarray       # (K,) f32
    family: str
    lambdas: Optional[np.ndarray] = None     # (K,) λ1 per column, if known
    lam2: Optional[float] = None
    penalty: Optional[dict] = None           # penalty metadata (provenance)
    standardized: bool = False
    quant: Optional[dict] = None             # {"mode","scale","amax","bound_per_l1"}
    extra: Optional[dict] = None             # frontend state (e.g. classes)
    version: int = VERSION

    def __post_init__(self):
        # freeze PRIVATE copies — never the caller's arrays, which they
        # may still legitimately mutate elsewhere
        for name in ("betas", "intercepts", "lambdas"):
            a = getattr(self, name)
            if a is not None:
                a = np.array(a)
                a.setflags(write=False)
                object.__setattr__(self, name, a)

    @property
    def n_outputs(self) -> int:
        return int(self.betas.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.betas.shape[1])

    def margin_error_bound(self, x_l1: float) -> float:
        """Worst-case |fp32 margin − dequantized margin| for a request of
        L1 mass ``x_l1``: (scale/2)·‖x‖₁ (0 for fp32 artifacts)."""
        if self.quant is None:
            return 0.0
        return 0.5 * float(self.quant["scale"]) * float(x_l1)


def _normalize_table(betas, intercepts):
    betas = np.asarray(betas, np.float32)
    if betas.ndim == 1:
        betas = betas[None, :]
    K = betas.shape[0]
    intercepts = np.zeros((K,), np.float32) if intercepts is None \
        else np.atleast_1d(np.asarray(intercepts, np.float32))
    if intercepts.shape != (K,):
        raise ValueError(
            f"intercepts must be ({K},) to match the {K} coefficient "
            f"columns; got {intercepts.shape}")
    return betas, intercepts


def save_artifact(path, *, betas, intercepts=None, family,
                  lambdas=None, lam2=None, penalty=None,
                  standardized=False, quantize=None, extra=None) -> pathlib.Path:
    """Write a versioned artifact directory; returns its path.

    ``betas`` is (p,) or (K, p) on the ORIGINAL feature scale;
    ``quantize``: None (float32) or "int8" (shared-scale table, manifest
    records the scale and the per-unit-L1 margin error bound).
    """
    fam = glm_lib.resolve_family(family)
    betas, intercepts = _normalize_table(betas, intercepts)
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)

    quant = None
    if quantize == "int8":
        q, scale = quantize_int8(betas)
        np.savez(path / WEIGHTS, betas=q)
        quant = {"mode": "int8", "scale": scale,
                 "amax": float(np.abs(betas).max()) if betas.size else 0.0,
                 # |margin_fp32 - margin_int8| <= bound_per_l1 * ||x||_1
                 "bound_per_l1": scale / 2.0}
    elif quantize is None:
        np.savez(path / WEIGHTS, betas=betas)
    else:
        raise ValueError(f"unknown quantize mode {quantize!r}; "
                         "use None or 'int8'")

    manifest = {
        "format": FORMAT,
        "version": VERSION,
        "family": fam.name,
        "n_outputs": int(betas.shape[0]),
        "n_features": int(betas.shape[1]),
        "dtype": "int8" if quant else "float32",
        "intercepts": [float(b) for b in intercepts],
        "lambdas": None if lambdas is None
        else [float(l) for l in np.atleast_1d(lambdas)],
        "lam2": None if lam2 is None else float(lam2),
        "penalty": penalty,
        "standardized": bool(standardized),
        "quant": quant,
        "extra": extra,
    }
    (path / MANIFEST).write_text(json.dumps(manifest, indent=1))
    return path


def export(model, path, *, quantize=None, path_result=None) -> pathlib.Path:
    """Export a fitted ``GLMSolver`` session or ``glm.estimators`` model.

    A session carries ``beta_``, ``intercept_`` and ``config.family``; an
    estimator ``coef_``, ``intercept_`` and ``family`` (plus ``classes_``
    for the binary families, kept in ``extra`` so a loaded classifier
    predicts the original labels) and writes its ``lam1_`` / ``lam2`` /
    ``penalty_factor`` provenance.  ``path_result`` (a ``PathResult``)
    exports the whole lambda path, one column per lambda with the grid in
    the manifest.
    """
    if hasattr(model, "coef_"):            # estimator frontend
        family = glm_lib.resolve_family(model.family).name
        beta, b0 = model.coef_, model.intercept_
        lam1 = getattr(model, "lam1_", None)
        pf = getattr(model, "penalty_factor", None)
        lam2 = getattr(model, "lam2", None)
        penalty = {"lam1": lam1, "lam2": lam2,
                   "penalty_factor": None if pf is None
                   else np.asarray(pf).tolist()}
        lambdas = None if lam1 is None else [lam1]
    elif hasattr(model, "beta_"):          # GLMSolver session
        family = model.config.family
        beta, b0 = model.beta_, model.intercept_
        lam2 = float(model.config.lam2)
        penalty = {"lam2": lam2}
        lambdas = None
    else:
        raise TypeError(
            f"cannot export {type(model).__name__}: expected a fitted "
            "GLMSolver (beta_) or estimator (coef_)")
    if beta is None:
        raise ValueError("model is not fitted; nothing to export")

    classes = getattr(model, "classes_", None)
    extra = None if classes is None \
        else {"classes": np.asarray(classes).tolist()}

    if path_result is not None:
        betas = path_result.betas
        intercepts = path_result.intercepts \
            if path_result.intercepts is not None \
            else np.zeros((len(path_result.lambdas),), np.float32)
        lambdas, lam2 = path_result.lambdas, path_result.lam2
    else:
        betas, intercepts = beta, [float(b0)]
    return save_artifact(path, betas=betas, intercepts=intercepts,
                         family=family, lambdas=lambdas, lam2=lam2,
                         penalty=penalty,
                         standardized=bool(getattr(model, "standardize",
                                                   False)),
                         quantize=quantize, extra=extra)


def load_artifact(path) -> ServableModel:
    """Load an artifact directory into an immutable ``ServableModel``.

    int8 tables are dequantized to float32 ONCE here (serving compute is
    f32; int8 buys artifact size / distribution bandwidth, and the
    manifest's recorded bound is what the dequantized margins honor).
    """
    path = pathlib.Path(path)
    mf_path = path / MANIFEST
    if not mf_path.exists():
        raise FileNotFoundError(f"no {MANIFEST} under {path}; not an "
                                "artifact directory")
    manifest = json.loads(mf_path.read_text())
    if manifest.get("format") != FORMAT:
        raise ValueError(f"unknown artifact format "
                         f"{manifest.get('format')!r} (expected {FORMAT!r})")
    if int(manifest.get("version", -1)) > VERSION:
        raise ValueError(
            f"artifact version {manifest['version']} is newer than this "
            f"loader (supports <= {VERSION}); re-export or upgrade")
    with np.load(path / WEIGHTS) as z:
        betas = z["betas"]
    quant = manifest.get("quant")
    if quant is not None:
        betas = dequantize_int8(betas, quant["scale"])
    betas = np.ascontiguousarray(betas, np.float32)
    if betas.shape != (manifest["n_outputs"], manifest["n_features"]):
        raise ValueError(
            f"weight table shape {betas.shape} does not match the manifest "
            f"({manifest['n_outputs']}, {manifest['n_features']})")
    if len(manifest["intercepts"]) != manifest["n_outputs"]:
        raise ValueError(
            f"manifest carries {len(manifest['intercepts'])} intercepts "
            f"for {manifest['n_outputs']} outputs; the artifact is corrupt")
    lambdas = manifest.get("lambdas")
    return ServableModel(
        betas=betas,
        intercepts=np.asarray(manifest["intercepts"], np.float32),
        family=manifest["family"],
        lambdas=None if lambdas is None else np.asarray(lambdas, np.float64),
        lam2=manifest.get("lam2"),
        penalty=manifest.get("penalty"),
        standardized=bool(manifest.get("standardized", False)),
        quant=quant,
        extra=manifest.get("extra"),
        version=int(manifest["version"]),
    )


def artifact_bytes(path) -> int:
    """Total on-disk size of an artifact directory."""
    path = pathlib.Path(path)
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
