"""Batched GLM scoring over a loaded artifact.

Mirrors ``repro.serve.engine``.  The engine turns an immutable
``ServableModel`` into the serving compute path:

**Active-set compaction.**  An L1-regularized model's coefficient table is
mostly zeros.  At construction the K output columns are scanned once for
their joint support A = {j : some column has beta_j != 0}; the table is
compacted to (A+1, K) with a trailing all-zero row, and a (p+1,)-entry
feature -> slot lookup maps feature ids onto it (unknown, inactive and
padding features -> the zero row, so scoring needs no predication).  Dense
rows are sliced to the active columns before the product; sparse requests
are remapped through the lookup on the host and scored by the fused
gather-dot-link kernel (``ops.predict_tile``, K7) in one launch for all K
outputs.  The table and the intercepts live on the engine's device.

**Bounded shape set.**  Sparse scoring is keyed on (batch rows, padded nnz,
kind); callers that pad to a fixed bucket grid (``serve/batcher.py``) see
each key once per bucket.  ``compile_count`` counts the distinct keys, as
the JAX engine counts its compiled programs (PyTorch runs eagerly and
compiles nothing per shape, so the count is the same bookkeeping of the
shape set).  Each new key also adds one to the ``serve.compiled_shapes``
counter of ``repro_torch.obs.metrics`` and marks a ``serve/compile``
instant in a trace, so a bucket leak shows in either.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import glm
from repro_torch.data.sparse import SparseCOO
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.artifact import ServableModel


def _as_request(r):
    """Coerce one sparse request to (idx i64, val f32) arrays; a length
    mismatch is rejected here -- numpy would otherwise broadcast a short
    value vector into every slot and score silent garbage."""
    idx, val = r
    idx = np.asarray(idx, np.int64).ravel()
    val = np.asarray(val, np.float32).ravel()
    if idx.shape != val.shape:
        raise ValueError(
            f"request feature ids and values disagree: {idx.shape} vs "
            f"{val.shape}")
    return idx, val


def coo_to_requests(X: SparseCOO):
    """Split a SparseCOO into per-row (idx, val) feature-list requests."""
    order = np.argsort(X.rows, kind="stable")
    rows, cols = X.rows[order], X.cols[order]
    vals = np.asarray(X.vals, np.float32)[order]
    starts = np.searchsorted(rows, np.arange(X.shape[0]))
    ends = np.searchsorted(rows, np.arange(X.shape[0]), side="right")
    return [(cols[s:e], vals[s:e]) for s, e in zip(starts, ends)]


class ScoringEngine:
    """Scores dense rows and sparse feature-list requests against one
    active-set-compacted weight table.

    Args:
      model: loaded ``ServableModel`` (or anything shaped like one).
      outputs: optional column subset to serve (indices into the model's K
        outputs).
      device: where the table lives and the kernel runs (None: the CUDA
        card; ``"cpu"`` runs the plain versions).
    """

    def __init__(self, model: ServableModel, *, outputs=None, device=None):
        self.model = model
        self.family = glm.resolve_family(model.family).name
        self.device = resolve_device(device)
        W = np.asarray(model.betas, np.float32)          # (K, p)
        b0 = np.asarray(model.intercepts, np.float32)    # (K,)
        if outputs is not None:
            sel = np.atleast_1d(np.asarray(outputs, np.int64))
            W, b0 = W[sel], b0[sel]
        self.n_outputs = int(W.shape[0])
        self.n_features = int(W.shape[1])

        # joint support across the served columns; slot A = the zero row
        active = np.flatnonzero(np.any(W != 0.0, axis=0))
        self.active = active
        self.n_active = int(active.size)
        table = np.zeros((self.n_active + 1, self.n_outputs), np.float32)
        table[:-1] = W[:, active].T
        self._table = torch.from_numpy(table).to(self.device)
        self._b0 = torch.from_numpy(b0.copy()).to(self.device)
        slot = np.full((self.n_features + 1,), self.n_active, np.int64)
        slot[active] = np.arange(self.n_active)
        self._slot = slot          # host lookup: feature id -> table row
        self._shapes: set = set()

    # ------------------------------------------------------------- plumbing

    @property
    def compile_count(self) -> int:
        """Distinct (shape, kind) keys of sparse scoring so far: the
        batcher's bounded-bucket contract is asserted against this."""
        return len(self._shapes)

    def _check_kind(self, kind):
        if kind not in ("link", "response"):
            raise ValueError(f"unknown kind {kind!r}; use 'link' or "
                             "'response'")

    def map_slots(self, idx: np.ndarray) -> np.ndarray:
        """Original feature ids -> compacted table rows (inactive or
        out-of-range ids -> the zero row)."""
        idx = np.asarray(idx, np.int64)
        safe = np.where((idx >= 0) & (idx < self.n_features), idx,
                        self.n_features)
        return self._slot[safe]

    def pack_requests(self, requests: Sequence, nnz_pad: Optional[int] = None):
        """Pad sparse requests to one (B, J) slot/value pair of arrays.

        ``nnz_pad``: target J (>= the largest request nnz; the batcher
        passes a bucket size so the shape set stays bounded).  Slots pad
        with the zero row, values with 0: padding scores exactly 0.
        """
        reqs = [_as_request(r) for r in requests]
        max_nnz = max((len(i) for i, _ in reqs), default=0)
        J = max(max_nnz, 1) if nnz_pad is None else int(nnz_pad)
        if max_nnz > J:
            raise ValueError(f"request nnz {max_nnz} exceeds nnz_pad {J}")
        B = len(reqs)
        slots = np.full((B, J), self.n_active, np.int32)
        vals = np.zeros((B, J), np.float32)
        for b, (idx, val) in enumerate(reqs):
            slots[b, :len(idx)] = self.map_slots(idx)
            vals[b, :len(idx)] = val
        return slots, vals

    # -------------------------------------------------------------- scoring

    def score_packed(self, slots, vals, *, kind: str = "response"):
        """Score pre-packed (B, J) slot/value arrays -> (B, K) np.float32.
        The one device launch of the sparse path; everything else routes
        here."""
        self._check_kind(kind)
        key = (tuple(slots.shape), kind)
        if key not in self._shapes:
            self._shapes.add(key)
            obs_metrics.counter("serve.compiled_shapes").inc()
            obs_trace.instant("serve/compile",
                              args={"shape": list(key[0]), "kind": kind})
        out = ops.predict_tile(
            torch.from_numpy(np.ascontiguousarray(slots, np.int32))
            .to(self.device),
            torch.from_numpy(np.ascontiguousarray(vals, np.float32))
            .to(self.device),
            self._table, self._b0, self.family, kind=kind)
        return out.cpu().numpy()

    def score_sparse(self, requests: Sequence, *, kind: str = "response",
                     nnz_pad: Optional[int] = None, offset=None):
        """Score a batch of (idx, val) feature-list requests -> (B, K).
        Without an offset the inverse link is fused into the kernel launch;
        with one, margins come back and the link applies after the
        offset."""
        self._check_kind(kind)
        slots, vals = self.pack_requests(requests, nnz_pad)
        if offset is None:
            return self.score_packed(slots, vals, kind=kind)
        return self._finish(self.score_packed(slots, vals, kind="link"),
                            kind, offset)

    def score_coo(self, X: SparseCOO, *, kind: str = "response",
                  offset=None, chunk_rows: int = 4096,
                  launch_budget: int = 1 << 22):
        """Score the rows of a SparseCOO without densifying: split into
        feature-list requests, remap to the active set, fused launches.

        Rows go in windows of at most ``chunk_rows``, each padded to its own
        largest nnz rounded up to a power of two (so repeated calls reuse
        shapes), and capped so rows x padded nnz x outputs <=
        ``launch_budget``: a near-dense row lands in a small window of its
        own instead of widening thousands of neighbours.
        """
        if X.shape[1] > self.n_features:
            raise ValueError(
                f"request has {X.shape[1]} features; model serves "
                f"{self.n_features}")
        reqs = coo_to_requests(X)
        off = None if offset is None else \
            np.asarray(offset, np.float32).reshape(-1)
        K = max(self.n_outputs, 1)

        def pow2(x):
            return 1 << max(int(x) - 1, 0).bit_length()

        outs = []
        empty = (np.zeros((0,), np.int64), np.zeros((0,), np.float32))
        s = 0
        while s < len(reqs):
            J = pow2(max(len(reqs[s][0]), 1))
            e = s + 1
            while e < len(reqs) and e - s < chunk_rows:
                J_new = max(J, pow2(max(len(reqs[e][0]), 1)))
                if (e - s + 1) * J_new * K > launch_budget:
                    break
                J = J_new
                e += 1
            n = e - s
            B = min(pow2(n), chunk_rows)
            chunk = reqs[s:e] + [empty] * (B - n)
            off_c = None
            if off is not None:
                off_c = np.zeros((B,), np.float32)
                off_c[:n] = off[s:e]
            outs.append(self.score_sparse(chunk, kind=kind, nnz_pad=J,
                                          offset=off_c)[:n])
            s = e
        if not outs:
            return np.zeros((0, self.n_outputs), np.float32)
        return np.concatenate(outs, axis=0)

    def score_dense(self, X, *, kind: str = "response", offset=None):
        """Score dense rows (n, p) -> (n, K), compacted to the active
        columns before the product (the inactive columns multiply exact
        zeros)."""
        self._check_kind(kind)
        X = np.asarray(X, np.float32)
        xa = torch.from_numpy(np.ascontiguousarray(X[:, self.active])) \
            .to(self.device)
        m = (xa @ self._table[:-1] + self._b0).cpu().numpy()
        return self._finish(m, kind, offset)

    def score(self, X, *, kind: str = "response", offset=None):
        """Polymorphic entry: SparseCOO -> fused sparse path, list of
        (idx, val) requests -> sparse path, array -> dense path."""
        if isinstance(X, SparseCOO):
            return self.score_coo(X, kind=kind, offset=offset)
        if isinstance(X, (list, tuple)):
            return self.score_sparse(X, kind=kind, offset=offset)
        return self.score_dense(X, kind=kind, offset=offset)

    def _finish(self, m: np.ndarray, kind: str, offset):
        """Apply a per-row margin offset (broadcast over outputs), then the
        inverse link when asked for responses."""
        if offset is not None:
            m = m + np.asarray(offset, np.float32).reshape(-1, 1)
        if kind == "link":
            return m
        fam = glm.resolve_family(self.family)
        return fam.predict(torch.from_numpy(np.asarray(m, np.float32))) \
            .numpy()
