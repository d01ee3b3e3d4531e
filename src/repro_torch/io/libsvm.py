"""Chunked libsvm/svmlight reader and writer (a copy of
``repro.io.libsvm``, with its ``io/parse_chunk`` span and
``io.chunk_cache.hit``/``miss`` counters).

The libsvm text format (``label idx:val idx:val ...``, a row a line,
optionally gzip-compressed) is how the paper's sparse datasets arrive.
The reader turns such a file into the chunk-callable contract of
``data/pipeline.py`` without holding the matrix:

  * the scan (one pass) counts rows, the largest feature index and row
    nnz, keeps the labels and, for a plain file, the byte offset of every
    chunk, so ``chunk(i)`` is one seek.  A gzip stream cannot seek: chunks
    read in order follow one cursor, and a jump back reopens the file and
    skips forward (only a resume does that);
  * with ``n_rows`` and ``n_features`` given there is no scan (one pass,
    as from a pipe); ``labels()`` scans on first use.

Chunks come as fixed-shape padded sparse ``(cols, vals)`` pairs
(``chunk``, ``cols < 0`` marks padding; the hasher's input) or dense rows
(``chunk_fn``, ``hashed_chunk_fn``).  ``to_design`` makes a
``StreamingDesign`` (optionally behind ``io/prefetch.py``'s thread) and
``to_coo`` a whole-file ``SparseCOO`` for in-memory fits.
"""
from __future__ import annotations

import gzip
import pathlib
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

from repro_torch.data.sparse import SparseCOO
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


def _open(path, mode="rt"):
    path = pathlib.Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, mode)
    return open(path, mode)


def parse_line(line: str):
    """(label, idx int64[], val f32[]) for one libsvm line; None for blank
    or comment lines.  ``qid:...`` ranking annotations are skipped."""
    hash_pos = line.find("#")
    if hash_pos >= 0:
        line = line[:hash_pos]
    parts = line.split()
    if not parts:
        return None
    label = float(parts[0])
    idx, vals = [], []
    for tok in parts[1:]:
        k, _, v = tok.partition(":")
        if k == "qid":
            continue
        idx.append(int(k))
        vals.append(float(v))
    return label, np.asarray(idx, np.int64), np.asarray(vals, np.float32)


def write_libsvm(path, X, y, *, zero_based: bool = True,
                 precision: int = 9) -> pathlib.Path:
    """Write (X, y) as libsvm text; gzip when ``path`` ends in ``.gz``.

    ``X`` is a ``SparseCOO`` or a dense array (zeros are dropped).
    ``zero_based=False`` writes 1-based feature indices (the classic
    libsvm convention; the reader auto-detects either).  The default
    ``precision`` of 9 significant digits round-trips float32 EXACTLY
    (%.9g), which is what the file-vs-memory parity tests lean on; drop
    to 7 for smaller files when bit-exactness does not matter."""
    path = pathlib.Path(path)
    if isinstance(X, SparseCOO):
        coo = X.dedupe()
        n = coo.shape[0]
        order = np.lexsort((coo.cols, coo.rows))
        rows, cols, vals = coo.rows[order], coo.cols[order], coo.vals[order]
        starts = np.searchsorted(rows, np.arange(n + 1))
    else:
        Xd = np.asarray(X, np.float32)
        n = Xd.shape[0]
    y = np.asarray(y)
    off = 0 if zero_based else 1
    fmt = f"%d:%.{precision}g"
    with _open(path, "wt") as f:
        for i in range(n):
            if isinstance(X, SparseCOO):
                lo, hi = starts[i], starts[i + 1]
                feats = " ".join(fmt % (cols[j] + off, vals[j])
                                 for j in range(lo, hi))
            else:
                nz = np.nonzero(Xd[i])[0]
                feats = " ".join(fmt % (j + off, Xd[i, j]) for j in nz)
            f.write(f"%.{precision}g {feats}\n" % y[i]
                    if feats else f"%.{precision}g\n" % y[i])
    return path


class LibsvmReader:
    """Chunked reader over one libsvm(.gz) file.

    Args:
      path: the file; ``.gz`` suffix switches to the gzip codec.
      chunk_rows: rows per chunk (the last chunk is ragged — the chunk
        contract).
      n_rows / n_features / max_nnz: supply ALL of ``n_rows`` +
        ``n_features`` to skip the scan (single-pass mode; ``labels()``
        then triggers a lazy scan on first use).  ``n_features`` also acts
        as a cap: exact-feature chunks raise on indices beyond it (a
        hashed pipeline never hits this — it hashes raw indices).
      zero_based: index convention; None auto-detects from the scan
        (min index 0 → zero-based; pure single-pass mode defaults to
        zero-based).
      cache_chunks: retain up to this many PARSED chunks (the padded
        (cols, vals) triplet form, far smaller than the dense chunk) in
        an LRU, so the solver's repeated passes — two per superstep,
        every superstep — skip the gzip + text parse after the first
        epoch.  Host memory stays bounded at roughly
        ``cache_chunks × chunk_rows × max_nnz × 12`` bytes; 0 (default)
        reparses every pass (the strict out-of-core mode).
    """

    def __init__(self, path, *, chunk_rows: int = 4096,
                 n_rows: Optional[int] = None,
                 n_features: Optional[int] = None,
                 max_nnz: Optional[int] = None,
                 zero_based: Optional[bool] = None,
                 cache_chunks: int = 0):
        self.path = pathlib.Path(path)
        if chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")
        self.chunk_rows = int(chunk_rows)
        self._zero_based = zero_based
        self._labels: Optional[np.ndarray] = None
        self._offsets: Optional[np.ndarray] = None  # plain files only
        self._gz = self.path.suffix == ".gz"
        self._cursor = None          # (open handle, next row index)
        self._lock = threading.Lock()
        self.cache_chunks = int(cache_chunks)
        self._cache: "OrderedDict" = OrderedDict()
        if n_rows is None or n_features is None:
            self._scan()
            if n_features is not None:
                if self.n_features > n_features:
                    raise ValueError(
                        f"{self.path} has features up to "
                        f"{self.n_features - 1}; cap n_features="
                        f"{n_features} is too small")
                self.n_features = int(n_features)
            if n_rows is not None and n_rows != self.n_rows:
                raise ValueError(
                    f"{self.path} has {self.n_rows} rows, not {n_rows}")
            if max_nnz is not None:
                self.max_nnz = max(int(max_nnz), self.max_nnz)
        else:
            self.n_rows = int(n_rows)
            self.n_features = int(n_features)
            self.max_nnz = 0 if max_nnz is None else int(max_nnz)
            if self._zero_based is None:
                self._zero_based = True
        if self.n_rows <= 0:
            raise ValueError(f"{self.path} has no data rows")
        self.n_chunks = -(-self.n_rows // self.chunk_rows)

    # ------------------------------------------------------------ pass 1

    def _scan(self):
        """One sequential pass: row count, label vector, max feature
        index, max nnz, and (plain files) chunk-boundary byte offsets."""
        labels, offsets = [], []
        max_idx, min_idx, max_nnz = -1, None, 0
        with _open(self.path, "rt") as f:
            while True:
                if not self._gz and len(labels) % self.chunk_rows == 0:
                    offsets.append(f.tell())
                line = f.readline()
                if not line:
                    break
                parsed = parse_line(line)
                if parsed is None:
                    continue
                label, idx, _ = parsed
                labels.append(label)
                if len(idx):
                    max_idx = max(max_idx, int(idx.max()))
                    lo = int(idx.min())
                    min_idx = lo if min_idx is None else min(min_idx, lo)
                    max_nnz = max(max_nnz, len(idx))
        if self._zero_based is None:
            self._zero_based = (min_idx == 0) if min_idx is not None \
                else True
        self.n_rows = len(labels)
        shift = 0 if self._zero_based else 1
        self.n_features = max(max_idx + 1 - shift, 1)
        self.max_nnz = max(max_nnz, 1)
        self._labels = np.asarray(labels, np.float32)
        if not self._gz:
            self._offsets = np.asarray(
                offsets[:-(-self.n_rows // self.chunk_rows)], np.int64) \
                if labels else np.zeros((0,), np.int64)

    def labels(self) -> np.ndarray:
        """(n_rows,) float32 label vector (lazy scan in single-pass
        mode)."""
        if self._labels is None:
            keep = (self.n_rows, self.n_features, self.max_nnz)
            self._scan()
            self.n_rows, self.n_features, self.max_nnz = keep
        return self._labels

    # ---------------------------------------------------------- raw rows

    def _read_lines(self, i: int):
        """The parsed rows of chunk ``i`` — O(1) seek on plain files,
        sequential cursor (restart on backward jumps) on gzip."""
        lo = i * self.chunk_rows
        rows = min(self.chunk_rows, self.n_rows - lo)
        if rows <= 0:
            raise IndexError(f"chunk {i} out of range ({self.n_chunks})")
        out = []
        with self._lock:
            if self._offsets is not None and i < len(self._offsets):
                f = _open(self.path, "rt")
                f.seek(int(self._offsets[i]))
                at = lo
            else:
                if self._cursor is not None and self._cursor[1] == lo:
                    f, at = self._cursor
                else:
                    if self._cursor is not None:
                        self._cursor[0].close()
                    f, at = _open(self.path, "rt"), 0
                while at < lo:                    # forward skip
                    if parse_line(f.readline()) is not None:
                        at += 1
            while len(out) < rows:
                parsed = parse_line(f.readline())
                if parsed is not None:
                    out.append(parsed)
                    at += 1
            if self._offsets is not None:
                f.close()
            else:
                self._cursor = [f, at] if at < self.n_rows else None
                if at >= self.n_rows:
                    f.close()
        return out

    def chunk(self, i: int):
        """Fixed-shape padded sparse chunk ``i``: ``(cols, vals)`` of
        shape ``(rows_i, max_nnz)`` with ``cols < 0`` marking padding —
        raw (unshifted-to-cap) indices, the hashing input layout.

        With ``cache_chunks > 0`` parsed chunks are served from a bounded
        LRU (copy-free: callers never mutate them), so only the first
        epoch pays the decompress+parse cost."""
        if self.cache_chunks > 0:
            with self._lock:
                hit = self._cache.get(i)
                if hit is not None:
                    self._cache.move_to_end(i)
                    obs_metrics.counter("io.chunk_cache.hit").inc()
                    return hit
            obs_metrics.counter("io.chunk_cache.miss").inc()
        with obs_trace.span("io/parse_chunk", args={"chunk": i}):
            lines = self._read_lines(i)
            width = max(self.max_nnz, max((len(ix) for _, ix, _ in lines),
                                          default=1), 1)
            cols = np.full((len(lines), width), -1, np.int64)
            vals = np.zeros((len(lines), width), np.float32)
            shift = 0 if self._zero_based else 1
            for r, (_, idx, v) in enumerate(lines):
                cols[r, :len(idx)] = idx - shift
                vals[r, :len(idx)] = v
        if self.cache_chunks > 0:
            with self._lock:
                self._cache[i] = (cols, vals)
                self._cache.move_to_end(i)
                while len(self._cache) > self.cache_chunks:
                    self._cache.popitem(last=False)
        return cols, vals

    def chunk_fn(self, i: int) -> np.ndarray:
        """Dense exact-feature chunk ``(rows_i, n_features)`` — the chunk
        contract for vocabulary-bounded data."""
        cols, vals = self.chunk(i)
        out = np.zeros((cols.shape[0], self.n_features), np.float32)
        r, c = np.nonzero(cols >= 0)
        if len(r):
            j = cols[r, c]
            if j.max(initial=-1) >= self.n_features:
                raise ValueError(
                    f"chunk {i} has feature index {int(j.max())} beyond "
                    f"the n_features={self.n_features} cap; raise the cap "
                    "or hash the features (io.hashing)")
            np.add.at(out, (r, j), vals[r, c])
        return out

    def hashed_chunk_fn(self, hasher, *, interactions: int = 0):
        """Chunk callable in the hashed feature space
        ``(rows_i, hasher.n_features)`` — unbounded vocabularies stream
        into a fixed layout, optionally with on-the-fly crosses."""
        def fn(i: int, _r=self, _h=hasher, _k=int(interactions)):
            cols, vals = _r.chunk(i)
            return _h.transform_chunk(cols, vals, interactions=_k)
        return fn

    # ------------------------------------------------------- integrations

    def to_coo(self) -> SparseCOO:
        """Whole-file SparseCOO (exact features) — the in-memory parity
        baseline; only call on data that fits in host memory."""
        rows, cols, vals = [], [], []
        for i in range(self.n_chunks):
            c, v = self.chunk(i)
            r, j = np.nonzero(c >= 0)
            rows.append(r + i * self.chunk_rows)
            cols.append(c[r, j])
            vals.append(v[r, j])
        return SparseCOO(np.concatenate(rows), np.concatenate(cols),
                         np.concatenate(vals).astype(np.float32),
                         (self.n_rows, self.n_features)).dedupe()

    def to_design(self, tile_size: int, *, hasher=None,
                  interactions: int = 0, prefetch: bool = True,
                  prefetch_chunks: int = 0, device=None):
        """``StreamingDesign`` over this file on ``device`` (None: the CUDA
        card).

        ``hasher`` switches to the hashed feature space (+ optional
        interaction crosses); ``prefetch_chunks > 0`` wraps the chunk
        callable in ``io.prefetch.PrefetchingSource`` so chunk parsing
        runs in a background thread that deep; ``prefetch`` controls the
        design's own host-to-device double buffering.
        """
        from repro_torch.data.design import StreamingDesign
        if hasher is not None:
            fn = self.hashed_chunk_fn(hasher, interactions=interactions)
            n_cols = hasher.n_features
        else:
            fn, n_cols = self.chunk_fn, self.n_features
        if prefetch_chunks > 0:
            from repro_torch.io.prefetch import PrefetchingSource
            fn = PrefetchingSource(fn, self.n_chunks,
                                   depth=prefetch_chunks)
        return StreamingDesign(fn, n_rows=self.n_rows, n_cols=n_cols,
                               chunk_rows=self.chunk_rows,
                               tile_size=tile_size, prefetch=prefetch,
                               device=device)
