"""Parquet reader with the chunk contract of the libsvm reader (a copy
of ``repro.io.parquet``).

A Parquet file of numeric feature columns and a label column streams into
``data/pipeline.py``'s chunk-callable contract, so ``StreamingDesign``
does not care which format made the rows.

pyarrow is optional and the gate fails closed: importing this module
always works, but a reader or writer without pyarrow raises an
``ImportError`` that names what is missing (``HAVE_PYARROW`` tells).

Reading is a buffered cursor over ``ParquetFile.iter_batches`` (host
memory stays at O(chunk_rows p)); a chunk out of order restarts the batch
stream.  ``io.prefetch.PrefetchingSource`` moves page decoding off the
consumer's thread.
"""
from __future__ import annotations

import pathlib
import threading
from typing import Optional, Sequence

import numpy as np

try:                                 # fail-closed gate: flag, not stub
    import pyarrow as _pa
    import pyarrow.parquet as _pq
    HAVE_PYARROW = True
except Exception:                    # pragma: no cover - environment gate
    _pa = _pq = None
    HAVE_PYARROW = False


def _require_pyarrow(what: str):
    if not HAVE_PYARROW:
        raise ImportError(
            f"{what} needs pyarrow, which is not installed in this "
            "environment; install pyarrow or use the libsvm reader "
            "(repro_torch.io.libsvm) instead")


def write_parquet(path, X, y, *, label_col: str = "label",
                  feature_prefix: str = "f") -> pathlib.Path:
    """Write dense (X, y) as one Parquet file with float32 feature
    columns ``f0..f{p-1}`` and a ``label`` column (test/bench helper)."""
    _require_pyarrow("write_parquet")
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32)
    cols = {f"{feature_prefix}{j}": X[:, j] for j in range(X.shape[1])}
    cols[label_col] = y
    table = _pa.table(cols)
    _pq.write_table(table, str(path))
    return pathlib.Path(path)


class ParquetReader:
    """Chunked reader over one Parquet file of numeric columns.

    Args:
      path: the Parquet file.
      feature_cols: ordered feature column names; None selects every
        numeric column except ``label_col`` in schema order.
      label_col: label column name (None for unlabeled scoring data —
        ``labels()`` then raises).
      chunk_rows: rows per chunk; the final chunk is ragged per the chunk
        contract.
    """

    def __init__(self, path, *, feature_cols: Optional[Sequence[str]] = None,
                 label_col: Optional[str] = "label",
                 chunk_rows: int = 4096):
        _require_pyarrow("ParquetReader")
        if chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")
        self.path = pathlib.Path(path)
        self.chunk_rows = int(chunk_rows)
        self.label_col = label_col
        self._pf = _pq.ParquetFile(str(self.path))
        schema = self._pf.schema_arrow
        if feature_cols is None:
            feature_cols = [
                name for name, typ in zip(schema.names, schema.types)
                if name != label_col
                and (_pa.types.is_floating(typ) or _pa.types.is_integer(typ))]
        if not feature_cols:
            raise ValueError(f"{self.path} has no numeric feature columns")
        missing = [c for c in feature_cols if c not in schema.names]
        if missing:
            raise ValueError(f"{self.path} lacks columns {missing}")
        self.feature_cols = list(feature_cols)
        self.n_features = len(self.feature_cols)
        self.n_rows = int(self._pf.metadata.num_rows)
        if self.n_rows <= 0:
            raise ValueError(f"{self.path} has no rows")
        self.n_chunks = -(-self.n_rows // self.chunk_rows)
        self._lock = threading.Lock()
        self._cursor = None          # (batch iterator, next row, leftover)

    def labels(self) -> np.ndarray:
        if self.label_col is None:
            raise ValueError("reader was built with label_col=None")
        col = self._pf.read(columns=[self.label_col])[self.label_col]
        return np.asarray(col.to_numpy(zero_copy_only=False), np.float32)

    # ------------------------------------------------------------- chunks

    def _batch_to_np(self, batch) -> np.ndarray:
        out = np.empty((batch.num_rows, self.n_features), np.float32)
        for j, name in enumerate(self.feature_cols):
            out[:, j] = batch.column(j).to_numpy(zero_copy_only=False)
        return out

    def chunk_fn(self, i: int) -> np.ndarray:
        """Dense chunk ``(rows_i, n_features)`` — the chunk contract."""
        lo = i * self.chunk_rows
        rows = min(self.chunk_rows, self.n_rows - lo)
        if rows <= 0:
            raise IndexError(f"chunk {i} out of range ({self.n_chunks})")
        with self._lock:
            if self._cursor is None or self._cursor[1] != lo:
                it = self._pf.iter_batches(batch_size=self.chunk_rows,
                                           columns=self.feature_cols)
                at, buf = 0, []
                while at < lo:       # forward skip to a resume cursor
                    b = self._batch_to_np(next(it))
                    if at + len(b) > lo:
                        buf = [b[lo - at:]]
                    at += len(b)
            else:
                it, at, buf = self._cursor
                buf = list(buf)
            have = sum(len(b) for b in buf)
            while have < rows:
                b = self._batch_to_np(next(it))
                buf.append(b)
                have += len(b)
            flat = np.concatenate(buf) if len(buf) != 1 else buf[0]
            out, rest = flat[:rows], flat[rows:]
            nxt = lo + rows
            self._cursor = None if nxt >= self.n_rows else \
                (it, nxt, [rest] if len(rest) else [])
        return np.ascontiguousarray(out)

    def to_design(self, tile_size: int, *, prefetch: bool = True,
                  prefetch_chunks: int = 0, device=None):
        """``StreamingDesign`` over this file on ``device`` (None: the
        CUDA card); the same wiring as ``LibsvmReader.to_design``."""
        from repro_torch.data.design import StreamingDesign
        fn = self.chunk_fn
        if prefetch_chunks > 0:
            from repro_torch.io.prefetch import PrefetchingSource
            fn = PrefetchingSource(fn, self.n_chunks,
                                   depth=prefetch_chunks)
        return StreamingDesign(fn, n_rows=self.n_rows,
                               n_cols=self.n_features,
                               chunk_rows=self.chunk_rows,
                               tile_size=tile_size, prefetch=prefetch,
                               device=device)
