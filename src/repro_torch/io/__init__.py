"""repro_torch.io: from bytes on disk to ``StreamingDesign`` (mirrors
``repro.io``; it imports nothing of the JAX package).

The readers (``LibsvmReader``, ``ParquetReader``) give the chunk-callable
contract of ``data/pipeline.py``; ``FeatureHasher`` maps unbounded
vocabularies into a fixed tile-aligned feature space;
``PrefetchingSource`` makes chunks on a thread while the device works.
``open_reader`` and ``open_design`` let the solver and the estimators take
a path where they take a matrix.
"""
from __future__ import annotations

import pathlib

from repro_torch.io.hashing import FeatureHasher, expand_interactions
from repro_torch.io.libsvm import LibsvmReader, write_libsvm
from repro_torch.io.parquet import HAVE_PYARROW, ParquetReader
from repro_torch.io.prefetch import PrefetchingSource

__all__ = [
    "FeatureHasher", "expand_interactions", "LibsvmReader", "write_libsvm",
    "ParquetReader", "HAVE_PYARROW", "PrefetchingSource",
    "open_reader", "open_design", "is_reader",
]

_PARQUET_SUFFIXES = (".parquet", ".pq")


def is_reader(obj) -> bool:
    """Duck-typed reader check: anything with the reader surface
    (``chunk_fn``/``labels``/``to_design``) counts, so third-party
    sources integrate without subclassing."""
    return all(hasattr(obj, a) for a in ("chunk_fn", "labels",
                                         "to_design"))


def open_reader(path, *, chunk_rows: int = 4096, **kwargs):
    """Reader for ``path``, dispatched on suffix: ``.parquet``/``.pq`` →
    ``ParquetReader``, everything else (``.libsvm``, ``.svm``, ``.txt``,
    optionally ``.gz``-compressed) → ``LibsvmReader``."""
    p = pathlib.Path(path)
    suffixes = [s.lower() for s in p.suffixes]
    if suffixes and suffixes[-1] in _PARQUET_SUFFIXES:
        return ParquetReader(p, chunk_rows=chunk_rows, **kwargs)
    return LibsvmReader(p, chunk_rows=chunk_rows, **kwargs)


def open_design(source, *, tile_size: int, chunk_rows: int = 4096,
                hasher=None, interactions: int = 0,
                prefetch: bool = True, prefetch_chunks: int = 0,
                device=None, **reader_kwargs):
    """(StreamingDesign, labels, reader) from a path or an open reader,
    the design on ``device`` (None: the CUDA card): the coercion behind
    ``GLMSolver("train.libsvm.gz", None)``.

    ``hasher`` (libsvm sources) switches to the hashed feature space;
    ``prefetch_chunks`` deepens the background production queue.
    """
    reader = source if is_reader(source) \
        else open_reader(source, chunk_rows=chunk_rows, **reader_kwargs)
    kw = dict(prefetch=prefetch, prefetch_chunks=prefetch_chunks,
              device=device)
    if hasher is not None or interactions:
        if not hasattr(reader, "hashed_chunk_fn"):
            raise ValueError(
                f"{type(reader).__name__} does not support feature "
                "hashing; hash libsvm-style sparse sources")
        kw.update(hasher=hasher, interactions=interactions)
    design = reader.to_design(tile_size, **kw)
    return design, reader.labels(), reader
