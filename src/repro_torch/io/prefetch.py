"""A bounded background prefetch queue over any chunk callable (a copy
of ``repro.io.prefetch``: each chunk is made in an ``io/prefetch_produce``
span on the worker's own trace lane, and ``io.prefetch.queue_depth``
gauges the queue).

``StreamingDesign.iter_chunks`` already overlaps the host-to-device copy;
for a file the costly part is making the chunk (parsing text, inflating
gzip, decoding Parquet), Python work that otherwise runs in series with
the device.  ``PrefetchingSource`` moves it onto a worker thread that
walks the chunk indices in order and parks results in a bounded queue.

  * ``source(i)`` returns exactly ``chunk_fn(i)``: it is a chunk callable
    and composes with ``StreamingDesign`` unchanged;
  * the queue holds at most ``depth`` chunks, so host memory stays at
    ``depth`` chunks however slow the consumer is;
  * a request out of order (a resume at a chunk cursor, a new pass)
    stops the worker and restarts it at that index;
  * an exception of the worker is raised in the consumer at its index;
  * ``close()`` (or leaving a ``with`` block, or the finalizer) stops the
    worker.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


class PrefetchingSource:
    """Chunk callable that produces ``depth`` chunks ahead on a thread.

    Args:
      chunk_fn: the wrapped producer, a pure function of the chunk index
        (the ``data/pipeline.py`` contract — purity is what makes the
        restart-on-seek path exact).
      n_chunks: total chunks; the worker stops after the last one.
      depth: queue bound — how many produced-but-unconsumed chunks may
        exist at once (2 is classic double buffering).
    """

    def __init__(self, chunk_fn: Callable, n_chunks: int, *,
                 depth: int = 2):
        if depth <= 0:
            raise ValueError("depth must be positive")
        self._fn = chunk_fn
        self.n_chunks = int(n_chunks)
        self.depth = int(depth)
        self._q: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._next = None           # index the queue head will hold

    # ------------------------------------------------------------- worker

    def _run(self, start: int, q: queue.Queue, stop: threading.Event):
        depth_gauge = obs_metrics.gauge("io.prefetch.queue_depth")
        for i in range(start, self.n_chunks):
            if stop.is_set():
                return
            try:
                with obs_trace.span("io/prefetch_produce",
                                    args={"chunk": i}):
                    item = (i, self._fn(i), None)
            except BaseException as e:          # re-raised at the consumer
                item = (i, None, e)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    depth_gauge.set(q.qsize())
                    break
                except queue.Full:
                    continue
            if item[2] is not None:
                return

    def _restart(self, start: int):
        self._shutdown()
        self._stop = threading.Event()
        self._q = queue.Queue(maxsize=self.depth)
        self._next = start
        self._worker = threading.Thread(
            target=self._run, args=(start, self._q, self._stop),
            name="repro-torch-io-prefetch", daemon=True)
        self._worker.start()

    def _shutdown(self):
        if self._worker is not None:
            self._stop.set()
            while True:             # unblock a producer stuck on put()
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            self._worker.join()
            self._worker = None
        self._q = None
        self._next = None

    # ----------------------------------------------------------- consumer

    def __call__(self, i: int):
        if not 0 <= i < self.n_chunks:
            raise IndexError(f"chunk {i} out of range ({self.n_chunks})")
        if self._next != i or self._q is None:
            self._restart(i)        # non-sequential: reseek the stream
        got, chunk, err = self._q.get()
        self._next = i + 1 if i + 1 < self.n_chunks else None
        if err is not None:
            self._shutdown()
            raise err
        assert got == i, f"prefetch stream desync: wanted {i}, got {got}"
        return chunk

    def close(self):
        """Stop the worker and drop queued chunks (idempotent)."""
        self._shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
