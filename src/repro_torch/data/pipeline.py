"""The chunk-callable contract of out-of-core designs and the LM
template's token stream (copies of ``repro.data.pipeline``'s
``validate_chunk_callable`` and ``TokenPipeline``; numpy only).

Every loader of row chunks is a pure function of its index, so a restarted
fit replays the exact byte stream without saving any data state:

  * ``chunk_fn(i) -> array (rows_i, n_cols)`` returns chunk ``i``'s RAW
    rows for ``i in [0, ceil(n_rows / chunk_rows))``;
  * ``rows_i == chunk_rows`` for every chunk but possibly the LAST, which
    is ragged: ``n_rows - (n_chunks - 1) * chunk_rows`` rows (never zero,
    never padded by the producer);
  * calling ``chunk_fn`` twice, in any order, gives bit-identical rows;
  * zero padding is the consumer's job: ``StreamingDesign`` pads the ragged
    last chunk and the tile columns, and every consumer weights rows by the
    observation weights, which are 0 on padded rows.

``StreamingDesign`` consumes this contract and every reader of
``repro_torch.io`` produces it; ``validate_chunk_callable`` checks a
producer against it.

``TokenPipeline.batch_at(step)`` is the LM trainer's deterministic batch
stream, a pure function of (seed, step) as well, so a resumed run reads
the same batches; its batches equal the reference's bit for bit.
"""
from __future__ import annotations

import numpy as np


def validate_chunk_callable(chunk_fn, *, n_rows: int, n_cols: int,
                            chunk_rows: int, check_chunks: int = 3,
                            check_purity: bool = True) -> dict:
    """Check a chunk producer against the contract.

    Checks the first ``check_chunks`` chunks and always the last (possibly
    ragged) one: shape ``(rows_i, n_cols)``, finite float values and, with
    ``check_purity``, bit-identical rows from a second call.  Returns
    ``{"n_chunks", "last_rows", "checked"}``; raises ``ValueError`` on a
    violation.
    """
    if chunk_rows <= 0 or n_rows <= 0 or n_cols <= 0:
        raise ValueError(
            f"need positive n_rows/n_cols/chunk_rows; got "
            f"({n_rows}, {n_cols}, {chunk_rows})")
    n_chunks = -(-n_rows // chunk_rows)
    last_rows = n_rows - (n_chunks - 1) * chunk_rows
    idx = sorted(set(range(min(check_chunks, n_chunks))) | {n_chunks - 1})
    for i in idx:
        want_rows = chunk_rows if i < n_chunks - 1 else last_rows
        raw = np.asarray(chunk_fn(i), np.float32)
        if raw.shape != (want_rows, n_cols):
            raise ValueError(
                f"chunk_fn({i}) returned shape {raw.shape}; the contract "
                f"says ({want_rows}, {n_cols})"
                + (" — the final chunk must be RAGGED, not padded "
                   "(padding is the consumer's job so padded-row weights "
                   "can be forced to 0)" if i == n_chunks - 1 else ""))
        if not np.isfinite(raw).all():
            raise ValueError(f"chunk_fn({i}) contains non-finite values")
        if check_purity:
            again = np.asarray(chunk_fn(i), np.float32)
            if raw.shape != again.shape or not (raw == again).all():
                raise ValueError(
                    f"chunk_fn({i}) is not a pure function of i: two "
                    "calls returned different rows (resume replay "
                    "requires bit-identical replays)")
    return {"n_chunks": n_chunks, "last_rows": int(last_rows),
            "checked": idx}


class TokenPipeline:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed

    def batch_at(self, step: int):
        """Global batch for ``step``: dict(tokens, targets, loss_mask) of
        numpy arrays (int32, int32, float32; (batch, seq_len) each)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        V = self.vocab_size
        B, S = self.batch, self.seq_len
        # zipf-ish unigrams
        base = (rng.pareto(1.2, size=(B, S + 1)).astype(np.int64)
                * (V / 64)).astype(np.int64) % V
        # learnable bigram structure: x_{t+1} = (3 x_t + 7) mod V on a
        # motif mask
        motif = rng.random((B, S + 1)) < 0.5
        seq = base.copy()
        for t in range(1, S + 1):
            nxt = (3 * seq[:, t - 1] + 7) % V
            seq[:, t] = np.where(motif[:, t], nxt, seq[:, t])
        tokens = seq[:, :-1].astype(np.int32)
        targets = seq[:, 1:].astype(np.int32)
        mask = np.ones((B, S), np.float32)
        return {"tokens": tokens, "targets": targets, "loss_mask": mask}
