"""Design-matrix layouts and the operators the coordinate-descent sweep uses.

Mirrors the single-device part of ``repro.data.design``.  The solver touches
the design matrix only through these operators:

  * ``tile_gram(tid, w, r)``: G = X_t^T diag(w) X_t (T, T) and g = X_t^T r
    for feature tile ``tid``;
  * ``all_tile_grams(w, r, tile_live)``: every live tile's (G, g) at once,
    (n_tiles, T, T) and (n_tiles, T), dead tiles zero (the Jacobi sweep);
  * ``tile_matvec(tid, v_t)``: X_t v_t over all rows;
  * ``matvec(v)`` / ``rmatvec(r)``: X v and X^T r in packed column order;
  * ``col_moments(w)``: the weighted column sums (sum_i w_i x_ij,
    sum_i w_i x_ij^2) that ``standardize=True`` reads;
  * ``scale_columns(scale, center)``: a new design with columns
    (x_j - center_j) scale_j (centering on the dense layout only).

Two layouts:

  * ``DenseDesign``: an (n, p_pad) tensor with zero padding columns.  Its
    tile Gram is a plain matrix product (``torch.matmul``), as the JAX
    package leaves it to XLA.  ``tiles3()`` is the tile-major
    (n_tiles, n, T) view the fused superstep reads: a strided view of the
    row-major data, not a copy (the JAX session caches a transposed copy,
    which doubles the design's memory).
  * ``BlockSparseDesign``: CSR-of-bricks.  The matrix is cut into
    (row_block x tile_size) bricks; only non-empty bricks are stored,
    tile-major, with a CSR ``tile_ptr`` over feature tiles.  The tile Gram
    is the ``tile_gram`` kernel reading the tile's bricks in place.  The CSR
    offsets stay on the host, so every slice bound is a host integer and
    the sweep never waits on the card for one.

``build_block_sparse`` packs a ``SparseCOO`` exactly as the JAX builder
does (features sorted by frequency, so hot features share tiles), computing
the layout's index arrays on the host and scattering the values straight
into bricks on the target device; the dense (n, p) matrix is never formed.

A third, out of core: ``StreamingDesign`` keeps its rows on the host (or
makes them chunk by chunk with a pure callable) and puts one
``(chunk_rows, p_pad)`` chunk at a time on the device.  Its operators are
loops over chunks; ``iter_chunks`` double-buffers the host-to-device copy
through two pinned staging buffers and a side copy stream.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.data.sparse import SparseCOO
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


class DesignMatrix:
    """Operator interface of the sweeps; ``shape`` is the padded
    ``(n_rows, n_tiles * tile_size)``."""

    tile_size: int

    @property
    def shape(self):
        raise NotImplementedError

    @property
    def n_tiles(self) -> int:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def tile_gram(self, tid: int, w, r):
        raise NotImplementedError

    def all_tile_grams(self, w, r, tile_live=None, **kw):
        """(G_all (n_tiles, T, T), g_all (n_tiles, T)) from ``tile_gram``
        of each live tile; ``tile_live`` is an optional host (n_tiles,) bool
        mask, and a dead tile costs nothing and gets G = g = 0.  ``kw`` goes
        to ``tile_gram`` (a brick design's ``precision``)."""
        nt, T = self.n_tiles, self.tile_size
        G_all = torch.zeros((nt, T, T), dtype=w.dtype, device=w.device)
        g_all = torch.zeros((nt, T), dtype=w.dtype, device=w.device)
        for tid in range(nt):
            if tile_live is None or tile_live[tid]:
                G_all[tid], g_all[tid] = self.tile_gram(tid, w, r, **kw)
        return G_all, g_all

    def tile_matvec(self, tid: int, v_t):
        raise NotImplementedError

    def matvec(self, v):
        raise NotImplementedError

    def rmatvec(self, r):
        raise NotImplementedError

    def col_moments(self, weights):
        """(sum_i w_i x_ij, sum_i w_i x_ij^2), both (n_tiles * T,) in
        packed column order."""
        raise NotImplementedError

    def scale_columns(self, scale, center=None):
        """A NEW design whose packed column j holds (x_j - center_j) *
        scale_j (center None = 0).  Only the dense layout centers (it would
        fill every empty brick); padded rows pick up -center_j, inert since
        every consumer weights rows by the observation weights (0 there)."""
        raise NotImplementedError

    def to_dense(self):
        raise NotImplementedError


@dataclasses.dataclass
class DenseDesign(DesignMatrix):
    """Feature-padded dense design: ``data`` is (n_rows, n_tiles * T)."""

    data: torch.Tensor
    tile_size: int

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def n_tiles(self) -> int:
        return self.data.shape[1] // self.tile_size

    @property
    def device(self) -> torch.device:
        return self.data.device

    def _tile(self, tid: int):
        c0 = tid * self.tile_size
        return self.data[:, c0:c0 + self.tile_size]

    def tiles3(self):
        """(n_tiles, n_rows, T) tile-major view of ``data`` (no copy): tile
        t's row i is the contiguous slice ``data[i, tT:(t+1)T]``."""
        n = self.data.shape[0]
        return self.data.view(n, self.n_tiles, self.tile_size) \
            .permute(1, 0, 2)

    def tile_gram(self, tid: int, w, r):
        Xt = self._tile(tid)
        return (Xt * w[:, None]).T @ Xt, Xt.T @ r

    def tile_matvec(self, tid: int, v_t):
        return self._tile(tid) @ v_t

    def matvec(self, v):
        return self.data @ v

    def rmatvec(self, r):
        return self.data.T @ r

    def col_moments(self, weights):
        return self.data.T @ weights, (self.data * self.data).T @ weights

    def scale_columns(self, scale, center=None):
        # one new (n, p_pad) tensor, formed in place: the caller drops the
        # old design, so at most two copies live for a moment
        data = self.data * scale[None, :] if center is None else \
            (self.data - center[None, :]).mul_(scale[None, :])
        return DenseDesign(data, self.tile_size)

    def to_dense(self):
        return self.data


@dataclasses.dataclass
class BlockSparseDesign(DesignMatrix):
    """CSR-of-bricks blocked densification of a sparse design matrix.

      bricks     (B, row_block, tile_size) f32: non-empty bricks, tile-major
      brick_row  (B,) int32: row-block index of each brick
      brick_tile (B,) int32: feature-tile index of each brick
      tile_ptr   (n_tiles + 1,) int32 numpy, on the host: bricks of tile t
                 are [tile_ptr[t], tile_ptr[t + 1])

    ``n_rows`` is a multiple of ``row_block``; ``max_bricks_per_tile`` is
    the largest tile population (K).
    """

    bricks: torch.Tensor
    brick_row: torch.Tensor
    brick_tile: torch.Tensor
    tile_ptr: np.ndarray
    tile_size: int
    row_block: int
    n_rows: int
    n_tiles_: int
    max_bricks_per_tile: int

    @property
    def shape(self):
        return (self.n_rows, self.n_tiles_ * self.tile_size)

    @property
    def n_tiles(self) -> int:
        return self.n_tiles_

    @property
    def n_row_blocks(self) -> int:
        return self.n_rows // self.row_block

    @property
    def device(self) -> torch.device:
        return self.bricks.device

    def tile_bricks(self, tid: int):
        """(bricks (K_t, rb, T), rows (K_t,)) of tile ``tid``: views into the
        brick arrays, no copy."""
        start = int(self.tile_ptr[tid])
        stop = int(self.tile_ptr[tid + 1])
        return self.bricks[start:stop], self.brick_row[start:stop]

    def tile_gram(self, tid: int, w, r, precision="fp32"):
        tb, rows = self.tile_bricks(tid)
        return ops.tile_gram(tb, rows, tb.shape[0], w, r,
                             precision=precision)

    def gather_all_tiles(self):
        """Every tile's bricks as one batched layout: (bricks3 (nt, K, rb,
        T), rows (nt, K), valid (nt, K) 0/1), K = max_bricks_per_tile.
        Slots past a tile's population hold clamped copies of in-range
        bricks with valid = 0 (the plain fused route masks them).  A copy
        of the bricks: the CUDA route reads them in place instead."""
        K = self.max_bricks_per_tile
        dev = self.device
        start = torch.from_numpy(self.tile_ptr[:-1].astype(np.int64)).to(dev)
        stop = torch.from_numpy(self.tile_ptr[1:].astype(np.int64)).to(dev)
        idx = start[:, None] + torch.arange(K, device=dev)[None, :]
        valid = (idx < stop[:, None]).to(self.bricks.dtype)
        safe = torch.clamp(idx, max=self.bricks.shape[0] - 1)
        return self.bricks[safe], self.brick_row[safe], valid

    def tile_matvec(self, tid: int, v_t):
        tb, rows = self.tile_bricks(tid)
        out = torch.zeros((self.n_row_blocks, self.row_block),
                          dtype=v_t.dtype, device=v_t.device)
        # a tile holds at most one brick per row block, so the indices are
        # distinct and the add is exact and order-free
        out.index_add_(0, rows.long(), tb @ v_t)
        return out.reshape(-1)

    def matvec(self, v):
        T = self.tile_size
        out = torch.zeros(self.n_rows, dtype=v.dtype, device=v.device)
        for tid in range(self.n_tiles_):
            out += self.tile_matvec(tid, v[tid * T:(tid + 1) * T])
        return out

    def rmatvec(self, r):
        r2 = r.reshape(self.n_row_blocks, self.row_block)
        parts = []
        for tid in range(self.n_tiles_):
            tb, rows = self.tile_bricks(tid)
            parts.append(torch.einsum("kit,ki->t", tb, r2[rows.long()]))
        return torch.cat(parts)

    def col_moments(self, weights):
        # tile by tile, as rmatvec: the squares of one tile's bricks live at
        # a time, never a second copy of all of them
        w2 = weights.reshape(self.n_row_blocks, self.row_block)
        s1, s2 = [], []
        for tid in range(self.n_tiles_):
            tb, rows = self.tile_bricks(tid)
            wk = w2[rows.long()]
            s1.append(torch.einsum("kit,ki->t", tb, wk))
            s2.append(torch.einsum("kit,ki->t", tb * tb, wk))
        return torch.cat(s1), torch.cat(s2)

    def scale_columns(self, scale, center=None):
        if center is not None:
            raise ValueError(
                "BlockSparseDesign cannot center columns (centering fills "
                "every empty brick); use scale-only standardization")
        sb = scale.reshape(self.n_tiles_, self.tile_size)[
            self.brick_tile.long()]                     # (B, T)
        return dataclasses.replace(self, bricks=self.bricks * sb[:, None, :])

    def to_dense(self):
        rb, T = self.row_block, self.tile_size
        out = torch.zeros((self.n_row_blocks, rb, self.n_tiles_, T),
                          dtype=self.bricks.dtype, device=self.device)
        # (row block, tile) pairs are unique, so assignment places each brick
        out[self.brick_row.long(), :, self.brick_tile.long(), :] = self.bricks
        return out.reshape(self.n_rows, self.n_tiles_ * T)


# ---------------------------------------------------------------------------
# out of core: row chunks
# ---------------------------------------------------------------------------


def _host_f32(a) -> np.ndarray:
    """A float32 numpy array of a tensor (any device) or array-like."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


class StreamingDesign(DesignMatrix):
    """Out-of-core row-chunked design: the rows live on the host (or are
    made on demand) and the device holds one ``(chunk_rows, p_pad)`` chunk
    at a time.

    ``chunk_fn(i)`` returns chunk ``i``'s raw rows, ``(rows_i, n_cols)``
    with ``rows_i == chunk_rows`` except possibly for the last chunk (the
    contract of ``data/pipeline.py``); it must be a pure function of ``i``,
    so a resumed fit replays the same bytes.  A chunk on the device is the
    raw rows, then the optional ones column (the intercept), then zero row
    and column padding, then ``(x - center) * scale`` when the design was
    scaled (``scale_columns``; padded rows too, inert since their
    observation weights are 0).  The centering and scaling run on the
    device after the copy: one float32 subtraction and one multiplication,
    rounded as numpy rounds them, so the chunk's bits are the reference's.

    ``iter_chunks`` on the card with ``prefetch`` (the default) fills one
    of two pinned host staging buffers with chunk i + 1 and copies it on a
    side stream while the caller's work on chunk i runs; the caller's
    stream waits on the copy's event before it reads the chunk, and the
    host waits for the last copy out of a staging buffer before it
    refills it.  ``prefetch=False`` is the serial baseline: a fresh host
    chunk and a blocking copy from pageable memory.  Every operator is a
    sum over chunks (``full_gram`` is the one the streaming solver reads).
    """

    def __init__(self, chunk_fn, *, n_rows: int, n_cols: int, chunk_rows: int,
                 tile_size: int, add_ones: bool = False, scale=None,
                 center=None, prefetch: bool = True, device=None):
        if chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")
        self._chunk_fn = chunk_fn
        self.prefetch = bool(prefetch)
        self.n_rows_data = int(n_rows)          # true (unpadded) row count
        self.n_cols_src = int(n_cols)           # raw columns of chunk_fn
        self.chunk_rows = int(chunk_rows)
        self.tile_size = int(tile_size)
        self.add_ones = bool(add_ones)
        self.p_user = self.n_cols_src + (1 if add_ones else 0)
        self.p_pad = self.p_user + ((-self.p_user) % tile_size)
        self.n_chunks = -(-self.n_rows_data // self.chunk_rows)
        self._device = resolve_device(device)
        self._scale = None if scale is None else _host_f32(scale)
        self._center = None if center is None else _host_f32(center)
        self._cols = None            # (center, scale) on the device
        self._staging = None         # two pinned (chunk_rows, p_pad) buffers
        self._staged = [None, None]  # the last copy out of each, an event
        self._copy_stream = None

    @property
    def shape(self):
        return (self.n_chunks * self.chunk_rows, self.p_pad)

    @property
    def n_tiles(self) -> int:
        return self.p_pad // self.tile_size

    @property
    def device(self) -> torch.device:
        return self._device

    def _derive(self, **kw) -> "StreamingDesign":
        args = dict(n_rows=self.n_rows_data, n_cols=self.n_cols_src,
                    chunk_rows=self.chunk_rows, tile_size=self.tile_size,
                    add_ones=self.add_ones, prefetch=self.prefetch,
                    device=self._device, scale=self._scale,
                    center=self._center)
        args.update(kw)
        return StreamingDesign(self._chunk_fn, **args)

    def with_ones_column(self) -> "StreamingDesign":
        """A new design whose chunks carry an all-ones column (the
        unpenalized intercept) before the tile padding."""
        if self.add_ones:
            raise ValueError("design already carries an intercept column")
        if self._scale is not None or self._center is not None:
            raise ValueError("append the intercept before scaling")
        return self._derive(add_ones=True)

    def scale_columns(self, scale, center=None):
        scale = _host_f32(scale)
        new_center = np.zeros((self.p_pad,), np.float32) if center is None \
            else _host_f32(center)
        old_scale = np.ones((self.p_pad,), np.float32) if self._scale is None \
            else self._scale
        old_center = np.zeros((self.p_pad,), np.float32) \
            if self._center is None else self._center
        # compose: ((x - c0) s0 - c1) s1 = (x - (c0 + c1 / s0)) (s0 s1)
        safe = np.where(old_scale != 0, old_scale, 1.0)
        return self._derive(scale=old_scale * scale,
                            center=old_center + new_center / safe)

    # -- chunk production ----------------------------------------------------

    def _raw(self, i: int):
        """(chunk ``i``'s raw rows as float32, its row count), checked
        against the contract."""
        lo = i * self.chunk_rows
        rows = min(self.chunk_rows, self.n_rows_data - lo)
        if rows <= 0:
            raise IndexError(f"chunk {i} out of range ({self.n_chunks})")
        raw = np.asarray(self._chunk_fn(i), np.float32)
        if raw.shape != (rows, self.n_cols_src):
            raise ValueError(
                f"chunk_fn({i}) returned {raw.shape}; expected "
                f"({rows}, {self.n_cols_src})")
        if not (raw.flags.c_contiguous and raw.flags.writeable):
            raw = np.array(raw)
        return raw, rows

    def _host_chunk(self, i: int):
        """A fresh (chunk_rows, p_pad) float32 host tensor of chunk ``i``:
        raw rows, the ones column, zero padding (not yet centered or
        scaled)."""
        buf = torch.zeros((self.chunk_rows, self.p_pad), dtype=torch.float32)
        self._fill(buf, i)
        return buf

    def _fill(self, buf, i: int) -> None:
        """Write host chunk ``i`` into ``buf``, whose padding columns are
        zero (a pinned staging buffer's were zeroed once and are never
        written)."""
        raw, rows = self._raw(i)
        buf[:rows, :self.n_cols_src].copy_(torch.from_numpy(raw))
        if self.add_ones:
            buf[:rows, self.n_cols_src] = 1.0
        if rows < self.chunk_rows:
            buf[rows:].zero_()

    def _transform(self, Xc):
        """``(Xc - center) * scale`` in place, on Xc's device."""
        if self._center is None and self._scale is None:
            return Xc
        if self._cols is None:
            put = lambda a: None if a is None else \
                torch.from_numpy(a).to(self._device)
            self._cols = (put(self._center), put(self._scale))
        center, scale = self._cols
        if center is not None:
            Xc.sub_(center)
        if scale is not None:
            Xc.mul_(scale)
        return Xc

    def iter_chunks(self, start: int = 0, *, prefetch: Optional[bool] = None):
        """Yield ``(i, device_chunk)`` for chunks ``[start, n_chunks)``.

        ``prefetch`` (None: the design's attribute) double-buffers the copy
        on the card; each yielded chunk is a tensor of its own, valid as
        long as the caller holds it.
        """
        prefetch = self.prefetch if prefetch is None else prefetch
        if start >= self.n_chunks:
            return
        dev = self._device
        if dev.type != "cuda" or not prefetch:
            for i in range(start, self.n_chunks):
                yield i, self._transform(self._host_chunk(i).to(dev))
            return
        if self._staging is None:
            self._staging = torch.zeros((2, self.chunk_rows, self.p_pad),
                                        dtype=torch.float32, pin_memory=True)
            self._copy_stream = torch.cuda.Stream(dev)
        compute = torch.cuda.current_stream(dev)
        copy = self._copy_stream

        def issue(i):
            b = i % 2
            if self._staged[b] is not None:
                # the copy out of this buffer must be done before the host
                # rewrites it, or the copy reads a half-written chunk
                self._staged[b].synchronize()
            self._fill(self._staging[b], i)
            with torch.cuda.stream(copy):
                dst = torch.empty((self.chunk_rows, self.p_pad),
                                  dtype=torch.float32, device=dev)
                dst.copy_(self._staging[b], non_blocking=True)
                done = torch.cuda.Event()
                done.record(copy)
            self._staged[b] = done
            return dst, done

        nxt = issue(start)
        for i in range(start, self.n_chunks):
            cur, done = nxt
            if i + 1 < self.n_chunks:
                nxt = issue(i + 1)
            compute.wait_event(done)
            # made on the copy stream, read on the caller's: its memory is
            # not handed out again before the caller's work on it is done
            cur.record_stream(compute)
            yield i, self._transform(cur)

    def row_slice(self, i: int) -> slice:
        """Row range of chunk ``i`` in the padded (n_tot,) coordinates."""
        return slice(i * self.chunk_rows, (i + 1) * self.chunk_rows)

    def process_slice(self, process_id: Optional[int] = None,
                      num_processes: Optional[int] = None):
        """The contiguous chunk range process ``process_id`` of
        ``num_processes`` owns, as a ``StreamingDesign`` of its own, and
        that range's rows as a slice in the unpadded global coordinates
        (for the caller's y, weights and offsets).  ``chunk_fn`` is a pure
        function of the global chunk index, so no data moves.  Defaults
        come from ``repro_torch.dist.bootstrap``'s context.  Returns
        ``(design, rows)``."""
        if process_id is None or num_processes is None:
            from repro_torch.dist import bootstrap as _boot
            ctx = _boot.context()
            process_id = ctx.process_id if process_id is None else process_id
            num_processes = ctx.num_processes if num_processes is None \
                else num_processes
        if not 0 <= process_id < num_processes:
            raise ValueError(
                f"process_id {process_id} out of range for "
                f"{num_processes} processes")
        if num_processes > self.n_chunks:
            raise ValueError(
                f"{num_processes} processes but only {self.n_chunks} "
                "chunks; lower chunk_rows so every process owns work")
        base, rem = divmod(self.n_chunks, num_processes)
        lo = process_id * base + min(process_id, rem)
        hi = lo + base + (1 if process_id < rem else 0)
        row_lo = lo * self.chunk_rows
        row_hi = min(hi * self.chunk_rows, self.n_rows_data)
        fn = self._chunk_fn
        design = self._derive(n_rows=row_hi - row_lo)
        design._chunk_fn = lambda j, _lo=lo: fn(_lo + j)
        return design, slice(row_lo, row_hi)

    # -- operators (sums over chunks) ----------------------------------------

    def _row_chunks(self, *vecs):
        """Zip chunks with the matching slices of row vectors, given in the
        padded (``n_chunks * chunk_rows``) or the unpadded (``n_rows_data``)
        coordinates; an unpadded vector is zero-extended, so the ragged
        last chunk's padding rows get weight and residual 0."""
        n_pad = self.n_chunks * self.chunk_rows
        placed = []
        for v in vecs:
            a = v if torch.is_tensor(v) else torch.from_numpy(_host_f32(v))
            a = a.to(self._device, torch.float32)
            if a.shape[0] == self.n_rows_data and a.shape[0] != n_pad:
                a = torch.cat([a, a.new_zeros(n_pad - a.shape[0])])
            elif a.shape[0] != n_pad:
                raise ValueError(
                    f"row vector has length {a.shape[0]}; expected the "
                    f"unpadded {self.n_rows_data} or padded {n_pad}")
            placed.append(a)
        for i, Xc in self.iter_chunks():
            sl = self.row_slice(i)
            yield Xc, tuple(a[sl] for a in placed)

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=torch.float32, device=self._device)

    def tile_gram(self, tid: int, w, r):
        T = self.tile_size
        G, g = self._zeros(T, T), self._zeros(T)
        c0 = int(tid) * T
        for Xc, (wc, rc) in self._row_chunks(w, r):
            Xt = Xc[:, c0:c0 + T]
            G += (Xt * wc[:, None]).T @ Xt
            g += Xt.T @ rc
        return G, g

    def all_tile_grams(self, w, r, tile_live=None, **kw):
        nt, T = self.n_tiles, self.tile_size
        G_all, g_all = self._zeros(nt, T, T), self._zeros(nt, T)
        for Xc, (wc, rc) in self._row_chunks(w, r):
            Xr = Xc.view(self.chunk_rows, nt, T)
            G_all += torch.einsum("nti,ntj->tij", Xr * wc[:, None, None], Xr)
            g_all += (Xc.T @ rc).view(nt, T)
        if tile_live is not None:
            dead = torch.from_numpy(~np.asarray(tile_live, bool)) \
                .to(self._device)
            G_all[dead] = 0.0
            g_all[dead] = 0.0
        return G_all, g_all

    def full_gram(self, w, r):
        """(X^T W X (p_pad, p_pad), X^T r (p_pad,)) summed over chunks: the
        statistics the streaming sweeps read (p_pad^2 on the device)."""
        p = self.p_pad
        G, g = self._zeros(p, p), self._zeros(p)
        for Xc, (wc, rc) in self._row_chunks(w, r):
            G.addmm_((Xc * wc[:, None]).T, Xc)
            g += Xc.T @ rc
        return G, g

    def tile_matvec(self, tid: int, v_t):
        T = self.tile_size
        c0 = int(tid) * T
        return torch.cat([Xc[:, c0:c0 + T] @ v_t
                          for _, Xc in self.iter_chunks()])

    def matvec(self, v):
        return torch.cat([Xc @ v for _, Xc in self.iter_chunks()])

    def rmatvec(self, r):
        out = self._zeros(self.p_pad)
        for Xc, (rc,) in self._row_chunks(r):
            out += Xc.T @ rc
        return out

    def col_moments(self, weights):
        s1, s2 = self._zeros(self.p_pad), self._zeros(self.p_pad)
        for Xc, (wc,) in self._row_chunks(weights):
            s1 += Xc.T @ wc
            s2 += (Xc * Xc).T @ wc
        return s1, s2

    def to_dense(self):
        """Every chunk at once (tests and tiny data only)."""
        return torch.cat([Xc for _, Xc in self.iter_chunks()])


# ---------------------------------------------------------------------------
# host-side builders
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DesignInfo:
    """What the solver needs to map results back to the caller's features.

    col_of_feature[j] = packed column of original feature j (None when the
    layout is the identity); ``occupancy`` is the non-empty-brick fraction.
    """
    shape: tuple
    col_of_feature: Optional[np.ndarray] = None
    occupancy: float = 1.0
    n_bricks: int = 0

    def unpack_beta(self, beta_packed: np.ndarray) -> np.ndarray:
        p = self.shape[1]
        if self.col_of_feature is None:
            return np.asarray(beta_packed)[:p]
        return np.asarray(beta_packed)[self.col_of_feature]

    def pack_beta(self, beta: np.ndarray, p_padded: int) -> np.ndarray:
        return self.pack_cols(beta, p_padded, fill=0.0)

    def pack_cols(self, values: np.ndarray, p_padded: int,
                  fill: float = 0.0) -> np.ndarray:
        """Scatter a per-feature vector into packed column order; padding
        columns get ``fill`` (0 for beta, 1 for penalty factors)."""
        out = np.full((p_padded,), fill, np.float32)
        if self.col_of_feature is None:
            out[:len(values)] = values
        else:
            out[self.col_of_feature] = values
        return out


def _pack_layout(coo: SparseCOO, M: int, tile_size: int, reorder: bool):
    """Global column layout: frequency-sort features into tiles, then deal
    whole tiles round-robin over M feature shards (M = 1 on one device).

    Returns (col_of_feature (p,), p_loc)."""
    p = coo.shape[1]
    p_pad = p + ((-p) % (M * tile_size))
    p_loc = p_pad // M
    freq = coo.col_frequency_order() if reorder else np.arange(p)
    # freq[c] = original feature at frequency rank c
    rank_of = np.empty(p, np.int64)
    rank_of[freq] = np.arange(p)
    ranks = np.arange(p_pad, dtype=np.int64)
    tile_g = ranks // tile_size
    pos = (tile_g % M) * p_loc + (tile_g // M) * tile_size + ranks % tile_size
    col_of_feature = pos[rank_of]
    return col_of_feature.astype(np.int64), p_loc


def _brick_index(rows, cols, n_loc, p_loc, tile_size, row_block):
    """Index arrays of the brick packing of one shard's COO triplets.

    Returns (order, brick_of_nnz, brick_row, brick_tile, tile_ptr, n_bricks):
    the nonzero ``order[i]`` goes to brick ``brick_of_nnz[i]`` at (row %
    row_block, col % tile_size) of the sorted triplets.
    """
    n_rb = n_loc // row_block
    n_tiles = p_loc // tile_size
    key = (cols // tile_size).astype(np.int64) * n_rb + rows // row_block
    order = np.argsort(key, kind="stable")
    ukeys, inv = np.unique(key[order], return_inverse=True)
    brick_tile = (ukeys // n_rb).astype(np.int32)
    brick_row = (ukeys % n_rb).astype(np.int32)
    if not len(ukeys):
        brick_tile = np.zeros((1,), np.int32)
        brick_row = np.zeros((1,), np.int32)
    tile_ptr = np.searchsorted(brick_tile, np.arange(n_tiles + 1)) \
        .astype(np.int32)
    if not len(ukeys):
        tile_ptr[:] = 0
    return order, inv, brick_row, brick_tile, tile_ptr, len(ukeys)


def build_block_sparse(coo: SparseCOO, tile_size: int, *,
                       row_block: int = 256, reorder: bool = True,
                       device=None):
    """Pack a host SparseCOO into the brick layout on ``device`` (None:
    the CUDA card).

    Returns (BlockSparseDesign, DesignInfo).  The packing (column order,
    brick order, CSR offsets) is the JAX builder's, so beta can be compared
    index by index.
    """
    coo = coo.dedupe()
    n, p = coo.shape
    col_of_feature, p_loc = _pack_layout(coo, 1, tile_size, reorder)
    n_loc = -(-n // row_block) * row_block
    n_tiles = p_loc // tile_size
    rows = np.asarray(coo.rows, np.int64)
    cols = col_of_feature[coo.cols]
    order, inv, brick_row, brick_tile, tile_ptr, n_bricks = _brick_index(
        rows, cols, n_loc, p_loc, tile_size, row_block)
    device = resolve_device(device)
    bricks = torch.zeros((max(n_bricks, 1), row_block, tile_size),
                         dtype=torch.float32, device=device)
    if n_bricks:
        rows, cols = rows[order], cols[order]

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        bricks.index_put_(
            (put(inv.astype(np.int64)), put(rows % row_block),
             put(cols % tile_size)),
            put(np.asarray(coo.vals, np.float32)[order]))
    K = max(int(np.diff(tile_ptr).max(initial=0)), 1)
    design = BlockSparseDesign(
        bricks, torch.from_numpy(brick_row).to(device),
        torch.from_numpy(brick_tile).to(device), tile_ptr,
        tile_size, row_block, n_loc, n_tiles, K)
    occ = n_bricks / max((n_loc // row_block) * n_tiles, 1)
    info = DesignInfo(shape=(n, p), col_of_feature=col_of_feature,
                      occupancy=occ, n_bricks=n_bricks)
    return design, info


def _place_bricks(vals, rows, cols, index, n_loc, n_tiles, tile_size,
                  row_block, K, device) -> BlockSparseDesign:
    """The ``BlockSparseDesign`` of one shard's triplets (local row and
    packed column coordinates) and their ``_brick_index``, on ``device``."""
    order, inv, brick_row, brick_tile, tile_ptr, n_bricks = index
    bricks = torch.zeros((max(n_bricks, 1), row_block, tile_size),
                         dtype=torch.float32, device=device)
    if n_bricks:
        rows, cols = rows[order], cols[order]

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        bricks.index_put_(
            (put(inv.astype(np.int64)), put(rows % row_block),
             put(cols % tile_size)),
            put(np.asarray(vals, np.float32)[order]))
    return BlockSparseDesign(
        bricks, torch.from_numpy(brick_row).to(device),
        torch.from_numpy(brick_tile).to(device), tile_ptr,
        tile_size, row_block, n_loc, n_tiles, K)


@dataclasses.dataclass
class ShardedBlockSparse:
    """The (D, M)-sharded brick layout: shard (d, m) holds rows [d n_rows,
    (d + 1) n_rows) and packed columns [m p_loc, (m + 1) p_loc) as a
    ``BlockSparseDesign`` of its own (``shards``, only those that were
    built).  ``n_bricks`` (B) and ``max_bricks_per_tile`` (K) are the
    largest over all shards, the reference's static bounds; ``stacked()``
    gives the reference's padded (D, M, ...) arrays of built shards."""

    D: int
    M: int
    tile_size: int
    row_block: int
    n_rows: int                 # rows a shard (a row_block multiple)
    n_tiles: int                # tiles a shard
    max_bricks_per_tile: int
    n_bricks: int
    uniform_K: bool
    shards: dict
    leading: int = 2

    @property
    def shape(self):
        """A shard's (n_rows, p_loc), as the reference's design reports."""
        return (self.n_rows, self.n_tiles * self.tile_size)

    def shard(self, d: int, m: int) -> BlockSparseDesign:
        if (d, m) not in self.shards:
            raise ValueError(f"shard ({d}, {m}) was not built here")
        return self.shards[(d, m)]

    def stacked(self) -> dict:
        """Host (D, M, ...) arrays padded to B bricks as the reference
        stacks them (every shard must have been built)."""
        B = self.n_bricks
        out = {"bricks": [], "brick_row": [], "brick_tile": [],
               "tile_ptr": []}
        for d in range(self.D):
            for m in range(self.M):
                sh = self.shard(d, m)
                for k in ("bricks", "brick_row", "brick_tile"):
                    a = getattr(sh, k).cpu().numpy()
                    pad = B - a.shape[0]
                    if pad:
                        a = np.concatenate(
                            [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                    out[k].append(a)
                out["tile_ptr"].append(np.asarray(sh.tile_ptr))
        return {k: np.stack(v).reshape((self.D, self.M) + v[0].shape)
                for k, v in out.items()}


def build_block_sparse_sharded(coo: SparseCOO, *, D: int, M: int,
                               tile_size: int, row_block: int = 256,
                               reorder: bool = True, shards=None,
                               device=None):
    """Pack a host SparseCOO into the (D, M)-sharded brick layout.

    The reference's packing: features frequency-sorted into tiles, whole
    tiles dealt round-robin over the M feature shards, rows padded to D
    shards of a ``row_block`` multiple.  Only the shards in ``shards``
    (a list of (d, m); None: all) get bricks, on ``device`` (None: the
    CUDA card), so a rank builds its own block; the index arithmetic of
    every shard runs on the host, since B and K are bounds over all of
    them.  Returns (ShardedBlockSparse, DesignInfo).
    """
    coo = coo.dedupe()
    n, p = coo.shape
    col_of_feature, p_loc = _pack_layout(coo, M, tile_size, reorder)
    n_loc = -(-n // (D * row_block)) * row_block
    n_tiles = p_loc // tile_size
    rows_all = np.asarray(coo.rows, np.int64)
    packed = col_of_feature[coo.cols]
    shard_m = packed // p_loc
    shard_d = rows_all // n_loc
    want = None if shards is None else {tuple(s) for s in shards}
    device = resolve_device(device) if want is None or want else None
    index, parts = {}, {}
    for d in range(D):
        for m in range(M):
            sel = (shard_d == d) & (shard_m == m)
            rows = rows_all[sel] - d * n_loc
            cols = packed[sel] - m * p_loc
            index[(d, m)] = _brick_index(rows, cols, n_loc, p_loc,
                                         tile_size, row_block)
            if want is None or (d, m) in want:
                parts[(d, m)] = (np.asarray(coo.vals)[sel], rows, cols)
    counts = [ix[5] for ix in index.values()]
    B = max(max(c, 1) for c in counts)
    K = max(max(int(np.diff(ix[4]).max(initial=0)) for ix in index.values()),
            1)
    uniform = all(ix[5] == n_tiles * K and np.all(np.diff(ix[4]) == K)
                  for ix in index.values())
    built = {dm: _place_bricks(*parts[dm], index[dm], n_loc, n_tiles,
                               tile_size, row_block, K, device)
             for dm in parts}
    design = ShardedBlockSparse(D, M, tile_size, row_block, n_loc, n_tiles,
                                K, B, uniform, built)
    total = sum(counts)
    occ = total / max((n_loc // row_block) * D * n_tiles * M, 1)
    info = DesignInfo(shape=(n, p), col_of_feature=col_of_feature,
                      occupancy=occ, n_bricks=total)
    return design, info


def brick_occupancy(coo: SparseCOO, tile_size: int, *, row_block: int = 256,
                    reorder: bool = True) -> float:
    """Non-empty-brick fraction of the packed layout, from the COO keys
    alone (no brick is formed)."""
    coo = coo.dedupe()
    col_of_feature, p_loc = _pack_layout(coo, 1, tile_size, reorder)
    n_rb = -(-coo.shape[0] // row_block)
    n_tiles = p_loc // tile_size
    keys = (col_of_feature[coo.cols] // tile_size) * n_rb \
        + np.asarray(coo.rows, np.int64) // row_block
    return len(np.unique(keys)) / max(n_rb * n_tiles, 1)


def as_local_design(X, tile_size: int, *, device=None) -> DesignMatrix:
    """This rank's design: a ``ShardedBlockSparse`` holding one shard
    gives it, a design is itself, a raw (n_loc, p_loc) array becomes a
    ``DenseDesign`` on ``device`` (None: the CUDA card)."""
    if isinstance(X, ShardedBlockSparse):
        if len(X.shards) != 1:
            raise ValueError(f"{len(X.shards)} shards built; a rank holds "
                             "one (build with shards=[(d, m)])")
        return next(iter(X.shards.values()))
    if isinstance(X, DesignMatrix):
        return X
    if torch.is_tensor(X):
        return DenseDesign(X.to(resolve_device(device), torch.float32),
                           tile_size)
    return dense_design(X, tile_size, device=device)[0]


def dense_design(X, tile_size: int, *, device=None):
    """(DenseDesign, DesignInfo) from an (n, p) array; features are padded
    with zero columns to a tile multiple on the device itself (None: the
    CUDA card)."""
    device = resolve_device(device)
    X = np.asarray(X, np.float32)
    n, p = X.shape
    data = torch.zeros((n, p + (-p) % tile_size), dtype=torch.float32,
                       device=device)
    data[:, :p] = torch.from_numpy(X).to(device)
    return DenseDesign(data, tile_size), DesignInfo(shape=(n, p))


def streaming_design(X, tile_size: int, *, chunk_rows: int,
                     n_rows: Optional[int] = None,
                     n_cols: Optional[int] = None, device=None):
    """(StreamingDesign, DesignInfo) from an (n, p) host array or a chunk
    callable, for ``device`` (None: the CUDA card).

    An array is sliced per chunk (no host copy beyond the staging buffer).
    A callable ``X(i)`` returns chunk ``i``'s raw rows, a pure function of
    ``i``, and needs ``n_rows`` and ``n_cols``.  The column layout is the
    identity (tile padding trails), so beta needs no column map.
    """
    if isinstance(X, SparseCOO):
        raise ValueError(
            "StreamingDesign chunks are dense device buffers; stream a "
            "sparse source by passing a callable that densifies chunk i")
    if callable(X) and not hasattr(X, "shape"):
        if n_rows is None or n_cols is None:
            raise ValueError(
                "callable chunk sources need explicit n_rows/n_cols")
        design = StreamingDesign(X, n_rows=n_rows, n_cols=n_cols,
                                 chunk_rows=chunk_rows, tile_size=tile_size,
                                 device=device)
        return design, DesignInfo(shape=(n_rows, n_cols))
    Xh = np.asarray(X, np.float32)
    n, p = Xh.shape
    design = StreamingDesign(
        lambda i, _X=Xh, _cr=chunk_rows: _X[i * _cr:(i + 1) * _cr],
        n_rows=n, n_cols=p, chunk_rows=chunk_rows, tile_size=tile_size,
        device=device)
    return design, DesignInfo(shape=(n, p))


def as_design(X, tile_size: int, *, row_block: int = 256,
              reorder: bool = True, info: Optional[DesignInfo] = None,
              device=None):
    """Coerce a dense array, a SparseCOO or a pre-built design into
    (DesignMatrix, DesignInfo) on ``device`` (None: the CUDA card).  A
    pre-built design must come with the DesignInfo of its builder, which
    maps beta back to feature order; a StreamingDesign's info is rebuilt
    from the design itself."""
    device = resolve_device(device)
    if isinstance(X, StreamingDesign):
        if X.tile_size != tile_size:
            raise ValueError(
                f"StreamingDesign was built with tile_size={X.tile_size} "
                f"but the config says {tile_size}; the column padding is a "
                "function of the tile size, so build the design with the "
                "session's tile_size")
        if X.device.type != device.type:
            raise ValueError(f"design lives on {X.device}, not {device}")
        # the identity layout makes the info canonical, so it is always
        # rebuilt: a caller's info may predate with_ones_column (the
        # intercept), and honoring its shape would take the last real
        # feature for the intercept
        return X, DesignInfo(shape=(X.n_rows_data, X.p_user))
    if isinstance(X, DesignMatrix):
        if info is None:
            raise ValueError(
                "pre-built designs require the DesignInfo returned by their "
                "builder (pass design_info=...) so beta can be mapped back "
                "to the original feature order")
        if X.tile_size != tile_size:
            raise ValueError(f"design tile_size {X.tile_size} != {tile_size}")
        if X.device.type != device.type:
            raise ValueError(f"design lives on {X.device}, not {device}")
        return X, info
    if isinstance(X, SparseCOO):
        return build_block_sparse(X, tile_size, row_block=row_block,
                                  reorder=reorder, device=device)
    return dense_design(X, tile_size, device=device)
