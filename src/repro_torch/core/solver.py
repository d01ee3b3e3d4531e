"""GLMSolver: a fitting session on one device or a (data x model) mesh of
processes (mirrors ``repro.core.solver``).

    solver = GLMSolver(X, y, family="logistic", sample_weight=w, offset=o,
                       standardize=True, fit_intercept=True,
                       penalty_factor=pf)
    res  = solver.fit(lam1=0.05 * solver.lambda_max())   # one (lam1, lam2)
    path = solver.fit_path(n_lambdas=100)                 # warm-started path
    cv   = solver.fit_cv(n_folds=5)                       # mask-based K-fold
    yhat = solver.predict(X_test)

Construction packs the design once (a dense array becomes a ``DenseDesign``,
a ``SparseCOO`` the CSR-of-bricks ``BlockSparseDesign``) and moves it with
the observation model to the device: ``device=None`` means the CUDA card;
the CPU runs only when the caller passes ``device="cpu"``, and there is no
silent fall back to it.  On the card the solver turns TF32 off for matrix
products and cuDNN, since TF32 sums would miss the 1e-5 bar on beta.

The observation model: per-example ``sample_weight`` (the loss becomes
sum_i c_i l_i; padded rows weigh 0), margin ``offset``, an unpenalized
``fit_intercept`` column (penalty factor 0), per-feature
``penalty_factor`` and ``standardize`` (weighted variance-1 columns from
the design's ``col_moments``, centered too on a dense layout with an
intercept; beta comes back on the original scale).  ``lambda_max`` is the
smallest lam1 with every penalized coordinate at zero, taken at the null
model (intercept fitted); the module-level ``lambda_max`` takes it at zero
margins over raw inputs.

``fit_path`` warm-starts each lambda of a decreasing grid from the last,
freezes the coordinates the sequential strong rule screens out (a tile
with none active is skipped: ``launch_stats``) and re-admits any that
fail the KKT test on the full gradient X^T s.  ``fit_cv`` runs such paths
on fold-masked observation weights over the full-data grid and selects
lambda by mean validation deviance.

``fit(ckpt_manager=)`` saves (beta, X beta, mu) every ``ckpt_every``
supersteps and ``fit_path(ckpt_manager=)`` the warm state and the results
so far after every lambda (``repro_torch.checkpoint``, the JAX package's
format); a later call with a manager that holds a checkpoint resumes from
it, a brick or streaming layout only onto the same layout.

A ``StreamingDesign`` (``data/design.py``), a file path or a reader
(``repro_torch.io``; ``GLMSolver("train.libsvm", None)`` takes the labels
from the file) makes an out-of-core session: the rows stay on the host and
each superstep is two double-buffered passes over fixed-size row chunks
(``dglmnet.make_streaming_superstep``), with the Gram-mode sweep between
them.  The margins X beta are never kept: every pass, gradient check and
deviance makes them again chunk by chunk.  Its checkpoints hold (beta, mu)
at a superstep's end and, with ``fit(ckpt_every_chunks=k)``, also the
first pass's partial sums (G, g0, L) and the chunk to go on from every k
chunks, so a fit cut mid-pass resumes at that chunk.  The whole
observation model, ``fit_path`` and ``fit_cv`` run on it unchanged.

``coupling="jacobi"`` runs the fused Jacobi superstep (two fused launches,
``fuse_superstep=True``, the default) or its unfused form; the fused one
takes ``precision="bf16"`` (bfloat16 Gram and margin inputs).  ``predict``
on a SparseCOO goes through the serving engine (``serve/engine.py``) and
its fused gather-dot-link kernel; ``save`` writes a serving artifact (one
column, or one per lambda of a ``PathResult``).

Observability (``repro_torch.obs``): each superstep's dispatch runs in a
``solver/superstep`` span (a streaming one in its three pass spans), and
a convergence stream, opened next to the trace shards when tracing
targets a directory or attached by ``set_convergence_stream``, gets one
event a superstep from the host scalars its one device-to-host read
fetched.  Neither adds a synchronization.

``mesh=`` (a ``torch.distributed`` ``DeviceMesh`` with dims ``axis_data``
and ``axis_model``, ``repro_torch.dist.bootstrap.make_dist_mesh``) makes
the session one rank of the reference's sharded fit: every process builds
the session with the same full host inputs and keeps its own block (rows
of its data shard, packed columns of its feature shard; a SparseCOO packs
only this rank's bricks), and each superstep reduces over the mesh's
process groups (``core/dglmnet.py``).  Host decisions (the stop test, the
strong rule and KKT masks) are taken from process 0's values, broadcast,
so no rank leaves a loop that another stays in.  ALB budgets come from
``config.alb`` with ``speeds``/``seed`` or from runtime ``telemetry``
(``repro_torch.dist.telemetry``), optionally under a ``fault_plan``
(``repro_torch.dist.faults``).  Checkpoints hold the gathered full beta and
margins; the coordinator alone writes them, and a dense fit resumes on
another mesh.  A StreamingDesign or a file takes no mesh
(``launch/dist_run.py --data`` gives each process its own chunk range).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import dglmnet, glm
from repro_torch.core.dglmnet import DGLMNETConfig, FitResult, FitState
from repro_torch.data import design as design_lib
from repro_torch.data.design import (DesignMatrix, ShardedBlockSparse,
                                     StreamingDesign)
from repro_torch.data.sparse import SparseCOO
from repro_torch.device import resolve_device
from repro_torch.dist import bootstrap as dist_boot
from repro_torch.kernels import ops
from repro_torch.sharding import collectives
from repro_torch.obs import convergence as conv_lib
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import artifact
from repro_torch.serve.artifact import ServableModel
from repro_torch.serve.engine import ScoringEngine

_HISTORY_KEYS = ("f", "alpha", "mu", "nnz", "accepted_unit")
_PF_EPS = 1e-12          # pf below this counts as "unpenalized"
_SIGMA_EPS = 1e-7        # columns with weighted std below this are not scaled


def _put(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def lambda_max(X, y, family="logistic", *, sample_weight=None, offset=None,
               penalty_factor=None, device=None) -> float:
    """Smallest lam1 for which beta = 0 solves the elastic-net GLM problem:
    max_j |[X^T s(0)]_j| / pf_j over penalized j, with s(0) the (weighted)
    negative margin gradient at zero margins plus offsets.  Over raw inputs
    (a dense array or a SparseCOO), on ``device`` (None: the CUDA card);
    sessions use ``GLMSolver.lambda_max``, taken at the null model."""
    fam = glm.resolve_family(family)
    dev = resolve_device(device)
    y = np.asarray(y, np.float32)
    n = y.shape[0]
    w = None if sample_weight is None else _put(sample_weight, dev)
    o = None if offset is None else _put(offset, dev)
    _, s0, _ = fam.stats(_put(y, dev), torch.zeros((n,), device=dev),
                         weights=w, offset=o)
    if isinstance(X, SparseCOO):
        # float32 products summed in float64, as SparseCOO.rmatvec does
        rows = torch.from_numpy(np.asarray(X.rows, np.int64)).to(dev)
        cols = torch.from_numpy(np.asarray(X.cols, np.int64)).to(dev)
        prod = _put(X.vals, dev) * s0[rows]
        g = torch.zeros((X.shape[1],), dtype=torch.float64, device=dev) \
            .index_add_(0, cols, prod.double()).float()
    else:
        g = _put(X, dev).T @ s0
    g = np.abs(g.cpu().numpy())
    if penalty_factor is not None:
        pf = np.asarray(penalty_factor, np.float32)
        pen = pf > _PF_EPS
        if not pen.any():
            raise ValueError("lambda_max undefined: no penalized features")
        g = g[pen] / pf[pen]
    return float(g.max())


class PathResult(NamedTuple):
    lambdas: np.ndarray     # (K,) lam1 grid in fit order (decreasing)
    lam2: float             # shared ridge weight
    betas: np.ndarray       # (K, p) solutions, original feature order/scale
    f: np.ndarray           # (K,) final objective per lambda
    nnz: np.ndarray         # (K,) int: support size per lambda
    n_iters: np.ndarray     # (K,) supersteps spent per lambda
    converged: np.ndarray   # (K,) bool
    intercepts: Optional[np.ndarray] = None   # (K,) when fit_intercept

    def beta_at(self, lam1: float) -> np.ndarray:
        """Solution at the grid point closest to ``lam1``."""
        return self.betas[int(np.abs(self.lambdas - lam1).argmin())]


class CVResult(NamedTuple):
    lambdas: np.ndarray       # (K,) shared lam1 grid (decreasing)
    lam2: float
    dev_folds: np.ndarray     # (n_folds, K) mean validation deviance
    dev_mean: np.ndarray      # (K,) across folds
    dev_se: np.ndarray        # (K,) standard error across folds
    best_index: int           # argmin of dev_mean
    lam_best: float           # lambdas[best_index]
    path: PathResult          # full-data path over the same grid (the refit)
    beta: np.ndarray          # full-data solution at lam_best
    intercept: float


def _with_intercept_column(X, n: int):
    """Append the all-ones intercept column to a raw host input (a
    StreamingDesign makes its chunks on demand, so it takes one too)."""
    if isinstance(X, StreamingDesign):
        return X.with_ones_column()
    if isinstance(X, SparseCOO):
        p = X.shape[1]
        rows = np.concatenate([X.rows,
                               np.arange(n, dtype=np.asarray(X.rows).dtype)])
        cols = np.concatenate([X.cols, np.full((n,), p,
                                               np.asarray(X.cols).dtype)])
        vals = np.concatenate([np.asarray(X.vals, np.float32),
                               np.ones((n,), np.float32)])
        return SparseCOO(rows, cols, vals, (n, p + 1))
    if isinstance(X, DesignMatrix):
        raise ValueError(
            "fit_intercept=True needs a raw input (dense array or "
            "SparseCOO): the intercept column is appended before packing")
    X = np.asarray(X, np.float32)
    return np.concatenate([X, np.ones((X.shape[0], 1), np.float32)], axis=1)


class GLMSolver:
    """Reusable solver session over one (X, y), on one device or as one
    rank of a mesh."""

    def __init__(self, X, y, *, family=None,
                 config: Optional[DGLMNETConfig] = None, device=None,
                 mesh=None, axis_data: Optional[str] = "data",
                 axis_model: str = "model", speeds=None, seed: int = 0,
                 row_block: int = 256, reorder: bool = True,
                 design_info=None, sample_weight=None, offset=None,
                 standardize: bool = False, fit_intercept: bool = False,
                 penalty_factor=None, telemetry=None, fault_plan=None):
        config = DGLMNETConfig() if config is None else config
        if family is not None:
            fam = glm.resolve_family(family)
            if fam.name != config.family:
                config = dataclasses.replace(config, family=fam.name)
        glm.get_family(config.family)
        self.config = config
        self.device = resolve_device(device)
        self.fit_intercept = bool(fit_intercept)
        self.standardize = bool(standardize)
        self.beta_: Optional[np.ndarray] = None
        self.intercept_: float = 0.0
        self._state: Optional[FitState] = None
        self._lmax: Optional[float] = None
        self._serve_cache = None
        # host bookkeeping of the sweeps: tiles swept, and tiles skipped
        # because screening froze every coordinate of them
        self.launch_stats = {"supersteps": 0, "sweep_tile_launches": 0,
                             "sweep_tiles_skipped": 0}
        self._phase_fractions = None    # set_phase_fractions
        # the mesh: this rank's block (d, m) of a (D, M) grid, its groups
        # (None on one device, or for a mesh dim of one rank), and which
        # process owns which model column
        if mesh is not None and not hasattr(mesh, "get_group"):
            raise TypeError(
                f"mesh must be a torch.distributed DeviceMesh with dims "
                f"({axis_data!r}, {axis_model!r}) "
                "(repro_torch.dist.bootstrap.make_dist_mesh); got "
                f"{type(mesh).__name__}")
        self.mesh = mesh
        self.axis_data = axis_data if mesh is not None else None
        self.axis_model = axis_model if mesh is not None else None
        self._rng = np.random.default_rng(seed)
        self._multiproc = mesh is not None and \
            dist_boot.is_multiprocess_mesh(mesh)
        if mesh is None:
            self._D = self._M = 1
            self._d = self._m = 0
            self._groups = None
            self.dist_info = None
        else:
            self._D, self._M, self._d, self._m = dist_boot.mesh_coords(
                mesh, axis_data, axis_model)
            self._groups = (mesh.get_group(axis_data) if axis_data
                            else None, mesh.get_group(axis_model))
            ctx = dist_boot.context()
            self.dist_info = {
                "multiprocess": self._multiproc,
                "process_id": ctx.process_id,
                "num_processes": ctx.num_processes,
                "column_owner": dist_boot.column_process_map(
                    mesh, axis_model).tolist(),
                "local_columns": dist_boot.local_columns(mesh, axis_model),
            }
        self._telemetry = telemetry
        self._faults = fault_plan
        self._superstep_no = 0
        self._budgets_host: Optional[np.ndarray] = None
        if telemetry is not None and mesh is None:
            raise ValueError(
                "telemetry-driven ALB needs a mesh: node speeds map onto "
                "model columns (repro_torch.dist.telemetry)")
        if fault_plan is not None and self.dist_info is not None and \
                fault_plan.num_processes != self.dist_info["num_processes"]:
            raise ValueError(
                f"fault plan covers {fault_plan.num_processes} processes "
                f"but the job has {self.dist_info['num_processes']}")
        # the convergence event stream: opened next to the trace shards
        # when tracing targets a directory, or set_convergence_stream()
        self._conv = None
        self._conv_step = 0
        self._conv_ctx: dict = {}
        self._last_step_us = None
        self._last_phase_us = None
        td = obs_trace.trace_dir()
        if td is not None:
            self._conv = conv_lib.ConvergenceStream(
                td / f"convergence_{obs_trace.get_tracer().pid}.jsonl")

        # a path or an open reader becomes a StreamingDesign, and y=None
        # takes the labels from the same source
        self._reader = None
        if isinstance(X, (str, os.PathLike)) or (
                not hasattr(X, "shape") and hasattr(X, "to_design")
                and hasattr(X, "labels")):
            if mesh is not None:
                raise ValueError(
                    "file-backed fits stream through a single-process "
                    "StreamingDesign (mesh=None); for multi-process "
                    "out-of-core training use launch/dist_run.py --data, "
                    "which gives each process its own chunk range")
            from repro_torch import io as io_lib
            X, labels, self._reader = io_lib.open_design(
                X, tile_size=config.tile_size, device=self.device)
            if y is None:
                y = labels
        if y is None:
            raise ValueError("y=None needs a path or a reader that supplies "
                             "its own labels")

        y = np.asarray(y, np.float32)
        n = y.shape[0]
        self._n_user = n
        T = config.tile_size
        sw = np.ones((n,), np.float32) if sample_weight is None else \
            np.asarray(sample_weight, np.float32)
        off = np.zeros((n,), np.float32) if offset is None else \
            np.asarray(offset, np.float32)
        if sw.shape != (n,) or off.shape != (n,):
            raise ValueError(
                f"sample_weight/offset must be ({n},); got {sw.shape} / "
                f"{off.shape}")
        if (sw < 0).any():
            raise ValueError("sample_weight must be nonnegative")
        if self.fit_intercept:
            X = _with_intercept_column(X, n)

        # no other reference to the design: standardization replaces it.
        # The layout is what a checkpoint must match to resume here (the
        # reference's keys); a dense layout is mesh-invariant (None).
        if mesh is None:
            self._Xs, self._info = design_lib.as_design(
                X, T, row_block=row_block, reorder=reorder,
                info=design_info, device=self.device)
            self._streaming = isinstance(self._Xs, StreamingDesign)
            if self._streaming:
                self._design_layout = {"kind": "streaming", "tile": T,
                                       "chunk_rows": self._Xs.chunk_rows}
            elif isinstance(self._Xs, design_lib.DenseDesign):
                self._design_layout = None
            else:
                self._design_layout = {
                    "kind": "bricks", "D": 1, "M": 1, "tile": T,
                    "row_block": self._Xs.row_block,
                    "reorder": bool(reorder)}
        else:
            self._streaming = False
            self._place_on_mesh(X, n, row_block, reorder, design_info)
        n_loc, p_loc = self._Xs.shape
        self._n_tot, self._p_tot = self._D * n_loc, self._M * p_loc
        n_rows = self._n_tot
        # this rank's rows and packed columns in the full coordinates
        self._rows = slice(self._d * n_loc, (self._d + 1) * n_loc)
        self._cols = slice(self._m * p_loc, (self._m + 1) * p_loc)
        self._n_tiles = self._Xs.n_tiles          # this rank's tiles

        self._ys = self._put_rows(np.pad(y, (0, n_rows - n),
                                         constant_values=1.0))
        self._wobs_host = np.pad(sw, (0, n_rows - n))      # padding -> 0
        self._wobs = self._put_rows(self._wobs_host)
        self._offsets = self._put_rows(np.pad(off, (0, n_rows - n)))

        self._p_model = self._info.shape[1]      # columns incl. intercept
        self._p_user = self._p_model - (1 if self.fit_intercept else 0)
        pf = np.ones((self._p_user,), np.float32) if penalty_factor is None \
            else np.asarray(penalty_factor, np.float32)
        if pf.shape != (self._p_user,):
            raise ValueError(
                f"penalty_factor must be ({self._p_user},); got {pf.shape}")
        if (pf < 0).any():
            raise ValueError("penalty_factor must be nonnegative")
        if self.fit_intercept:
            pf = np.concatenate([pf, np.zeros((1,), np.float32)])
        # padding columns keep pf = 1 so they stay pinned at zero
        self._penf_host = self._info.pack_cols(pf, self._p_tot, fill=1.0)
        self._penf = self._put_cols(self._penf_host)

        # ALB budgets (paper Section 7), on a mesh only, in precedence
        # order: runtime telemetry (measured node speeds), the speeds
        # simulation (config.alb with speeds= and seed=), or a full cycle
        # for every column (BSP)
        from repro_torch.core import alb as alb_lib
        self._base_speeds = None
        self._max_budget = self._n_tiles
        if mesh is not None and (telemetry is not None or config.alb):
            self._max_budget = int(alb_lib.max_budget(self._n_tiles))
            if telemetry is None:
                self._base_speeds = np.asarray(speeds, np.float32) \
                    if speeds is not None else np.ones((self._M,), np.float32)
        if self._streaming:
            self._superstep = dglmnet.make_streaming_superstep(
                config, n_tiles=self._n_tiles, device=self.device)
        else:
            self._superstep = dglmnet.make_superstep(
                config, n_tiles=self._n_tiles, device=self.device,
                groups=self._groups, max_budget=self._max_budget)

        # standardization: after packing, before anything reads the design
        self._scale_packed: Optional[np.ndarray] = None
        self._center_packed: Optional[np.ndarray] = None
        if self.standardize:
            self._apply_standardization()

    def _place_on_mesh(self, X, n: int, row_block: int, reorder: bool,
                       design_info):
        """This rank's block of the design on a mesh, its DesignInfo and
        the layout record.  A SparseCOO packs the reference's sharded brick
        layout (columns dealt over the M shards, rows padded to D row-block
        multiples) and only this rank's bricks; a dense array is padded to
        D rows and M T features and sliced."""
        T = self.config.tile_size
        D, M, d, m = self._D, self._M, self._d, self._m
        if isinstance(X, StreamingDesign):
            raise ValueError(
                "StreamingDesign is a single-process out-of-core layout; it "
                "cannot be mesh-sharded (mesh=None). Shard rows by giving "
                "each process its own chunk range instead")
        if isinstance(X, (SparseCOO, ShardedBlockSparse)):
            if isinstance(X, SparseCOO):
                sharded, info = design_lib.build_block_sparse_sharded(
                    X, D=D, M=M, tile_size=T, row_block=row_block,
                    reorder=reorder, shards=[(d, m)], device=self.device)
            else:
                if (X.D, X.M, X.tile_size) != (D, M, T):
                    raise ValueError(
                        f"pre-built ShardedBlockSparse is ({X.D}, {X.M}) "
                        f"with tile {X.tile_size}; the mesh is ({D}, {M}) "
                        f"with tile {T}")
                if design_info is None:
                    raise ValueError(
                        "pre-built ShardedBlockSparse requires the "
                        "DesignInfo returned by build_block_sparse_sharded "
                        "(pass design_info=...); the brick layout reorders "
                        "columns and beta must be unpacked with it")
                sharded, info = X, design_info
            self._Xs = sharded.shard(d, m)
            if self._Xs.device.type != self.device.type:
                raise ValueError(f"design lives on {self._Xs.device}, not "
                                 f"{self.device}")
            self._design_layout = {
                "kind": "bricks", "D": D, "M": M, "tile": T,
                "row_block": sharded.row_block, "reorder": bool(reorder)}
        elif isinstance(X, DesignMatrix):
            raise ValueError(
                "a mesh takes a dense array, a SparseCOO or a "
                "ShardedBlockSparse; a single-device design cannot be "
                "sharded")
        else:
            X = np.asarray(X, np.float32)
            p = X.shape[1]
            info = design_lib.DesignInfo(shape=(n, p))
            n_loc = (n + (-n) % D) // D
            p_loc = (p + (-p) % (M * T)) // M
            block = np.zeros((n_loc, p_loc), np.float32)
            rows = X[d * n_loc:(d + 1) * n_loc, m * p_loc:(m + 1) * p_loc]
            block[:rows.shape[0], :rows.shape[1]] = rows
            self._Xs = design_lib.DenseDesign(
                torch.from_numpy(block).to(self.device), T)
            self._design_layout = None     # the dense layout is mesh-free
        self._info = info

    @property
    def info(self):
        return self._info

    @property
    def design(self) -> DesignMatrix:
        """This rank's design (the whole design on one device)."""
        return self._Xs

    # ------------------------------------------------------------ packing

    def _icol(self) -> int:
        """Packed column of the intercept."""
        if self._info.col_of_feature is None:
            return self._p_user
        return int(self._info.col_of_feature[self._p_user])

    def _put(self, a) -> torch.Tensor:
        return _put(a, self.device)

    def _put_rows(self, a) -> torch.Tensor:
        """This rank's rows of a full (n_tot,) host vector, on the device."""
        return _put(np.asarray(a)[self._rows], self.device)

    def _put_cols(self, a) -> torch.Tensor:
        """This rank's packed columns of a full (p_tot,) host vector."""
        return _put(np.asarray(a)[self._cols], self.device)

    def _reduce_data(self, x):
        """Sum over the row shards (the data group), in place."""
        return x if self._groups is None else \
            collectives.all_reduce(x, self._groups[0])

    def _host_beta(self, beta) -> np.ndarray:
        """The full packed beta on the host (gathered over the feature
        shards on a mesh: a collective)."""
        if self._groups is None:
            return beta.cpu().numpy()
        return dist_boot.gather_to_host(beta, self._groups[1])

    def _host_rows(self, v) -> np.ndarray:
        """A full (n_tot,) row vector on the host (gathered over the row
        shards on a mesh: a collective)."""
        if self._groups is None:
            return v.cpu().numpy()
        return dist_boot.gather_to_host(v, self._groups[0])

    def _agree(self, a) -> np.ndarray:
        """Process 0's copy of a host array on every process of a mesh:
        a decision every rank must take alike (stop, screening, KKT)."""
        return a if self.mesh is None else dist_boot.broadcast_host(a)

    # ---------------------------------------------------- standardization

    def _apply_standardization(self):
        """Rescale (on a dense layout with an intercept, also center) the
        design to weighted variance 1 per column; keep the packed (scale,
        center) that maps fitted coefficients back to the original scale.
        The intercept column stays the exact ones column."""
        s1, s2 = self._col_moments()
        wsum = float(self._wobs_host.sum())
        if wsum <= 0:
            raise ValueError("standardize=True needs positive total weight")
        mu = s1 / wsum
        var = np.maximum(s2 / wsum - mu * mu, 0.0)
        sigma = np.sqrt(var)
        scale = np.where(sigma > _SIGMA_EPS, 1.0 / np.maximum(sigma, 1e-30),
                         1.0).astype(np.float32)
        # brick layouts are scale-only: centering would fill every brick
        # (a streaming design's chunks are dense)
        centered = self.fit_intercept and isinstance(
            self._Xs, (design_lib.DenseDesign, StreamingDesign))
        center = mu.astype(np.float32) if centered else np.zeros_like(scale)
        if self.fit_intercept:
            scale[self._icol()] = 1.0
            center[self._icol()] = 0.0
        self._Xs = self._Xs.scale_columns(
            self._put_cols(scale),
            self._put_cols(center) if centered else None)
        self._scale_packed = scale
        self._center_packed = center

    def _col_moments(self):
        """(sum_i w_i x_ij, sum_i w_i x_ij^2), packed order, on the host:
        summed over the row shards and gathered over the feature shards on
        a mesh."""
        s1, s2 = self._Xs.col_moments(self._wobs)
        if self._groups is None:
            return s1.cpu().numpy(), s2.cpu().numpy()
        s1, s2 = collectives.all_reduce_many((s1, s2), self._groups[0])
        return self._host_beta(s1), self._host_beta(s2)

    def _unpack_user(self, beta_packed: np.ndarray):
        """Packed (standardized-scale) beta -> (original-scale beta in
        feature order (p_user,), intercept).  Inverse of ``_pack_user``."""
        b = np.asarray(beta_packed, np.float32)
        corr = 0.0
        if self._scale_packed is not None:
            b = b * self._scale_packed
            corr = float(np.dot(self._center_packed, b))
        unpacked = self._info.unpack_beta(b)
        if self.fit_intercept:
            return unpacked[:self._p_user], float(unpacked[-1]) - corr
        return unpacked, 0.0

    def _pack_user(self, beta_user, intercept: float = 0.0) -> np.ndarray:
        beta_user = np.asarray(beta_user, np.float32)
        if beta_user.shape != (self._p_user,):
            raise ValueError(
                f"beta0 must be ({self._p_user},); got {beta_user.shape}")
        full = np.concatenate([beta_user, np.zeros((1,), np.float32)]) \
            if self.fit_intercept else beta_user
        packed = self._info.pack_beta(full, self._p_tot)
        corr = 0.0
        if self._scale_packed is not None:
            corr = float(np.dot(self._center_packed, packed))
            packed = packed / self._scale_packed
        if self.fit_intercept:
            packed[self._icol()] = float(intercept) + corr
        return packed

    # ---------------------------------------------------------- outer loop

    def _init_state(self, beta0=None, intercept0: float = 0.0) -> FitState:
        dev = self.device
        if self._streaming:
            # the margins are made again chunk by chunk in every pass: the
            # state's margin slot is an empty placeholder
            packed = np.zeros(self._p_tot, np.float32) if beta0 is None \
                else self._pack_user(beta0, intercept0)
            beta = torch.from_numpy(packed).to(dev)
            xb = torch.zeros(0, dtype=torch.float32, device=dev)
        elif beta0 is not None:
            beta = self._put_cols(self._pack_user(beta0, intercept0))
            xb = self._matvec(beta)
        else:
            beta = torch.zeros(self._Xs.shape[1], dtype=torch.float32,
                               device=dev)
            xb = torch.zeros(self._Xs.shape[0], dtype=torch.float32,
                             device=dev)
        mu = torch.full((), self.config.mu_init, dtype=torch.float32,
                        device=dev)
        return FitState(beta=beta, xb=xb, mu=mu, cursor=0, step=0)

    def _matvec(self, beta):
        """X beta over this rank's rows: its block's product, summed over
        the feature shards on a mesh."""
        xb = self._Xs.matvec(beta)
        return xb if self._groups is None else \
            collectives.all_reduce(xb, self._groups[1])

    def _check_layout(self, md):
        if md.get("design_layout") != self._design_layout:
            raise ValueError(
                f"checkpoint design layout {md.get('design_layout')} does "
                f"not match this fit's {self._design_layout}; the brick "
                "packing depends on the mesh/tiling, so blocked-sparse "
                "checkpoints resume only onto the same "
                "(D, M, tile, row_block) layout")

    @staticmethod
    def _adapt(a, width: int):
        """A checkpointed vector (or stack of them) at this session's padded
        ``width``: only a dense layout reaches here with another width (a
        mesh pads it otherwise), and there real entries lead and padding
        trails on both sides, so truncating or zero-extending is exact."""
        if a.shape[-1] == width:
            return a
        out = a.new_zeros(a.shape[:-1] + (width,)) if torch.is_tensor(a) \
            else np.zeros(a.shape[:-1] + (width,), np.float32)
        m = min(a.shape[-1], width)
        out[..., :m] = a[..., :m]
        return out

    def _restore_state(self, ckpt_manager, state: FitState, extra=None):
        """(state with beta, X beta and mu from the latest checkpoint, the
        restored tree); ``extra`` adds leaves to the template.  On a mesh
        every process reads the full vectors and keeps its own block."""
        if self.mesh is not None:
            like = {"beta": np.zeros(self._p_tot, np.float32),
                    "xb": np.zeros(self._n_tot, np.float32),
                    "mu": np.float32(0.0), **(extra or {})}
            saved, _ = ckpt_manager.restore(like)
            state = state._replace(
                beta=self._put_cols(self._adapt(
                    np.asarray(saved["beta"], np.float32), self._p_tot)),
                xb=self._put_rows(self._adapt(
                    np.asarray(saved["xb"], np.float32), self._n_tot)),
                mu=torch.tensor(float(np.asarray(saved["mu"])),
                                dtype=torch.float32, device=self.device))
            return state, saved
        like = {"beta": state.beta, "xb": state.xb, "mu": state.mu,
                **(extra or {})}
        saved, _ = ckpt_manager.restore(like)
        state = state._replace(
            beta=self._adapt(saved["beta"].float(), self._p_tot),
            xb=state.xb if self._streaming
            else self._adapt(saved["xb"].float(), self._n_tot),
            mu=saved["mu"].float().reshape(()))
        return state, saved

    def _run(self, state: FitState, lam1: float, lam2: float, *,
             weights=None, active=None, max_outer=None, tol=None,
             verbose=False, ckpt_manager=None, ckpt_every: int = 10,
             ckpt_every_chunks: Optional[int] = None):
        """Supersteps at fixed (lam1, lam2) until the objective plateaus.

        ``weights``: a (n_tot,) row-weight tensor on the device (None: the
        session's; CV folds pass fold-masked ones).  ``active``: optional
        host (p_tot,) 0/1 mask in packed column order; coordinates at 0
        stay frozen and tiles without an active coordinate are skipped.
        Returns (state, history, n_iter, converged); the history also
        records each superstep's host seconds (``step_s``), taken after the
        one device-to-host read of its metrics; with a convergence stream
        each superstep emits one event from the scalars of that read.
        ``ckpt_manager``: resume from its latest checkpoint if it has one
        (the history then starts at the resumed superstep), and save every
        ``ckpt_every``; a streaming session also saves its first pass's
        partial sums every ``ckpt_every_chunks`` chunks.
        """
        cfg = self.config
        max_outer = cfg.max_outer if max_outer is None else int(max_outer)
        tol = cfg.tol if tol is None else float(tol)
        weights = self._wobs if weights is None else weights
        T = cfg.tile_size
        total_tiles = self._p_tot // T        # over every feature shard
        active_dev = tile_active = None
        live_tiles = total_tiles
        live_active = self._p_tot
        if active is not None:
            act = np.asarray(active, np.float32)
            active_dev = self._put_cols(act)
            # this rank's tiles; every rank of a data group holds the same
            # columns and mask, so all of them skip the same tiles
            tile_active = act[self._cols].reshape(self._n_tiles, T) \
                .max(axis=1) > 0
            live_tiles = int((act.reshape(-1, T).max(axis=1) > 0).sum())
            live_active = int((act > 0).sum())
        # counted as the reference counts: the Gauss-Seidel sweep and the
        # fused Jacobi superstep skip dead tiles ("shaped"); the unfused
        # Jacobi sweep is counted as sweeping every tile.  Both Gram-mode
        # sweeps of a streaming session skip them.  On a mesh with sharded
        # rows the reference sweeps every tile (masked), and so counts.
        shaped = active is not None and self.axis_data is None and (
            self._streaming or cfg.coupling == "gauss-seidel"
            or (cfg.coupling == "jacobi" and cfg.fuse_superstep
                and self.axis_model is None))
        history = {k: [] for k in _HISTORY_KEYS + ("step_s",)}
        f_prev, converged, it = np.inf, False, 0
        start_it = 1
        resume = None
        if ckpt_manager is not None and ckpt_manager.latest_step() is not None:
            md = ckpt_manager.read_metadata()
            if "next_it" not in md:
                raise ValueError(
                    "checkpoint was written by fit_path (path state), not a "
                    "single fit; resume it with fit_path(ckpt_manager=...)")
            self._check_layout(md)
            if self._streaming:
                state, resume = self._restore_stream(ckpt_manager, state, md)
            else:
                state, _ = self._restore_state(ckpt_manager, state)
            state = state._replace(step=int(md["next_it"]) - 1)
            f_prev = md.get("f_prev", np.inf)
            start_it = int(md["next_it"])
        t_prev = time.perf_counter()
        for it in range(start_it, max_outer + 1):
            if self._streaming:
                state, m = self._stream_superstep(
                    state, it, (lam1, lam2), weights, active_dev,
                    tile_active, resume=resume, f_prev=f_prev,
                    ckpt=(ckpt_manager, ckpt_every_chunks))
                resume = None
            else:
                state, m = self._dispatch_superstep(
                    weights, (lam1, lam2), active_dev, tile_active, state)
            self.launch_stats["supersteps"] += 1
            self.launch_stats["sweep_tile_launches"] += \
                live_tiles if shaped else total_tiles
            if shaped:
                self.launch_stats["sweep_tiles_skipped"] += \
                    total_tiles - live_tiles
            # one device-to-host read per superstep, all metrics together
            vals = torch.stack([m[k].to(torch.float64)
                                for k in dglmnet.METRIC_KEYS]).cpu().numpy()
            mh = dict(zip(dglmnet.METRIC_KEYS, vals.tolist()))
            now = time.perf_counter()
            history["step_s"].append(now - t_prev)
            t_prev = now
            # the stop test reads process 0's f on a mesh; the history
            # keeps this rank's own
            f = float(self._agree(np.asarray([mh["f"]]))[0])
            for k in _HISTORY_KEYS:
                history[k].append(mh[k])
            if self._conv is not None:
                self._emit_conv(it, mh, lam1=lam1, lam2=lam2,
                                active_size=live_active)
            if verbose:
                tag = f"repro_torch/stream x{self._Xs.n_chunks}" \
                    if self._streaming else "repro_torch" \
                    if self.mesh is None else \
                    f"repro_torch/{self._D}x{self._M}"
                print(f"[{tag}] it={it} f={f:.8f} "
                      f"alpha={mh['alpha']:.4f} mu={mh['mu']:.3f} "
                      f"nnz={int(mh['nnz'])}")
            if ckpt_manager is not None and it % ckpt_every == 0:
                tree = {"beta": state.beta, "mu": state.mu}
                if self.mesh is not None:
                    tree = {"beta": self._host_beta(state.beta),
                            "xb": self._host_rows(state.xb), "mu": state.mu}
                elif not self._streaming:
                    tree["xb"] = state.xb
                ckpt_manager.save(it, tree,
                                  metadata={"next_it": it + 1, "f_prev": f,
                                            "design_layout":
                                                self._design_layout})
            if np.isfinite(f_prev) and \
                    abs(f_prev - f) <= tol * max(1.0, abs(f)):
                converged = True
                break
            f_prev = f
        if ckpt_manager is not None:
            ckpt_manager.wait()
        return state, history, it, converged

    # ------------------------------------------------------------ streaming

    def _iter_row_chunks(self, weights=None, start: int = 0):
        """Yield ``(i, X_chunk, y, w, offset)``: the design's device chunks
        with the matching slices of the session's row vectors (``weights``
        None: the session's).  Every streaming pass (statistics, line
        search, gradient, deviance, margins) goes through here."""
        w = self._wobs if weights is None else weights
        sd = self._Xs
        for i, Xc in sd.iter_chunks(start=start):
            sl = sd.row_slice(i)
            yield i, Xc, self._ys[sl], w[sl], self._offsets[sl]

    def _restore_stream(self, ckpt_manager, state: FitState, md):
        """(state with beta and mu restored, the resume point (chunk,
        (G, g0, L)) of a chunk-cursor checkpoint or None)."""
        p = self._p_tot
        like = {"beta": state.beta, "mu": state.mu}
        cursor = md.get("stream_chunk")
        if cursor is not None:
            zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                               device=self.device)
            like.update(G=zeros(p, p), g0=zeros(p), L=zeros())
        saved, _ = ckpt_manager.restore(like)
        state = state._replace(beta=self._adapt(saved["beta"].float(), p),
                               mu=saved["mu"].float().reshape(()))
        if cursor is None:
            return state, None
        acc = (saved["G"].float(), saved["g0"].float(),
               saved["L"].float().reshape(()))
        return state, (int(cursor), acc)

    def _stream_superstep(self, state: FitState, it: int, lams, weights,
                          active_dev, tile_active, *, resume=None,
                          f_prev=np.inf, ckpt=(None, None)):
        """One streaming superstep: the statistics pass (from ``resume``'s
        chunk and partial sums when given), the sweep, the line-search
        pass; returns (state, metrics).  ``ckpt`` = (manager, k): save the
        partial sums every k chunks of the first pass.  Each pass runs in a
        span (``solver/stream_stats``, ``stream_sweep``,
        ``stream_line_search``), whose host µs become the superstep's
        ``phase_us`` and their sum its ``step_us`` (None untraced)."""
        fns = self._superstep
        sd = self._Xs
        mgr, every = ckpt
        p = self._p_tot
        if resume is None:
            start = 0
            acc = (torch.zeros((p, p), dtype=torch.float32,
                               device=self.device),
                   torch.zeros(p, dtype=torch.float32, device=self.device),
                   torch.zeros((), dtype=torch.float32, device=self.device))
        else:
            start, acc = resume
        with obs_trace.span("solver/stream_stats", args={"it": it}) as sp1:
            for i, Xc, yc, wc, oc in self._iter_row_chunks(weights,
                                                           start=start):
                acc = fns.stats_chunk(Xc, yc, wc, oc, state.beta, acc)
                if mgr is not None and every and (i + 1) % every == 0 \
                        and i + 1 < sd.n_chunks:
                    G, g0, L = acc
                    mgr.save(it, {"beta": state.beta, "mu": state.mu,
                                  "G": G, "g0": g0, "L": L},
                             metadata={"next_it": it, "stream_chunk": i + 1,
                                       "f_prev": float(f_prev),
                                       "design_layout":
                                           self._design_layout})
        with obs_trace.span("solver/stream_sweep") as sp2:
            prep = fns.prepare(acc, state.beta, state.mu, lams, self._penf,
                               state.cursor, active=active_dev,
                               tile_active=tile_active)
        del acc
        with obs_trace.span("solver/stream_line_search") as sp3:
            losses = torch.zeros(fns.n_candidates, dtype=torch.float32,
                                 device=self.device)
            for _, Xc, yc, wc, oc in self._iter_row_chunks(weights):
                losses = fns.ls_chunk(Xc, yc, wc, oc, state.beta,
                                      prep["dbeta"], losses)
            out = fns.finish(losses, prep, state, lams, self._penf)
        phase_us = {"stats": round(sp1.elapsed_us, 1),
                    "sweep": round(sp2.elapsed_us, 1),
                    "line_search": round(sp3.elapsed_us, 1)}
        total = sum(phase_us.values())
        self._last_step_us = total or None
        self._last_phase_us = phase_us if total else None
        return out

    # ------------------------------------------------------- the mesh's ALB

    def _budgets(self) -> Optional[int]:
        """This superstep's ALB budgets (``_budgets_host``, one a model
        column) and this rank's column's, None on one device.  Every rank
        computes the same vector: telemetry folds the same exchanged
        samples, and the speeds simulation draws from the same seed."""
        from repro_torch.core import alb as alb_lib
        nt = self._n_tiles
        if self._telemetry is not None:
            sp = self._telemetry.column_speeds(self.mesh, self.axis_model)
            if sp is None:        # warm-up: a full cycle for every column
                budgets = np.full((self._M,), nt, np.int32)
            else:
                # measured speeds: sanitized, with the completion-rule
                # pivot (the quantile pivot never down-budgets the slow
                # node at small M; see alb._pivot)
                budgets = alb_lib.alb_budgets(
                    sp, nt, self.config.alb_kappa, self._max_budget,
                    sanitize=True, pivot_rule="completion")
            self._budgets_host = np.asarray(budgets, np.int32)
        elif self._base_speeds is not None:
            self._budgets_host = alb_lib.alb_budgets(
                alb_lib.sample_speeds(self._rng, self._base_speeds), nt,
                self.config.alb_kappa, self._max_budget).astype(np.int32)
        elif self._budgets_host is None:
            self._budgets_host = np.full((self._M,), nt, np.int32)
        if self.mesh is None:
            return None
        return int(self._budgets_host[self._m])

    def _my_tiles(self) -> int:
        """Tiles this process's columns are budgeted for in the last budget
        vector (the unit of work of faults and telemetry)."""
        if self._budgets_host is None:
            return self._n_tiles
        if self.dist_info is None or not self.dist_info["local_columns"]:
            return int(self._budgets_host.max())
        return int(max(self._budgets_host[m]
                       for m in self.dist_info["local_columns"]))

    def _dispatch_superstep(self, weights, lams, active_dev, tile_active,
                            state):
        """One in-memory superstep with the mesh's hooks around it: the
        budget, the fault plan's sleep and the telemetry record.  Without
        telemetry or faults it is the superstep call in a span (the span
        times the host dispatch; the metrics read that follows is the
        superstep's one synchronization)."""
        budget = self._budgets()

        def call():
            return self._superstep(
                self._Xs, self._ys, weights, self._offsets, lams,
                self._penf, state, active=active_dev,
                tile_active=tile_active, budget=budget)

        if self._telemetry is None and self._faults is None:
            with obs_trace.span("solver/superstep") as sp:
                out = call()
            self._last_step_us = sp.elapsed_us or None
            self._last_phase_us = None
            return out
        step_no = self._superstep_no
        self._superstep_no += 1
        pid = 0 if self.dist_info is None else self.dist_info["process_id"]
        tiles = self._my_tiles()
        work = work_phases = None
        if self._faults is not None and self._faults.tile_cost_s > 0:
            # simulated local work: the sleep is real wall-clock, and the
            # same seconds are what telemetry records for this node (the
            # measurement-source note of repro_torch.dist.telemetry)
            work = self._faults.work_s(pid, step_no, tiles)
            work_phases = self._faults.work_phases(pid, step_no, tiles)
            if work > 0:
                with obs_trace.span("solver/fault_sleep",
                                    args={"work_s": round(work, 6)}):
                    time.sleep(work)
        t0 = time.perf_counter()
        with obs_trace.span("solver/superstep",
                            args={"step": step_no, "tiles": tiles}):
            out = call()
        if self._telemetry is None:
            self._last_step_us = None
            self._last_phase_us = None
            return out
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # under a fault plan the injected work is the node's local seconds:
        # wall-clock around a superstep synchronized by its collectives
        # would fold in the wait for the straggler
        sec = time.perf_counter() - t0 if work is None else work
        if work_phases is not None:
            phases = self._compose_phases(work_phases)
        elif self._phase_fractions:
            phases = {k: sec * f for k, f in self._phase_fractions.items()}
        else:
            phases = None
        self._telemetry.record(step_no, tiles, sec, phases=phases)
        self._last_step_us = sec * 1e6
        self._last_phase_us = None if phases is None else \
            {k: round(v * 1e6, 1) for k, v in phases.items()}
        return out

    def _compose_phases(self, work_phases: dict) -> dict:
        """The fault plan's phase attribution with its compute share spread
        over the ``set_phase_fractions`` split; wait phases ("network",
        "io") pass through."""
        if not self._phase_fractions:
            return dict(work_phases)
        from repro_torch.dist.telemetry import COMPUTE_PHASES
        compute = sum(v for k, v in work_phases.items()
                      if k in COMPUTE_PHASES)
        out = {k: v for k, v in work_phases.items()
               if k not in COMPUTE_PHASES}
        for k, f in self._phase_fractions.items():
            out[k] = out.get(k, 0.0) + compute * f
        return out

    def set_phase_fractions(self, fractions):
        """Register the split of a superstep's seconds into named phases
        (``{"stats": 0.2, "sweep": 0.7, ...}``; None stops attributing).
        Every later telemetry record carries ``phases = fraction x
        seconds`` (``repro_torch.dist.telemetry.phase_breakdown``), and a
        convergence event its ``phase_us``."""
        if fractions is not None:
            fractions = {str(k): float(v) for k, v in fractions.items()}
        self._phase_fractions = fractions

    def set_convergence_stream(self, stream):
        """Attach (or detach, with None) a convergence event stream.
        Sessions created while tracing targets a directory get one
        (``<trace_dir>/convergence_<pid>.jsonl``).  Accepts a
        ``repro_torch.obs.convergence.ConvergenceStream`` or a path."""
        if stream is not None and not hasattr(stream, "emit"):
            stream = conv_lib.ConvergenceStream(stream)
        self._conv = stream

    def _emit_conv(self, outer_it, mh, *, lam1, lam2, active_size):
        """One convergence event a superstep, from host scalars only (the
        superstep's one device-to-host read fetched them all)."""
        self._conv_step += 1
        ctx = self._conv_ctx
        self._conv.emit(
            step=self._conv_step, outer_it=int(outer_it),
            lam_index=ctx.get("lam_index"),
            lam1=float(lam1), lam2=float(lam2),
            f=float(mh["f"]), loss=float(mh["loss"]),
            deviance=float(mh["D"]), alpha=float(mh["alpha"]),
            mu=float(mh["mu"]), nnz=int(mh["nnz"]),
            accepted_unit=float(mh["accepted_unit"]),
            active_size=int(active_size),
            screened=ctx.get("screened"),
            kkt_violations=ctx.get("kkt_violations"),
            supersteps=self.launch_stats["supersteps"],
            sweep_tile_launches=self.launch_stats["sweep_tile_launches"],
            sweep_tiles_skipped=self.launch_stats["sweep_tiles_skipped"],
            step_us=self._last_step_us, phase_us=self._last_phase_us)

    def fit(self, lam1: Optional[float] = None, lam2: Optional[float] = None,
            *, beta0=None, intercept0: float = 0.0, max_outer=None, tol=None,
            verbose=False, ckpt_manager=None, ckpt_every: int = 10,
            ckpt_every_chunks: Optional[int] = None) -> FitResult:
        """Fit one (lam1, lam2) point; defaults come from the config.
        ``beta0`` (+ ``intercept0``) warm-starts from beta in feature order.
        ``ckpt_manager`` saves (beta, X beta, mu) every ``ckpt_every``
        supersteps and resumes from its latest checkpoint, if any; a
        streaming session saves (beta, mu) and, every ``ckpt_every_chunks``
        chunks of a first pass, its partial sums with the chunk cursor."""
        cfg = self.config
        lam1 = cfg.lam1 if lam1 is None else float(lam1)
        lam2 = cfg.lam2 if lam2 is None else float(lam2)
        state = self._init_state(beta0, intercept0)
        state, history, n_iter, converged = self._run(
            state, lam1, lam2, max_outer=max_outer, tol=tol, verbose=verbose,
            ckpt_manager=ckpt_manager, ckpt_every=ckpt_every,
            ckpt_every_chunks=ckpt_every_chunks)
        self._state = state
        self.beta_, self.intercept_ = self._unpack_user(
            self._host_beta(state.beta))
        return FitResult(self.beta_, history, n_iter, converged)

    def _grad_state(self, state: FitState, weights=None) -> np.ndarray:
        """g = X^T s(beta) in packed column order, on the host: s is the
        (weighted, offset) negative margin gradient at the state's margins,
        so a zero coordinate is optimal iff |g_j| <= lam1 pf_j.
        ``weights``: a row-weight tensor (None: the session's).  A
        streaming session makes the margins again chunk by chunk."""
        if self._streaming:
            g = torch.zeros(self._p_tot, dtype=torch.float32,
                            device=self.device)
            for _, Xc, yc, wc, oc in self._iter_row_chunks(weights):
                _, s, _ = ops.glm_stats(yc, Xc @ state.beta,
                                        self.config.family, weights=wc,
                                        offset=oc)
                g += Xc.T @ s
            return g.cpu().numpy()
        _, s, _ = ops.glm_stats(
            self._ys, state.xb, self.config.family,
            weights=self._wobs if weights is None else weights,
            offset=self._offsets)
        # on a mesh: summed over the row shards, gathered over the feature
        # shards (collectives every rank calls)
        return self._host_beta(self._reduce_data(self._Xs.rmatvec(s)))

    def training_margins(self) -> np.ndarray:
        """Host (n,) margins X beta over the training design at the current
        fitted state: no offset; the intercept is included when fitted (it
        is a design column).  A streaming session makes them in one chunk
        pass."""
        if self._state is None:
            raise ValueError("no fitted state; call fit or fit_path first")
        xb = self._Xs.matvec(self._state.beta) if self._streaming \
            else self._state.xb
        return self._host_rows(xb)[:self._n_user]

    def set_observations(self, *, y=None, sample_weight=None, offset=None):
        """Swap the observation model on the same session (y, weights and
        offsets are superstep arguments, the design stays).  Each given
        vector is (n,); padding is reapplied (y -> 1, weights -> 0,
        offset -> 0).  The warm state and lambda_max are cleared, since
        the objective changed under them."""
        n = self._n_user
        pad = self._n_tot - n
        if y is not None:
            y = np.asarray(y, np.float32)
            if y.shape != (n,):
                raise ValueError(f"y must be ({n},); got {y.shape}")
            self._ys = self._put_rows(np.pad(y, (0, pad),
                                             constant_values=1.0))
        if sample_weight is not None:
            sw = np.asarray(sample_weight, np.float32)
            if sw.shape != (n,):
                raise ValueError(
                    f"sample_weight must be ({n},); got {sw.shape}")
            if (sw < 0).any():
                raise ValueError("sample_weight must be nonnegative")
            self._wobs_host = np.pad(sw, (0, pad))
            self._wobs = self._put_rows(self._wobs_host)
        if offset is not None:
            off = np.asarray(offset, np.float32)
            if off.shape != (n,):
                raise ValueError(f"offset must be ({n},); got {off.shape}")
            self._offsets = self._put_rows(np.pad(off, (0, pad)))
        self._state = None
        self._lmax = None
        return self

    def lambda_max(self) -> float:
        """Smallest lam1 with every PENALIZED coordinate zero: max_j |g_j| /
        pf_j at the null model (unpenalized coordinates, the intercept, are
        fitted first; they are active at every lam1)."""
        if self._lmax is None:
            pen = self._penf_host > _PF_EPS
            if not pen.any():
                raise ValueError(
                    "lambda_max undefined: every feature is unpenalized")
            state = self._init_state(None)
            if (~pen).any():
                state, _, _, _ = self._run(
                    state, 0.0, 0.0, active=(~pen).astype(np.float32),
                    max_outer=50)
            g = np.abs(self._grad_state(state))
            self._lmax = float((g[pen] / self._penf_host[pen]).max())
        return self._lmax

    # ------------------------------------------------------------- paths

    def _make_grid(self, lambdas, n_lambdas, lam_ratio):
        if lambdas is None:
            lmax = self.lambda_max()
            lambdas = np.logspace(np.log10(lmax),
                                  np.log10(lmax * lam_ratio), n_lambdas)
        lambdas = np.asarray(lambdas, np.float64)
        if len(lambdas) > 1 and not np.all(np.diff(lambdas) < 0):
            raise ValueError("fit_path expects a strictly decreasing lam1 "
                             "grid (warm starts go dense-ward)")
        return lambdas

    def _deviance(self, state: FitState, weights) -> float:
        """Total weighted deviance at a fit state over the rows that
        ``weights`` (a device tensor) selects; one scalar comes back.  A
        streaming session sums it over chunks."""
        fam = glm.get_family(self.config.family)
        if not self._streaming:
            d = fam.deviance(self._ys, state.xb, weights=weights,
                             offset=self._offsets)
            return float(self._reduce_data(d.reshape(1))[0])
        d = torch.zeros((), dtype=torch.float32, device=self.device)
        for _, Xc, yc, wc, oc in self._iter_row_chunks(weights):
            d += fam.deviance(yc, Xc @ state.beta, weights=wc, offset=oc)
        return float(d)

    def _path_impl(self, lambdas: np.ndarray, lam2: float, *, weights=None,
                   eval_weights=None, screen=True, kkt_slack=1e-4,
                   max_outer=None, tol=None, verbose=False,
                   ckpt_manager=None):
        """Warm-started path over a fixed decreasing grid.

        ``weights``: row weights on the device (None: the session's), the
        CV fold mechanism.  ``eval_weights``: host row weights of a
        held-out set; when given, the mean validation deviance is recorded
        per lambda.  ``ckpt_manager``: resume mid-grid from its latest
        checkpoint if it has one, and save after every lambda.  Returns
        (betas_packed, f, nnz, n_iters, converged, val_dev, state).
        """
        cfg = self.config
        K = len(lambdas)
        pf = self._penf_host
        unpen = pf <= _PF_EPS
        if eval_weights is not None:
            ew_dev = self._put_rows(eval_weights)
            ew_sum = float(np.asarray(eval_weights).sum())

        state = self._init_state(None)
        betas_packed = np.zeros((K, self._p_tot), np.float32)
        f = np.full((K,), np.nan)
        nnz = np.zeros((K,), np.int64)
        n_iters = np.zeros((K,), np.int64)
        converged = np.zeros((K,), bool)
        val_dev = np.full((K,), np.nan) if eval_weights is not None else None
        start_k = 0

        if ckpt_manager is not None and ckpt_manager.latest_step() is not None:
            md = ckpt_manager.read_metadata()
            if "path" not in md:
                raise ValueError(
                    "checkpoint was written by a single fit, not fit_path; "
                    "resume it with fit(ckpt_manager=...)")
            self._check_layout(md)
            pmd = md["path"]
            start_k = int(pmd["next_k"])
            saved_grid = np.asarray(pmd["lambdas"], np.float64)
            # the completed prefix must be this grid's (a longer tail is
            # the interrupted-mid-grid case)
            if start_k > K or float(pmd["lam2"]) != lam2 or \
                    not np.allclose(saved_grid[:start_k], lambdas[:start_k]):
                raise ValueError(
                    "path checkpoint was written for a different λ grid; "
                    "pass the same lambdas/lam2 to resume")
            state, saved = self._restore_state(
                ckpt_manager, state, {"path_betas": betas_packed})
            betas_packed[:start_k] = self._adapt(
                saved["path_betas"], self._p_tot)[:start_k]
            for name, arr in (("f", f), ("nnz", nnz),
                              ("n_iters", n_iters), ("converged", converged)):
                arr[:start_k] = np.asarray(pmd[name])[:start_k]

        lam_prev = float(lambdas[start_k - 1]) if start_k else None
        g_warm = None           # the gradient at the warm iterate, if known
        for k in range(start_k, K):
            lam1 = float(lambdas[k])
            # a fresh trust region per lambda; warm beta and margins carry
            state = state._replace(mu=torch.full_like(state.mu,
                                                      cfg.mu_init), step=0)
            if screen:
                # sequential strong rule (Tibshirani et al. 2012):
                # |g_j| >= pf_j (2 lam_k - lam_{k-1}), plus every active and
                # every unpenalized coordinate; the previous lambda's last
                # KKT gradient is the gradient at this warm iterate
                g = self._grad_state(state, weights) if g_warm is None \
                    else g_warm
                thresh = 2.0 * lam1 - (lam_prev if lam_prev is not None
                                       else lam1)
                active = (np.abs(g) >= pf * thresh - 1e-12) | \
                    (self._host_beta(state.beta) != 0.0) | unpen
                active = self._agree(active)
                it_k = 0
                for _ in range(8):
                    # the stream's context: where on the path, how many
                    # coordinates the strong rule froze, and what the last
                    # KKT test of this lambda found (None before it)
                    self._conv_ctx = {
                        "lam_index": k,
                        "screened": int(active.size - active.sum()),
                        "kkt_violations": self._conv_ctx.get(
                            "kkt_violations")
                        if self._conv_ctx.get("lam_index") == k else None}
                    state, hist, it_round, conv_k = self._run(
                        state, lam1, lam2, weights=weights, active=active,
                        max_outer=max_outer, tol=tol, verbose=verbose)
                    it_k += it_round
                    # KKT on the FULL gradient: a frozen coordinate (beta_j
                    # = 0) is optimal iff |g_j| <= lam1 pf_j
                    g = self._grad_state(state, weights)
                    viol = self._agree((~active) & (
                        np.abs(g) > pf * lam1 * (1.0 + kkt_slack) + 1e-7))
                    self._conv_ctx["kkt_violations"] = int(viol.sum())
                    if not viol.any():
                        break
                    active |= viol
                g_warm = g
            else:
                self._conv_ctx = {"lam_index": k}
                state, hist, it_k, conv_k = self._run(
                    state, lam1, lam2, weights=weights, max_outer=max_outer,
                    tol=tol, verbose=verbose)
            betas_packed[k] = self._host_beta(state.beta)
            if hist["f"]:
                f[k] = hist["f"][-1]
                nnz[k] = int(hist["nnz"][-1])
            n_iters[k] = it_k
            converged[k] = conv_k
            if val_dev is not None:
                val_dev[k] = self._deviance(state, ew_dev) / ew_sum \
                    if ew_sum > 0 else np.nan
            lam_prev = lam1
            if verbose:
                print(f"[path {k + 1}/{K}] lam1={lam1:.6g} f={f[k]:.8f} "
                      f"nnz={nnz[k]} iters={it_k}")
            if ckpt_manager is not None:
                ckpt_manager.save(
                    k + 1,
                    {"beta": betas_packed[k], "xb": self._host_rows(state.xb),
                     "mu": state.mu, "path_betas": betas_packed}
                    if self.mesh is not None else
                    {"beta": state.beta, "xb": state.xb, "mu": state.mu,
                     "path_betas": betas_packed},
                    metadata={"design_layout": self._design_layout,
                              "path": {"next_k": k + 1,
                                       "lambdas": lambdas.tolist(),
                                       "lam2": lam2,
                                       "f": f[:k + 1].tolist(),
                                       "nnz": nnz[:k + 1].tolist(),
                                       "n_iters": n_iters[:k + 1].tolist(),
                                       "converged":
                                           converged[:k + 1].tolist()}})
        if ckpt_manager is not None:
            ckpt_manager.wait()
        self._conv_ctx = {}
        return betas_packed, f, nnz, n_iters, converged, val_dev, state

    def _path_result(self, lambdas, lam2, betas_packed, f, nnz, n_iters,
                     converged) -> PathResult:
        if len(lambdas):
            pairs = [self._unpack_user(b) for b in betas_packed]
            betas = np.stack([b for b, _ in pairs])
            intercepts = np.asarray([b0 for _, b0 in pairs], np.float32)
        else:
            betas = np.zeros((0, self._p_user), np.float32)
            intercepts = np.zeros((0,), np.float32)
        return PathResult(lambdas, lam2, betas, f, nnz, n_iters, converged,
                          intercepts if self.fit_intercept else None)

    def fit_path(self, lambdas=None, *, n_lambdas: int = 100,
                 lam_ratio: float = 1e-3, lam2: Optional[float] = None,
                 screen: bool = True, kkt_slack: float = 1e-4,
                 max_outer=None, tol=None, verbose=False,
                 ckpt_manager=None) -> PathResult:
        """Warm-started fit over a decreasing lam1 grid.

        ``lambdas=None`` builds the GLMNET grid: ``n_lambdas`` log-spaced
        points from ``lambda_max()`` down to lambda_max * ``lam_ratio``.
        Each lambda starts from the previous solution (beta and the margins
        X beta stay on the device); ``screen=True`` freezes the strong
        rule's cold coordinates and re-fits with any KKT violators
        unfrozen, so screening never changes the solution.
        ``ckpt_manager`` saves the warm (beta, X beta, mu) and the results
        so far after each lambda; a later call with the same grid resumes
        after the last lambda saved.
        """
        lam2 = self.config.lam2 if lam2 is None else float(lam2)
        lambdas = self._make_grid(lambdas, n_lambdas, lam_ratio)
        betas_packed, f, nnz, n_iters, converged, _, state = self._path_impl(
            lambdas, lam2, screen=screen, kkt_slack=kkt_slack,
            max_outer=max_outer, tol=tol, verbose=verbose,
            ckpt_manager=ckpt_manager)
        self._state = state
        result = self._path_result(lambdas, lam2, betas_packed, f, nnz,
                                   n_iters, converged)
        if len(lambdas):
            self.beta_ = result.betas[-1]
            self.intercept_ = float(result.intercepts[-1]) \
                if result.intercepts is not None else 0.0
        return result

    def fit_cv(self, n_folds: int = 5, *, lambdas=None,
               n_lambdas: int = 100, lam_ratio: float = 1e-3,
               lam2: Optional[float] = None, seed: int = 0,
               screen: bool = True, max_outer=None, tol=None,
               verbose=False) -> CVResult:
        """Mask-based K-fold cross-validation over the lambda path.

        Fold f trains with weights w [fold != f] and validates on w [fold
        == f], on the one packed design (no data moves).  Every fold runs a
        warm-started path over the full-data grid; lambda is selected by
        mean validation deviance, and the coefficients returned are the
        full-data path's at that lambda.  With ``standardize=True`` the
        column scaling is the session's, from all rows (not re-standardized
        per training fold as cv.glmnet does).
        """
        if n_folds < 2:
            raise ValueError("fit_cv needs n_folds >= 2")
        lam2 = self.config.lam2 if lam2 is None else float(lam2)
        lambdas = self._make_grid(lambdas, n_lambdas, lam_ratio)
        K = len(lambdas)
        n = self._n_user

        # the full-data path: the grid's anchor and the final refit
        betas_packed, f, nnz, n_iters, converged, _, state = self._path_impl(
            lambdas, lam2, screen=screen, max_outer=max_outer, tol=tol,
            verbose=verbose)
        full_path = self._path_result(lambdas, lam2, betas_packed, f, nnz,
                                      n_iters, converged)

        rng = np.random.default_rng(seed)
        fold_of = np.full((self._n_tot,), -1, np.int64)   # padding: no fold
        fold_of[:n] = rng.permuted(np.arange(n) % n_folds)

        dev_folds = np.full((n_folds, K), np.nan)
        for fold in range(n_folds):
            w_tr = self._wobs_host * (fold_of != fold)
            w_val = self._wobs_host * (fold_of == fold)
            if verbose:
                print(f"[cv fold {fold + 1}/{n_folds}] "
                      f"train w={w_tr.sum():.0f} val w={w_val.sum():.0f}")
            _, _, _, _, _, val_dev, _ = self._path_impl(
                lambdas, lam2, weights=self._put_rows(w_tr),
                eval_weights=w_val,
                screen=screen, max_outer=max_outer, tol=tol, verbose=False)
            dev_folds[fold] = val_dev

        dev_mean = np.nanmean(dev_folds, axis=0)
        dev_se = np.nanstd(dev_folds, axis=0, ddof=1) / np.sqrt(n_folds)
        best = int(np.nanargmin(dev_mean))
        self._state = state
        self.beta_ = full_path.betas[best]
        self.intercept_ = float(full_path.intercepts[best]) \
            if full_path.intercepts is not None else 0.0
        return CVResult(lambdas, lam2, dev_folds, dev_mean, dev_se, best,
                        float(lambdas[best]), full_path, self.beta_,
                        self.intercept_)

    # ------------------------------------------------------------ predict

    def _serve_engine(self, beta: np.ndarray, intercept: float):
        """The scoring engine over (beta, b0) on this session's device,
        cached on the coefficient bytes so repeated predicts reuse the
        compacted table."""
        key = (beta.tobytes(), float(intercept))
        if self._serve_cache is None or self._serve_cache[0] != key:
            model = ServableModel(
                betas=np.array(beta[None, :], np.float32),
                intercepts=np.asarray([intercept], np.float32),
                family=self.config.family)
            self._serve_cache = (key, ScoringEngine(model,
                                                    device=self.device))
        return self._serve_cache[1]

    def save(self, path, *, quantize=None, path_result=None):
        """Export the fitted model as a versioned serving artifact
        (``serve/artifact.py``); ``path_result`` (a ``PathResult``) exports
        the whole path, one column per lambda; ``quantize="int8"`` writes
        the shared-scale int8 table."""
        return artifact.export(self, path, quantize=quantize,
                               path_result=path_result)

    def predict(self, X_new, *, beta=None, intercept=None, offset=None,
                kind: str = "response"):
        """Predict on new rows with the fitted (or a given) beta.
        ``kind="link"`` gives margins X beta + b0 + o, ``"response"`` the
        family's inverse link.  SparseCOO rows are scored by the serving
        engine's fused sparse kernel (gather, dot, link) over the active
        set; dense rows by a host product."""
        beta = self.beta_ if beta is None else np.asarray(beta, np.float32)
        if beta is None:
            raise ValueError("no fitted coefficients; call fit/fit_path "
                             "first or pass beta=...")
        intercept = self.intercept_ if intercept is None else float(intercept)
        if kind not in ("link", "response"):
            raise ValueError(f"unknown kind {kind!r}; use 'link' or "
                             "'response'")
        if isinstance(X_new, SparseCOO):
            eng = self._serve_engine(np.asarray(beta, np.float32), intercept)
            return eng.score_coo(X_new, kind=kind, offset=offset)[:, 0]
        m = np.asarray(X_new, np.float32) @ beta + intercept
        if offset is not None:
            m = m + np.asarray(offset, np.float32)
        if kind == "link":
            return m
        fam = glm.get_family(self.config.family)
        return fam.predict(torch.from_numpy(np.asarray(m))).numpy()

    def score(self, X_new, y_new, *, beta=None, intercept=None,
              offset=None) -> float:
        """``glm.margin_score`` on held-out rows: accuracy for logistic and
        probit, R^2 for squared loss, mean negative loss for poisson."""
        m = self.predict(X_new, beta=beta, intercept=intercept,
                         offset=offset, kind="link")
        return glm.margin_score(self.config.family,
                                np.asarray(y_new, np.float32), m)
