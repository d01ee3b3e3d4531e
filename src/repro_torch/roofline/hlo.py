"""The launch model of one d-GLMNET superstep, the card's memory budget
of a kernel launch, and the counts of a traced step.

``superstep_launch_targets`` is a copy of the JAX package's
(``repro.roofline.hlo``): pure arithmetic, the DESIGN.md section 8 launch
contract (fused = 2 launches, unfused = 5) with each launch's float32
flops and device-memory bytes.  ``analysis/audit.py`` holds the port's
superstep to its launch count.

``shared_memory_budget`` takes the place of the JAX package's
``VMEM_BUDGET_BYTES``: on the H100 a kernel's fast memory is its block's
static plus dynamic shared memory, and the most a block may opt in to is
the card's own ``shared_memory_per_block_optin`` (read from the card,
never a constant); ``registers_per_sm`` bounds a block's registers
times its threads.

The roofline terms and model flops of the LM template are
``roofline/model.py``.

``analyze_step`` is the counterpart of the JAX package's ``analyze_hlo``:
where the reference parses a compiled, partitioned HLO module, the port
runs its own step once, eagerly, on one rank's tensors (fake ones, so
nothing is allocated and no card is needed: ``fake_mode``), under a
``TorchDispatchMode`` that sees every aten op, the backward, the remat
recompute and the optimizer's in-place updates included.  Its
``StepStats`` has ``HLOStats``' fields, counted by the reference's rules:

  * flops: 2 x result x contracting dims of ``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, the convolutions and their backwards (the formulas of
    ``torch.utils.flop_counter``'s registry);
  * bytes accessed: result + operand bytes of every op that moves data;
    a view, a metadata op or an allocation without a fill moves none
    (the reference's ``_SKIP_BYTES``), and an operand is charged for the
    elements it spans, not for its whole buffer;
  * collectives: each logical collective the step issues
    (``sharding.collectives.record_collective``) over a group past one
    rank, by kind, charged the bytes of its result (all-reduce: its
    input; all-gather: the blocks stacked; reduce-scatter: one block),
    and result + operand bytes as accessed.

Beside them ``StepTrace.memory`` gives the reference's
``memory_analysis`` fields from the live bytes: every storage counted from
its creation until its last tensor dies (``weakref.finalize``), the
arguments live throughout.  ``peak_bytes_est`` is that count's peak;
``alias_bytes`` the arguments the step writes in place (the parameters
and moments under AdamW, the caches under prefill and decode: what the
reference's ``donate_argnums`` aliases); ``output_bytes`` the step's
results, the inputs written in place counted as results;
``temp_bytes = peak - arguments - (outputs - aliases)``, so that
``argument + temp + output - alias`` is the peak, as ``_mem_dict``
sums it.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict


def superstep_launch_targets(n: int, p: int, tile_size: int, *,
                             n_candidates: int = 294,
                             fused: bool = True) -> dict:
    """Analytic per-launch FLOP/byte targets for one d-GLMNET superstep
    (the launch contract ``analysis/audit.py`` holds).

    The model is the DESIGN.md §8 launch contract, f32 everywhere:

    unfused (4+ launches, every (n,)-vector round-trips HBM between them):
      glm_stats       — ~10 flops/row; reads y, xβ, w; writes loss, s, w
      gram+solve      — Gram 2·n·p·T flops reading X once per tile sweep +
                        the (p/T)·T² blocks; sequential solves 4·p·T flops
      matvec          — 2·n·p; reads X again, writes xdb
      alpha_search×2  — ~6·K·n flops; reads y, xβ, xdb, w per phase
                        (two phases: 14-candidate grid, 20-step chain)

    fused (2 launches; s, w, xdb stay on chip):
      stats+gram+solve — the first three rolled into one X pass
      margin+ls        — matvec + ALL candidate losses in one X pass

    Bytes count HBM traffic only (block-resident reuse is the point of the
    fusion): X is (n, p)·4 per pass over the design; (n,)-vectors 4n each.
    """
    T = tile_size
    nt = p // T
    f32 = 4.0
    xbytes = float(n) * p * f32
    vec = float(n) * f32
    stats_f = 10.0 * n
    gram_f = 2.0 * float(n) * p * T + 2.0 * float(n) * p
    solve_f = 4.0 * float(p) * T
    matvec_f = 2.0 * float(n) * p
    ls_f = 6.0 * float(n_candidates) * n
    gram_b = xbytes + nt * (T * T) * f32 + 2.0 * vec
    if fused:
        launches = {
            "stats_gram_solve": {
                "flops": stats_f + gram_f + solve_f,
                "bytes": gram_b + 3.0 * vec + 2.0 * p * f32,
            },
            "margin_ls": {
                "flops": matvec_f + ls_f,
                "bytes": xbytes + 4.0 * vec + float(n_candidates) * f32,
            },
        }
    else:
        grid, chain = 14, 20
        launches = {
            "glm_stats": {"flops": stats_f, "bytes": 6.0 * vec},
            "gram_solve": {"flops": gram_f + solve_f,
                           "bytes": gram_b + 2.0 * p * f32},
            "matvec": {"flops": matvec_f, "bytes": xbytes + vec},
            "alpha_search_grid": {"flops": 6.0 * grid * n,
                                  "bytes": 4.0 * vec},
            "alpha_search_chain": {"flops": 6.0 * chain * n,
                                   "bytes": 4.0 * vec},
        }
    total_f = sum(l["flops"] for l in launches.values())
    total_b = sum(l["bytes"] for l in launches.values())
    return {"fused": fused, "n_launches": len(launches),
            "launches": launches, "total_flops": total_f,
            "total_bytes": total_b,
            "vector_roundtrip_bytes_saved": 0.0 if not fused else 5.0 * vec}


def shared_memory_budget(device) -> int:
    """Bytes of shared memory (static + dynamic) one block may use on the
    card ``device`` after opting in: the budget of the port's kernels."""
    import torch
    return int(torch.cuda.get_device_properties(device)
               .shared_memory_per_block_optin)


def registers_per_sm(device) -> int:
    """32-bit registers of one SM of the card ``device``: a block's
    registers times its threads must fit in them."""
    import torch
    return int(torch.cuda.get_device_properties(device)
               .regs_per_multiprocessor)


# ---------------------------------------------------------------------------
# the traced step: analyze_step (the counterpart of analyze_hlo)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepStats:
    """One card's share of a step: ``HLOStats``' fields and methods."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_bytes_by_kind: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))

    def scaled(self, k: float) -> "StepStats":
        out = StepStats(self.flops * k, self.bytes_accessed * k,
                        self.collective_bytes * k)
        for key, v in self.collective_counts.items():
            out.collective_counts[key] = v * k
        for key, v in self.collective_bytes_by_kind.items():
            out.collective_bytes_by_kind[key] = v * k
        return out

    def add(self, other: "StepStats"):
        self.flops += other.flops
        self.bytes_accessed += other.bytes_accessed
        self.collective_bytes += other.collective_bytes
        for key, v in other.collective_counts.items():
            self.collective_counts[key] += v
        for key, v in other.collective_bytes_by_kind.items():
            self.collective_bytes_by_kind[key] += v

    def as_dict(self):
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "collective_counts": dict(self.collective_counts),
            "collective_bytes_by_kind": dict(self.collective_bytes_by_kind),
        }


@dataclasses.dataclass
class StepTrace:
    """``analyze_step``'s result: the counts, the memory fields, the
    logical collectives in call order (``collectives.collective_trace``'s
    records), the number of aten ops dispatched, the flops by product
    ({(aten op, elements contracted): flops}), and the live bytes' peak
    in each phase of the step: ``forward`` up to the backward,
    ``backward:<name>`` inside the autograd engine once the gradient of
    the parameter ``<name>`` of ``state`` was the last one accumulated
    (``backward:`` before any), ``update`` after it."""
    stats: StepStats
    memory: dict
    collectives: list
    n_ops: int
    phase_peak: dict
    products: dict


# the kind of each logical collective a step issues (the op names of
# collectives.record_collective) by the reference's names, and its
# result's elements from its input's (numel) over a group of ``size``
_COLLECTIVE_KINDS = {
    "all_reduce": ("all-reduce", lambda n, size: n),
    "all_reduce_max": ("all-reduce", lambda n, size: n),
    "all_reduce_many": ("all-reduce", lambda n, size: n),
    "all_gather": ("all-gather", lambda n, size: n * size),
    "reduce_scatter": ("reduce-scatter", lambda n, size: n // size),
}


def collective_stats(events) -> StepStats:
    """The collectives of ``collectives.collective_trace`` records (op,
    dim, size, numel, dtype) as counted in a ``StepStats``: those over
    more than one rank, each charged its result's bytes (and result +
    operand bytes as accessed)."""
    import torch
    out = StepStats()
    for op, _, size, numel, dtype in events:
        if size <= 1:
            continue
        kind, result = _COLLECTIVE_KINDS[op]
        item = torch.empty((), dtype=getattr(torch, dtype)).element_size()
        nbytes = float(result(numel, size) * item)
        out.collective_bytes += nbytes
        out.collective_counts[kind] += 1
        out.collective_bytes_by_kind[kind] += nbytes
        out.bytes_accessed += nbytes + numel * item
    return out


def fake_mode():
    """A fresh ``FakeTensorMode``: tensors made under it carry shapes,
    dtypes and devices and no data (``analyze_step``'s inputs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def _tensors(tree) -> list:
    """The tensors of a nested dict / list / tuple / named tuple."""
    import torch
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


class _Storages:
    """Live bytes of the storages seen, each from its creation until its
    last tensor dies."""

    def __init__(self):
        self.nbytes = {}
        self.live = 0
        self.peak = 0
        self.phase = "forward"
        self.phase_peak = {}

    def key(self, t):
        return t.untyped_storage()._cdata

    def see(self, t) -> int:
        st = t.untyped_storage()
        k = st._cdata
        if k not in self.nbytes:
            n = self.nbytes[k] = int(st.nbytes())
            self.live += n
            self.peak = max(self.peak, self.live)
            self.phase_peak[self.phase] = max(
                self.phase_peak.get(self.phase, 0), self.live)
            weakref.finalize(st, self._free, k)
        return k

    def _free(self, k):
        self.live -= self.nbytes.pop(k)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _make_mode():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry
    aten = torch.ops.aten
    no_fill = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided}

    class _Counter(TorchDispatchMode):
        def __init__(self, storages, arg_keys):
            super().__init__()
            self.st = storages
            self.arg_keys = arg_keys
            self.written = set()
            self.flops = 0
            self.products = {}
            self.bytes = 0
            self.n_ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func.namespace == "prim":        # metadata (prim.device)
                return out
            self.n_ops += 1
            if torch._C._current_graph_task_id() != -1:
                if not self.st.phase.startswith("backward"):
                    self.st.phase = "backward:"
            elif self.st.phase.startswith("backward"):
                self.st.phase = "update"
            packet = func.overloadpacket
            if packet in flop_registry:
                f = flop_registry[packet](*args, **kwargs, out_val=out)
                self.flops += f
                k = (str(packet).split(".")[-1],
                     int(f // max(2 * out.numel(), 1)))
                self.products[k] = self.products.get(k, 0) + f
            ins = _tensors((args, kwargs))
            in_keys = {self.st.key(t) for t in ins}
            writes = [a for a, s in zip(args, func._schema.arguments)
                      if s.alias_info is not None and s.alias_info.is_write
                      and torch.is_tensor(a)]
            for a in writes:
                k = self.st.key(a)
                if k in self.arg_keys:
                    self.written.add(k)
            outs = _tensors(out)
            out_keys = [self.st.see(t) for t in outs]
            moves = packet not in no_fill and (
                writes or not outs
                or not all(k in in_keys for k in out_keys))
            if moves and outs:
                self.bytes += sum(_nbytes(t) for t in ins) + sum(
                    _nbytes(t) for t in {id(t): t for t in outs}.values())
            return out

    return _Counter


def analyze_step(fn, *args, state=None) -> StepTrace:
    """Run ``fn(*args)`` once under the counter and return its
    ``StepTrace``.  ``state``: tensors ``fn`` reads that are not among
    its arguments (a model's parameters), counted as arguments.  With
    fake tensors (made under a ``fake_mode()`` that is current) nothing
    is allocated; with real ones the step really runs."""
    from repro_torch.sharding import collectives
    storages = _Storages()
    arg_tensors = _tensors((args, state))
    arg_keys = {storages.see(t) for t in arg_tensors}
    arg_bytes = storages.live
    mode = _make_mode()(storages, arg_keys)
    hooks = [t.register_post_accumulate_grad_hook(
        lambda _, name=name: setattr(storages, "phase", "backward:" + name))
        for name, t in (state.items() if isinstance(state, dict) else ())
        if t.requires_grad]
    try:
        with collectives.collective_trace() as events, mode:
            out = fn(*args)
    finally:
        for h in hooks:
            h.remove()
    res = _tensors(out)
    out_st = {storages.key(t): int(t.untyped_storage().nbytes())
              for t in res}
    alias = 0
    for t in arg_tensors:
        k = storages.key(t)
        if k in mode.written and k not in out_st:
            out_st[k] = int(t.untyped_storage().nbytes())
    for k in mode.written:
        alias += out_st[k]
    output = sum(out_st.values())
    peak = storages.peak
    memory = {"argument_bytes": arg_bytes, "output_bytes": output,
              "temp_bytes": peak - arg_bytes - (output - alias),
              "alias_bytes": alias, "peak_bytes_est": peak}
    stats = collective_stats(events)
    stats.flops += float(mode.flops)
    stats.bytes_accessed += float(mode.bytes)
    return StepTrace(stats, memory, list(events), mode.n_ops,
                     dict(storages.phase_peak), mode.products)
