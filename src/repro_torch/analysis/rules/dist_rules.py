"""DIST001 / DIST002 — placement and deadlock rules of the mesh.

The JAX package's two rules in the torch form of their hazards: a tensor
placed on a card by hand in code that runs as one rank of a
``torch.distributed`` world (each rank owns its card, picked by
``dist.bootstrap``; a hard-coded card puts every rank on the same one),
and collectives gated on process-local state, so the ranks' programs
diverge and every peer hangs in the collective or the store barrier until
its timeout.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.astutil import FileContext, dotted_name

# Collective / rendezvous entry points: every process in the job must
# execute these the same number of times in the same order.  The JAX
# package's names, then torch.distributed's (and the port's wrappers of
# them); ``new_group`` too, which every rank of the world must call.
COLLECTIVE_CALLS = {
    "barrier", "guarded_barrier", "wait_at_barrier",
    "kv_set", "kv_get", "gather_to_host",
    "psum", "psum_compressed", "pmean", "pmax", "pmin",
    "all_gather", "all_to_all", "ppermute",
    "all_reduce", "all_reduce_many", "broadcast", "broadcast_host",
    "broadcast_object_list", "all_gather_object", "all_gather_into_tensor",
    "gather", "scatter", "reduce", "reduce_scatter_tensor",
    "monitored_barrier", "new_group",
}

# Names whose value differs per process.  Deliberately NOT included:
# ``multiprocess`` / ``num_processes`` / the world size (uniform across the
# job — gating on them is the sanctioned pattern).
PROCESS_LOCAL_MARKERS = {
    "process_index", "process_id", "is_coordinator", "node_id",
    "getpid", "process_count_is_me",  # defensive: any future helper
    "get_rank", "get_local_rank",
}

_CARD_LITERAL = re.compile(r"^cuda:\d+$")


def _names_card(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str) \
        and node.value.startswith("cuda")


class Dist001:
    CODE = "DIST001"
    TITLE = "bare card placement in dist-capable module"
    DOC = (
        "Modules that can run as one rank of a torch.distributed world "
        "must place tensors through device.resolve_device (the card that "
        "dist.bootstrap made current for this rank) or "
        "dist.bootstrap.put_global (this rank's block of a full host "
        "array), not by naming a card: `.cuda(...)`, a \"cuda:<k>\" "
        "literal, `.to(\"cuda...\")` or `device=\"cuda...\"`.  A card "
        "named in code is the same card on every rank: ranks that should "
        "each own one pile onto it, and NCCL, which needs a card per rank, "
        "hangs or fails.  Waive sanctioned sites (the implementations of "
        "resolve_device and put_global) with `# lint: allow DIST001 — "
        "reason`."
    )

    @staticmethod
    def _dist_capable(ctx: FileContext) -> bool:
        p = ctx.relpath.replace("\\", "/")
        if "/dist/" in p or "/checkpoint/" in p:
            return True
        return ctx.imports("repro_torch.dist")

    def check(self, ctx: FileContext):
        if not self._dist_capable(ctx):
            return
        covered = set()      # literals already reported with their call
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            device_kw = [k.value for k in node.keywords
                         if k.arg == "device" and _names_card(k.value)]
            if isinstance(func, ast.Attribute) and func.attr == "cuda":
                msg = "`.cuda()` in a dist-capable module places on a card"
            elif isinstance(func, ast.Attribute) and func.attr == "to" \
                    and node.args and _names_card(node.args[0]):
                msg = ("`.to(\"cuda...\")` in a dist-capable module places "
                       "on a card")
                covered.add(id(node.args[0]))
            elif device_kw:
                msg = (f"{dotted_name(func) or 'call'}(device=\"cuda...\") "
                       "places on a card")
            else:
                continue
            covered.update(id(v) for v in device_kw)
            yield ctx.violation(
                self.CODE, node,
                f"{msg} by hand — use device.resolve_device or "
                "dist.bootstrap.put_global")
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    _CARD_LITERAL.match(node.value) and \
                    id(node) not in covered:
                yield ctx.violation(
                    self.CODE, node,
                    f"card literal {node.value!r} in a dist-capable module "
                    "— every rank would use that card; take the rank's own "
                    "from device.resolve_device(None)")


class Dist002:
    CODE = "DIST002"
    TITLE = "collective reachable under process-local control flow"
    DOC = (
        "barrier/kv_set/kv_get/all_reduce/broadcast/gather_to_host/"
        "new_group (and every other collective) must execute on every "
        "process, in the same order.  An `if ctx.is_coordinator:` (or any "
        "test derived from process_id/get_rank()/host-local state) around "
        "a collective means peers wait forever — the paper's synchronous "
        "merge step deadlocks.  The sanctioned pattern: branch on "
        "process-local state for the *side effect* (write the file, print "
        "the line) and keep the collective OUTSIDE the branch, as "
        "checkpoint/manager.py does.  Early returns under process-local "
        "tests are equally fatal when a collective follows later in the "
        "same function."
    )

    @staticmethod
    def _process_local(test: ast.expr) -> bool:
        for sub in ast.walk(test):
            if isinstance(sub, (ast.Name, ast.Attribute)):
                tail = dotted_name(sub).rsplit(".", 1)[-1]
                if tail in PROCESS_LOCAL_MARKERS:
                    return True
        return False

    @staticmethod
    def _collectives_in(nodes) -> list:
        out = []
        for stmt in nodes:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call):
                    tail = dotted_name(sub.func).rsplit(".", 1)[-1]
                    if tail in COLLECTIVE_CALLS:
                        out.append((sub, tail))
        return out

    def check(self, ctx: FileContext):
        ifs = [n for n in ast.walk(ctx.tree) if isinstance(n, ast.If)
               and self._process_local(n.test)]
        for if_node in ifs:
            # (a) a collective inside either branch of the conditional
            for call, tail in self._collectives_in(if_node.body
                                                   + if_node.orelse):
                yield ctx.violation(
                    self.CODE, call,
                    f"collective `{tail}` under a process-local "
                    "conditional — peers that don't take this branch "
                    "will hang; hoist the collective out of the branch")
            # (b) divergent early exit: the branch returns/raises, and a
            # collective appears later in the innermost enclosing function
            exits = [s for s in if_node.body
                     if isinstance(s, (ast.Return, ast.Raise,
                                       ast.Continue, ast.Break))]
            enclosing = ctx.enclosing_functions(if_node)
            if not exits or not enclosing:
                continue
            fn = enclosing[0]
            later = [s for s in ast.walk(fn)
                     if isinstance(s, ast.Call)
                     and getattr(s, "lineno", 0) > if_node.body[-1].lineno
                     and dotted_name(s.func).rsplit(".", 1)[-1]
                     in COLLECTIVE_CALLS]
            if later:
                tails = {dotted_name(s.func).rsplit(".", 1)[-1]
                         for s in later}
                yield ctx.violation(
                    self.CODE, exits[0],
                    "early exit under a process-local conditional while "
                    f"collectives ({', '.join(sorted(tails))}) follow in "
                    "the same function — exiting processes skip the "
                    "rendezvous and peers hang")
