"""HASH001 — builtin hash() in the ingestion layer.

Python's ``hash()`` for str/bytes is salted per process (PYTHONHASHSEED),
so two processes of one job disagree on every hashed feature slot —
exactly the silent cross-process divergence
``repro_torch.io.hashing.splitmix64`` exists to prevent (the feature
hashing is bit-stable across processes, runs, and machines, and bit-equal
to the JAX package's).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.astutil import FileContext, dotted_name


class Hash001:
    CODE = "HASH001"
    TITLE = "builtin hash() in io/ (process-salted, breaks SPMD stability)"
    DOC = (
        "In src/repro_torch/io/, feature/chunk identity must come from "
        "repro_torch.io.hashing (splitmix64): builtin hash() is salted per "
        "process via PYTHONHASHSEED, so hashed slots differ between the "
        "processes of one job and between runs — weights stop lining up "
        "with features.  hashlib digests are also acceptable (stable, "
        "slower)."
    )

    def check(self, ctx: FileContext):
        p = ctx.relpath.replace("\\", "/")
        if "/io/" not in p and not p.startswith("io/"):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) \
                    and dotted_name(node.func) == "hash":
                yield ctx.violation(
                    self.CODE, node,
                    "builtin hash() is process-salted (PYTHONHASHSEED) — "
                    "use repro_torch.io.hashing.splitmix64 for "
                    "cross-process stable feature/chunk identity")
