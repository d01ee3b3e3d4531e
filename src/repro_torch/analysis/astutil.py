"""Shared AST plumbing for the lint rules (repro_torch.analysis.rules); a
copy of the JAX package's ``analysis/astutil.py``.

Everything here is pure stdlib ``ast`` — the linter must import cleanly
without torch or a card (CI containers, pre-commit hooks), so no torch,
repro_torch or jax imports are allowed in this module or in any rule
module.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Iterator, Optional

# `# lint: allow CODE — reason` on the flagged line or the line above it
# waives one violation in place; `# noqa: CODE` is accepted as a synonym.
_WAIVER_RE = re.compile(r"#\s*(?:lint:\s*allow|noqa:?)\s+([A-Z]+\d+)")


@dataclasses.dataclass(frozen=True)
class Violation:
    code: str
    path: str          # repo-relative posix path
    line: int
    col: int
    scope: str         # enclosing qualname, e.g. "GLMSolver._run"
    message: str

    def fingerprint(self) -> tuple:
        # Line numbers churn on unrelated edits; (code, path, scope) is the
        # stable identity the baseline ratchets on.
        return (self.code, self.path, self.scope)

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.code} "
                f"[{self.scope}] {self.message}")


def dotted_name(node: ast.AST) -> str:
    """'torch.mm' for Attribute chains, 'float' for Names, '' else."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def base_name(node: ast.AST) -> Optional[str]:
    """Underlying variable of an expression: m['f'] -> m, x.item() -> x."""
    while True:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, (ast.Subscript, ast.Attribute, ast.Starred)):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            return None


def assigned_names(target: ast.AST) -> Iterator[str]:
    """Name ids bound by an assignment target (tuples/lists included)."""
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from assigned_names(elt)
    elif isinstance(target, ast.Starred):
        yield from assigned_names(target.value)


class FileContext:
    """One parsed source file plus the derived maps every rule needs."""

    def __init__(self, relpath: str, text: str):
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=relpath)
        self.parents: dict = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self._imports = {
            node.module or ""
            for node in ast.walk(self.tree)
            if isinstance(node, ast.ImportFrom)
        } | {
            alias.name
            for node in ast.walk(self.tree)
            if isinstance(node, ast.Import)
            for alias in node.names
        }

    def imports(self, prefix: str) -> bool:
        return any(m == prefix or m.startswith(prefix + ".")
                   for m in self._imports)

    def enclosing_functions(self, node: ast.AST) -> list:
        """Innermost-first chain of enclosing FunctionDef/AsyncFunctionDef."""
        out = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(cur)
            cur = self.parents.get(cur)
        return out

    def qualname(self, node: ast.AST) -> str:
        parts = []
        cur = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(parts)) or "<module>"

    def waived(self, code: str, lineno: int) -> bool:
        for ln in (lineno, lineno - 1):
            if 1 <= ln <= len(self.lines):
                for m in _WAIVER_RE.finditer(self.lines[ln - 1]):
                    if m.group(1) == code:
                        return True
        return False

    def violation(self, code: str, node: ast.AST, message: str) -> Violation:
        return Violation(code=code, path=self.relpath, line=node.lineno,
                         col=node.col_offset, scope=self.qualname(node),
                         message=message)
