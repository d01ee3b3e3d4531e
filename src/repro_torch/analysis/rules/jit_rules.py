"""JIT001 — rebuild hazards against the one-build session contract.

The contract the port keeps from the JAX package: ONE superstep closure,
built once per key (``core/solver.py``'s cache, ``GLMSolver.compile_count``),
serves a whole lambda path — lambda, fold masks, weights, offsets and
penalty factors are RUNTIME arguments.  Two ways code re-breaks that:

* reading ``config.lam1`` / ``config.lam2`` inside a closure of a
  ``make_*superstep`` builder (or a function compiled by ``torch.compile``
  / ``torch.jit.script``) bakes lambda into what is built, so a closure
  shared by key across lambdas would run with the wrong one, and every
  lambda would need its own build;
* calling ``torch.compile``, ``torch.jit.script``/``trace`` or
  ``torch.utils.cpp_extension.load*`` inside a loop (a comprehension
  too) builds afresh each iteration, which never hits a cache (and
  ``load`` may run a compiler).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.astutil import FileContext, dotted_name

# Config fields that the one-build contract moved to runtime arguments.
RUNTIME_ONLY_FIELDS = {"lam1", "lam2"}

_BUILDER_MARKER = "superstep"

# decorators (or partial(...) of them) whose function body is compiled
_COMPILING_DECORATORS = ("jit", "compile", "script")

# calls that build (compile, script, trace or load a native extension)
_BUILD_CALLS = ("torch.compile", "torch.jit.script", "torch.jit.trace",
                "cpp_extension.load", "cpp_extension.load_inline")


_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
          ast.DictComp, ast.GeneratorExp)


def _is_build_call(name: str) -> bool:
    return any(name == c or name.endswith("." + c) for c in _BUILD_CALLS)


class Jit001:
    CODE = "JIT001"
    TITLE = "lambda baked into a built closure / build per iteration"
    DOC = (
        "Inside closures defined in make_*superstep builders (the "
        "superstep a session builds once and shares by key) or functions "
        "compiled by torch.compile/torch.jit.script, reading "
        "config.lam1/config.lam2 bakes lambda into what is built — pass it "
        "through the `lams` runtime pair instead.  torch.compile, "
        "torch.jit.script/trace and torch.utils.cpp_extension.load* called "
        "inside a loop build afresh every iteration; hoist them out."
    )

    @staticmethod
    def _is_compiled(fn: ast.AST) -> bool:
        for dec in getattr(fn, "decorator_list", []):
            target = dec.func if isinstance(dec, ast.Call) else dec
            name = dotted_name(target)
            if name.endswith(_COMPILING_DECORATORS):
                return True
            # functools.partial(torch.compile, ...) style
            if isinstance(dec, ast.Call) and name.endswith("partial") \
                    and dec.args and dotted_name(dec.args[0]).endswith(
                        _COMPILING_DECORATORS):
                return True
        return False

    def _built_contexts(self, ctx: FileContext):
        """FunctionDefs whose body is built once and reused: compiled by a
        decorator, or defined inside a superstep builder
        (make_superstep/make_streaming_superstep return closures the
        session caches by key)."""
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if self._is_compiled(fn):
                yield fn
                continue
            enclosing = ctx.enclosing_functions(fn)
            if any(_BUILDER_MARKER in e.name and e.name.startswith("make_")
                   for e in enclosing):
                yield fn

    def check(self, ctx: FileContext):
        seen: set = set()
        for fn in self._built_contexts(ctx):
            for node in ast.walk(fn):
                if isinstance(node, ast.Attribute) \
                        and node.attr in RUNTIME_ONLY_FIELDS \
                        and id(node) not in seen:
                    seen.add(id(node))
                    yield ctx.violation(
                        self.CODE, node,
                        f"`.{node.attr}` read inside a built closure bakes "
                        "lambda into it — the one-build session contract "
                        "passes lambda via the `lams` runtime pair")
        for loop in ast.walk(ctx.tree):
            if not isinstance(loop, _LOOPS):
                continue
            for node in ast.walk(loop):
                if isinstance(node, ast.Call) \
                        and _is_build_call(dotted_name(node.func)) \
                        and id(node) not in seen:
                    seen.add(id(node))
                    yield ctx.violation(
                        self.CODE, node,
                        f"{dotted_name(node.func)}(...) inside a loop — "
                        "each iteration builds afresh and misses every "
                        "cache; hoist it out of the loop")
