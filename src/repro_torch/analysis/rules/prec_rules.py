"""PREC001 — a bf16 product without an fp32 result, or TF32 turned on.

``precision="bf16"`` (the fused Jacobi superstep's mode) rounds the
*inputs* of its Gram and margin products to bf16 and keeps every sum in
float32: the hand-written kernels (K3, K5, K6) accumulate in fp32
registers, and the plain versions widen the rounded inputs
(``x.to(torch.bfloat16).float()``) before the product
(``kernels/ref.py``).  A torch product of bf16 tensors rounds its *result*
to bf16 (8-bit mantissa): Gram matrices lose positive-definiteness and
Armijo sums drift.  Torch has no ``preferred_element_type``, so the rule
flags any product with a bf16 operand that was not widened first.

The port's other way to lose the fp32 accumulator is TF32: with
``allow_tf32 = True`` or ``set_float32_matmul_precision("high")`` a
float32 matrix product keeps about 10 bits of each input, and the 1e-5
bar on beta breaks (ROADMAP ground rule "fp32 means full precision").
"""
from __future__ import annotations

import ast

from repro_torch.analysis.astutil import FileContext, dotted_name

PRODUCT_CALLS = {"matmul", "mm", "bmm", "mv", "dot", "einsum", "addmm"}
_BF16_METHODS = {"bfloat16", "half"}
_TF32_PRECISIONS = {"high", "medium"}


def _names_bf16(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value in ("bfloat16",
                                                         "float16"):
        return True
    name = dotted_name(node)
    return name.endswith("bfloat16") or name.endswith("float16") \
        or name.endswith(".half")


def _is_bf16_cast(node: ast.AST) -> bool:
    """x.to(torch.bfloat16) / x.to(dtype=torch.bfloat16) / x.bfloat16() /
    x.half() / f(..., dtype=torch.bfloat16): a tensor rounded to 16 bits
    (a widening call around it, ``.float()``, makes it fp32 again)."""
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    if isinstance(func, ast.Attribute):
        if func.attr in _BF16_METHODS and not node.args:
            return True
        if func.attr == "to" and any(_names_bf16(a) for a in node.args):
            return True
    return any(k.arg == "dtype" and _names_bf16(k.value)
               for k in node.keywords)


class Prec001:
    CODE = "PREC001"
    TITLE = "bf16 product without an fp32 result, or TF32 turned on"
    DOC = (
        "A torch product (torch.matmul/mm/bmm/mv/dot/einsum/addmm, their "
        "tensor methods, or `@`) of a bf16 operand rounds its result to "
        "bf16 — the Gram/margin sums the line search trusts go wrong at "
        "sizes the tests never reach.  Widen the rounded inputs first "
        "(x.to(torch.bfloat16).float(), as kernels/ref.py does) or use a "
        "hand-written kernel with fp32 accumulators.  Turning TF32 on "
        "(allow_tf32 = True, set_float32_matmul_precision('high'|"
        "'medium')) loses the fp32 accumulator of every float32 product."
    )

    def check(self, ctx: FileContext):
        yield from self._check_products(ctx)
        yield from self._check_tf32(ctx)

    def _check_products(self, ctx: FileContext):
        seen = set()   # scopes nest (module ⊃ def ⊃ def): report each once
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Module)):
                continue
            # first pass: names bound to bf16 casts in this scope
            bf16_names = set()
            for node in ast.iter_child_nodes(fn):
                for stmt in ast.walk(node):
                    if isinstance(stmt, ast.Assign) \
                            and _is_bf16_cast(stmt.value):
                        for tgt in stmt.targets:
                            if isinstance(tgt, ast.Name):
                                bf16_names.add(tgt.id)

            def is_bf16(expr):
                # a transposed or reshaped bf16 name is still bf16
                while isinstance(expr, ast.Attribute) and expr.attr in (
                        "T", "mT", "H"):
                    expr = expr.value
                return _is_bf16_cast(expr) or (
                    isinstance(expr, ast.Name) and expr.id in bf16_names)

            for node in ast.walk(fn):
                if id(node) in seen:
                    continue
                if isinstance(node, ast.Call):
                    name = dotted_name(node.func)
                    if name.rsplit(".", 1)[-1] not in PRODUCT_CALLS:
                        continue
                    operands = list(node.args)
                    if isinstance(node.func, ast.Attribute) and \
                            not name.startswith(("torch.", "np.")):
                        operands.append(node.func.value)   # a.mm(b)
                    if any(is_bf16(a) for a in operands):
                        seen.add(id(node))
                        yield ctx.violation(
                            self.CODE, node,
                            f"{name}() with a bf16 operand rounds its "
                            "result to bf16 — widen the operands first "
                            "(.to(torch.bfloat16).float()) or use a kernel "
                            "with fp32 accumulators")
                elif isinstance(node, ast.BinOp) \
                        and isinstance(node.op, ast.MatMult):
                    if is_bf16(node.left) or is_bf16(node.right):
                        seen.add(id(node))
                        yield ctx.violation(
                            self.CODE, node,
                            "`@` with a bf16 operand rounds its result to "
                            "bf16 — widen the operands first "
                            "(.to(torch.bfloat16).float())")

    def _check_tf32(self, ctx: FileContext):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign):
                if isinstance(node.value, ast.Constant) and \
                        node.value.value is True and any(
                            isinstance(t, ast.Attribute)
                            and t.attr == "allow_tf32"
                            for t in node.targets):
                    yield ctx.violation(
                        self.CODE, node,
                        "allow_tf32 = True drops float32 products to TF32 "
                        "— fp32 means full precision (keep it False)")
            elif isinstance(node, ast.Call) and dotted_name(
                    node.func).endswith("set_float32_matmul_precision") \
                    and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and node.args[0].value in _TF32_PRECISIONS:
                yield ctx.violation(
                    self.CODE, node,
                    f"set_float32_matmul_precision({node.args[0].value!r}) "
                    "drops float32 products to TF32 — keep \"highest\"")
