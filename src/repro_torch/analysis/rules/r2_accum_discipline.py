"""R2: accumulation discipline — histogram sums carry an explicit dtype.

The overflow contract: every device-side accumulation of histogram or
volume values happens in the dtype of one explicit
:class:`~repro_torch.core.accum.AccumPolicy` (int32-checked / int64-exact),
so a result's precision is fully described by the policy it advertises.
The contract breaks *quietly* when a reduction inherits whatever dtype its
operand happened to carry: an upstream refactor that changes a weight
dtype flips the accumulator width of every downstream sum with no local
diff.

In the accumulation modules this rule requires, per function:

* every ``.sum(...)`` / ``torch.sum(...)`` passes an explicit ``dtype=``
  keyword,
* the target of every ``index_add_`` / ``scatter_add_`` is allocated in the
  same function by a call with an explicit ``dtype=`` keyword
  (``torch.zeros(..., dtype=acc)``), and
* the operand of every virtual-mesh reduction, ``psum(...)`` /
  ``psum_scatter(...)`` (``repro_torch.launch.mesh``), is *locally*
  blessed — produced (possibly through dtype-preserving ``pad`` /
  ``reshape`` / ``view`` / indexing) by a cast (``.to(<dtype>)``,
  ``.long()``, ``.int()``) or an explicit-dtype sum inside the same
  function.

The blessing walk is a straight-line approximation (assignments in lexical
order), which is exactly the point: the cast must be visible right where
the reduction is, not inferred across call boundaries.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from repro_torch.analysis.config import ACCUM_MODULES
from repro_torch.analysis.lint import FileContext, Rule, Violation, call_path

_REDUCTIONS = ("psum", "psum_scatter")
_SCATTER_ADDS = ("index_add_", "scatter_add_")
_CAST_METHODS = ("long", "int")
#: dtype-preserving wrappers the blessing may pass through (first arg)
_PRESERVING = ("torch.nn.functional.pad", "F.pad", "torch.reshape",
               "torch.squeeze", "torch.unsqueeze")
_PRESERVING_METHODS = ("reshape", "view", "squeeze", "unsqueeze", "flatten",
                       "contiguous")
_TORCH_DTYPES = ("int8", "int16", "int32", "int64", "uint8", "long", "int",
                 "float16", "float32", "float64", "bfloat16", "half",
                 "float", "double", "bool")


def _has_dtype_kwarg(call: ast.Call) -> bool:
    return any(kw.arg == "dtype" for kw in call.keywords)


def _is_sum(call: ast.Call) -> bool:
    return (call_path(call.func) == "torch.sum"
            or (isinstance(call.func, ast.Attribute)
                and call.func.attr == "sum"))


def _is_reduction(call: ast.Call) -> bool:
    path = call_path(call.func)
    return path.rsplit(".", 1)[-1] in _REDUCTIONS if path else False


def _is_dtype_expr(expr: ast.AST, dtype_names: Set[str]) -> bool:
    """``x.dtype``, ``torch.int32``, or a name bound to one of those."""
    if isinstance(expr, ast.Name):
        return expr.id in dtype_names
    if isinstance(expr, ast.Attribute):
        if expr.attr == "dtype":
            return True
        return (call_path(expr) == f"torch.{expr.attr}"
                and expr.attr in _TORCH_DTYPES)
    return False


def _is_cast(call: ast.Call, dtype_names: Set[str]) -> bool:
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr in _CAST_METHODS and not call.args:
        return True
    if call.func.attr != "to":
        return False
    return _has_dtype_kwarg(call) or any(
        _is_dtype_expr(a, dtype_names) for a in call.args)


def _blessed_expr(expr: ast.AST, blessed: Set[str],
                  dtype_names: Set[str]) -> bool:
    if isinstance(expr, ast.Name):
        return expr.id in blessed
    if isinstance(expr, ast.IfExp):
        return (_blessed_expr(expr.body, blessed, dtype_names)
                and _blessed_expr(expr.orelse, blessed, dtype_names))
    if isinstance(expr, ast.Subscript):
        return _blessed_expr(expr.value, blessed, dtype_names)
    if isinstance(expr, ast.Call):
        if _is_cast(expr, dtype_names):
            return True
        if _is_sum(expr):
            return _has_dtype_kwarg(expr)
        if (isinstance(expr.func, ast.Attribute)
                and expr.func.attr in _PRESERVING_METHODS):
            return _blessed_expr(expr.func.value, blessed, dtype_names)
        if call_path(expr.func) in _PRESERVING and expr.args:
            return _blessed_expr(expr.args[0], blessed, dtype_names)
    return False


def _assigns_before(fn: ast.AST, line: int):
    """Single-name assignments of ``fn`` above ``line``, in lexical order."""
    return sorted((n for n in ast.walk(fn)
                   if isinstance(n, ast.Assign) and n.lineno < line
                   and len(n.targets) == 1
                   and isinstance(n.targets[0], ast.Name)),
                  key=lambda a: a.lineno)


class R2AccumDiscipline(Rule):
    rule_id = "R2"
    title = "accumulation discipline: explicit AccumPolicy dtype on sums"

    def applies(self, ctx: FileContext) -> bool:
        return ctx.rel in ACCUM_MODULES

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if _is_sum(node) and not _has_dtype_kwarg(node):
                yield ctx.violation(
                    node, self.rule_id,
                    "a sum on the histogram path must pass an explicit "
                    "dtype= derived from the AccumPolicy "
                    "(e.g. dtype=sig.accum.dtype)")
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _SCATTER_ADDS):
                if not self._target_allocated(ctx, node):
                    yield ctx.violation(
                        node, self.rule_id,
                        f"the target of {node.func.attr} must be allocated "
                        f"in this function with an explicit dtype= from the "
                        f"AccumPolicy (torch.zeros(..., dtype=acc)); an "
                        f"accumulator of inherited dtype breaks the "
                        f"overflow contract")
            elif _is_reduction(node) and node.args:
                if not self._operand_blessed(ctx, node):
                    yield ctx.violation(
                        node, self.rule_id,
                        f"{call_path(node.func)} operand must be explicitly "
                        f"cast to the AccumPolicy dtype in this function "
                        f"(.to(dtype) or .sum(..., dtype=...)); inheriting "
                        f"the operand's incidental dtype breaks the "
                        f"overflow contract")

    @staticmethod
    def _target_allocated(ctx: FileContext, call: ast.Call) -> bool:
        target = call.func.value
        fn = ctx.enclosing_function(call)
        if fn is None or not isinstance(target, ast.Name):
            return False
        last: Optional[ast.Assign] = None
        for assign in _assigns_before(fn, call.lineno):
            if assign.targets[0].id == target.id:
                last = assign
        return (last is not None and isinstance(last.value, ast.Call)
                and _has_dtype_kwarg(last.value))

    @staticmethod
    def _operand_blessed(ctx: FileContext, call: ast.Call) -> bool:
        blessed: Set[str] = set()
        dtype_names: Set[str] = {"dtype"}
        fn = ctx.enclosing_function(call)
        if fn is not None:
            # straight-line pass: bless/unbless single-name assignments in
            # lexical order up to the reduction
            for assign in _assigns_before(fn, call.lineno):
                name = assign.targets[0].id
                if _is_dtype_expr(assign.value, dtype_names):
                    dtype_names.add(name)
                if _blessed_expr(assign.value, blessed, dtype_names):
                    blessed.add(name)
                else:
                    blessed.discard(name)
        return _blessed_expr(call.args[0], blessed, dtype_names)
