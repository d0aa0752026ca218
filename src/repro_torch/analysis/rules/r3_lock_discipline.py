"""R3: lock discipline — shared-state writes happen under the module's lock.

The serving stack is threaded end to end: gateway submitters,
per-tenant batcher collectors, the shared flush pool, the session pipeline
and sync callers all touch the same objects.  Their invariant is simple
and easy to erode: every mutation of shared state goes through the owning
object's lock (``_lock`` / ``_cv`` / ``_plan_lock`` ...).  A bare
``self.counter += 1`` is a read-modify-write that silently loses updates
under contention — metrics drift first, then someone keys a decision off
them.

In the configured threaded modules, outside constructors:

* augmented assignments to ANY attribute (``x.attr += 1`` — the classic
  racy counter bump), and
* assignments/deletions of underscore-prefixed ``self._state`` (including
  subscript stores like ``self._cache[k] = v``)

must sit inside ``with self.<lock>:`` for one of the module's configured
lock names.  A module configured with no lock (the engine, whose counters
are obs instruments) may do neither outside its constructors.  Objects
documented as externally locked (e.g. ``LruDict``, whose callers hold their
own locks) carry inline waivers saying so.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from repro_torch.analysis.config import THREADED_MODULES, UNLOCKED_FUNCTIONS
from repro_torch.analysis.lint import (FileContext, Rule, Violation, self_attr,
                                 under_lock)


def _flatten_targets(target: ast.AST) -> List[ast.AST]:
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[ast.AST] = []
        for elt in target.elts:
            out.extend(_flatten_targets(elt))
        return out
    return [target]


def _self_underscore_target(node: ast.AST) -> Optional[str]:
    """'_attr' if node writes ``self._attr`` (directly or via subscript)."""
    if isinstance(node, ast.Subscript):
        node = node.value
    attr = self_attr(node)
    if attr is not None and attr.startswith("_"):
        return attr
    return None


class R3LockDiscipline(Rule):
    rule_id = "R3"
    title = "lock discipline: shared-state mutation under the module lock"

    def applies(self, ctx: FileContext) -> bool:
        return ctx.rel in THREADED_MODULES

    def _in_constructor(self, ctx: FileContext, node: ast.AST) -> bool:
        fn = ctx.enclosing_function(node)
        while fn is not None:
            if fn.name in UNLOCKED_FUNCTIONS:
                return True
            fn = ctx.enclosing_function(fn)
        return False

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        locks = THREADED_MODULES[ctx.rel]
        for node in ast.walk(ctx.tree):
            for target, kind in self._mutations(node):
                if self._in_constructor(ctx, node):
                    continue
                if under_lock(ctx, node, locks):
                    continue
                where = (f"outside 'with self.{locks[0]}:' (configured "
                         f"locks for this module: {', '.join(locks)})"
                         if locks else
                         "in a module that owns no lock (route shared "
                         "counters through repro_torch.obs)")
                yield ctx.violation(
                    node, self.rule_id,
                    f"{kind} {where} — unlocked read-modify-write loses "
                    f"updates under concurrent callers")

    def _mutations(self, node: ast.AST) -> Iterator[Tuple[ast.AST, str]]:
        if isinstance(node, ast.AugAssign):
            if isinstance(node.target, ast.Attribute):
                yield (node.target,
                       f"read-modify-write of shared counter "
                       f"'{ast.unparse(node.target)}'")
            else:
                attr = _self_underscore_target(node.target)
                if attr is not None:
                    yield node.target, f"mutation of shared field 'self.{attr}'"
        elif isinstance(node, ast.Assign):
            for target in _flatten_targets_all(node.targets):
                attr = _self_underscore_target(target)
                if attr is not None:
                    yield target, f"write to shared field 'self.{attr}'"
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            attr = _self_underscore_target(node.target)
            if attr is not None:
                yield node.target, f"write to shared field 'self.{attr}'"
        elif isinstance(node, ast.Delete):
            for target in node.targets:
                attr = _self_underscore_target(target)
                if attr is not None:
                    yield target, f"delete of shared field 'self.{attr}'"


def _flatten_targets_all(targets: List[ast.AST]) -> List[ast.AST]:
    out: List[ast.AST] = []
    for t in targets:
        out.extend(_flatten_targets(t))
    return out
