"""R5: epoch fencing — cache inserts are dominated by a generation check.

The invalidation protocol: ``invalidate()`` bumps an epoch/generation
counter under the owning lock, and every slow path that computes a value
OUTSIDE the lock (tuple-set build, plan, store upload, query dispatch)
re-checks the counter before inserting.  Results computed from
pre-mutation data may be *served* once — the caller asked before the
mutation — but must never be *cached*, or a stale histogram outlives the
invalidation forever.

The rule: in the configured modules, a ``.put(...)`` into one of the named
session/gateway caches must either pass a ``generation=`` keyword (the
:class:`~repro_torch.serve.result_cache.ResultCache` protocol) or share its
function with a comparison against one of the module's fence names
(``_data_epoch`` / ``epoch`` / ``generation``) on an earlier line — the
static shadow of "the insert is dominated by an epoch comparison".

Subscript assignment (``self._cache[key] = value``) into a fenced cache is
the same insert in different spelling — the incremental-ingest append path
patches cached tuple sets in place this way — and is held to the same
standard (no ``generation=`` escape hatch exists for it: only the
dominating comparison counts).
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.config import EPOCH_FENCED_CACHES
from repro_torch.analysis.lint import FileContext, Rule, Violation


def _mentions_fence(node: ast.AST, fences) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in fences:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in fences:
            return True
    return False


class R5EpochFence(Rule):
    rule_id = "R5"
    title = "epoch fencing: cache puts dominated by a generation check"

    def applies(self, ctx: FileContext) -> bool:
        return ctx.rel in EPOCH_FENCED_CACHES

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        cache_attrs, fences = EPOCH_FENCED_CACHES[ctx.rel]
        for node in ast.walk(ctx.tree):
            target = self._cache_insert(node, cache_attrs)
            if target is None:
                continue
            if (isinstance(node, ast.Call)
                    and any(kw.arg == "generation" for kw in node.keywords)):
                continue
            if self._fenced(ctx, node, fences):
                continue
            yield ctx.violation(
                node, self.rule_id,
                f"insert into {ast.unparse(target)} is not dominated by an "
                f"epoch/generation comparison ({', '.join(fences)}) and "
                f"passes no generation= — a result computed from "
                f"pre-mutation data could outlive invalidate()")

    @staticmethod
    def _cache_insert(node: ast.AST, cache_attrs):
        """The cache expression this node inserts into, or None.

        Two spellings count: ``<cache>.put(...)`` and the append path's
        in-place patch ``<cache>[key] = value``.
        """
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "put"
                and isinstance(node.func.value, ast.Attribute)
                and node.func.value.attr in cache_attrs):
            return node.func.value
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Subscript)
                        and isinstance(tgt.value, ast.Attribute)
                        and tgt.value.attr in cache_attrs):
                    return tgt.value
        return None

    def _fenced(self, ctx: FileContext, put: ast.Call, fences) -> bool:
        fn = ctx.enclosing_function(put)
        if fn is None:
            return False
        for sub in ast.walk(fn):
            if (isinstance(sub, ast.Compare)
                    and sub.lineno <= put.lineno
                    and _mentions_fence(sub, fences)):
                return True
        return False
