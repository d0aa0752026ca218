"""R4: no host synchronization in dispatch hot paths.

The engine's latency model assumes ``dispatch_plans`` is purely
*asynchronous*: torch enqueues device work on the stream and returns, so
the session pipeline overlaps planning of query k+1 with device compute of
query k, and a burst keeps several queries in flight.  One stray
``.cpu()`` / ``.item()`` / ``.tolist()`` / ``.numpy()`` / ``.to("cpu")`` /
``torch.cuda.synchronize()`` / ``np.asarray(tensor)`` in the dispatch path
turns that into a synchronous round-trip per group — the pipeline still
"works", it just quietly serializes.

Host syncs are confined to the configured collection functions
(``_collect`` and the ``collect_*`` entry points, where blocking is the
documented contract); anywhere else in the module they are flagged.  The
rule cannot tell a tensor from a host array, so an ``np.asarray`` of host
data carries a waiver saying so.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.config import (HOST_SYNC_ALLOWED, HOST_SYNC_CALLS,
                                         HOST_SYNC_METHODS)
from repro_torch.analysis.lint import FileContext, Rule, Violation, call_path


def _names_cpu(expr: ast.AST) -> bool:
    """``"cpu"`` / ``"cpu:0"`` or ``torch.device("cpu")``."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value.split(":", 1)[0] == "cpu"
    return (isinstance(expr, ast.Call)
            and call_path(expr.func) == "torch.device"
            and bool(expr.args) and _names_cpu(expr.args[0]))


def _sync_spelling(node: ast.Call) -> Optional[str]:
    path = call_path(node.func)
    if path in HOST_SYNC_CALLS:
        return path
    if not isinstance(node.func, ast.Attribute):
        return None
    attr = node.func.attr
    if attr in HOST_SYNC_METHODS:
        return f"{path}()" if path == "torch.cuda.synchronize" else f".{attr}()"
    if attr == "to" and (any(_names_cpu(a) for a in node.args) or any(
            kw.arg == "device" and _names_cpu(kw.value)
            for kw in node.keywords)):
        return '.to("cpu")'
    return None


class R4HostSync(Rule):
    rule_id = "R4"
    title = "no host sync outside collection functions"

    def applies(self, ctx: FileContext) -> bool:
        return ctx.rel in HOST_SYNC_ALLOWED

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        allowed = HOST_SYNC_ALLOWED[ctx.rel]
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            spelling = _sync_spelling(node)
            if spelling is None:
                continue
            fn = ctx.enclosing_function(node)
            if fn is not None and fn.name in allowed:
                continue
            where = fn.name if fn is not None else "<module>"
            yield ctx.violation(
                node, self.rule_id,
                f"{spelling} in '{where}' blocks the async dispatch path "
                f"(host syncs belong in {', '.join(allowed)} only)")
