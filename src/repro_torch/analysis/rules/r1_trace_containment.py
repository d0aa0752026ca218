"""R1: trace containment — programs and kernel libraries stay behind the
runtime and the kernels.

The port's counterpart of the JAX package's rule.  There, every traced
program lives in the ``PlanSignature``-keyed executable cache, so warm
queries never retrace.  Here the runtime's :class:`~repro_torch.runtime.
cache.ExecutableCache` keys every built program the same way, and
``kernels/`` builds and loads each hand-written CUDA library once
(``kernels/_build.py``'s ``Library``, keyed by a hash of its source).  A
``torch.compile``, ``torch.jit.script`` / ``trace``, CUDA graph capture
(``torch.cuda.graph`` / ``CUDAGraph`` / ``make_graphed_callables``) or
direct library load (``ctypes.CDLL``, ``_build.Library(``) anywhere outside
``runtime/`` and ``kernels/`` builds code neither can see: it recompiles or
recaptures on every shape, or loads a library the smoke's build never
compiled or counted.

The rule flags every *reference* to those entry points (call, decorator, or
``functools.partial(torch.compile, ...)`` argument) in out-of-scope
modules, with each name resolved through the module's imports.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.config import TRACE_ALLOWED_DIRS, TRACE_ENTRY_POINTS
from repro_torch.analysis.lint import (FileContext, Rule, Violation,
                                       call_path, import_aliases,
                                       resolved_path)


class R1TraceContainment(Rule):
    rule_id = "R1"
    title = ("trace containment: compile/graph capture/library loads only "
             "in runtime|kernels")

    def applies(self, ctx: FileContext) -> bool:
        head = ctx.rel.split("/", 1)[0]
        return head not in TRACE_ALLOWED_DIRS

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        aliases = import_aliases(ctx.tree)
        seen = set()
        for node in ast.walk(ctx.tree):
            # references, not just calls: catches decorator and
            # functools.partial(torch.compile, ...) spellings too
            if not isinstance(node, (ast.Attribute, ast.Name)):
                continue
            if resolved_path(node, aliases) not in TRACE_ENTRY_POINTS:
                continue
            line = getattr(node, "lineno", 0)
            if line in seen:
                continue
            seen.add(line)
            yield ctx.violation(
                node, self.rule_id,
                f"{call_path(node)} outside runtime/|kernels/ builds or "
                f"loads code the PlanSignature-keyed program cache and the "
                f"kernels' build cannot see (rebuilt on every shape); route "
                f"through repro_torch.runtime or repro_torch.kernels, or "
                f"waive with the reason nothing is rebuilt here")
