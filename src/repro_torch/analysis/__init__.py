"""repro_torch.analysis: the port's repo-invariant checks.

Two layers, as in the JAX package's ``analysis`` (see its README for the
rule catalog and rationale):

* **AST lint** (:mod:`repro_torch.analysis.lint` +
  :mod:`repro_torch.analysis.rules`) — a small rule framework over
  :mod:`ast` enforcing the port's invariants over ``src/repro_torch``:
  trace containment (R1: no ``torch.compile``, CUDA graph capture or
  kernel-library load outside ``runtime/`` and ``kernels/``), accumulation
  dtype discipline (R2), lock discipline in threaded modules (R3), no host
  sync in engine hot paths (R4), epoch-fenced cache writes (R5).  False
  positives are waived inline with a mandatory justification string
  (``# fct-lint: waive[R3] -- why this is safe``).

* **runtime contract checker** (:mod:`repro_torch.analysis.contracts`) —
  runs the five engine program families once on small inputs of
  representative ``PlanSignature`` buckets under both
  :class:`~repro_torch.core.accum.AccumPolicy` modes, at P = 1 and P = 8
  on the virtual mesh, and asserts: exactly one reduction per dispatch,
  integer-only dataflow, an O(vocab/P) (top-k: O(k)) output, and pow-2
  bucketed dims.

``python -m repro_torch.analysis`` checks the tree (``--json`` for the
machine-readable report, ``--contracts`` to add the runtime layer, on the
card unless ``--device cpu``).  Importing this package never imports torch
— only the contract layer does — so the lint runs without it.
"""
from __future__ import annotations

from repro_torch.analysis.lint import LintReport, Violation, Waiver, lint_paths

__all__ = ["LintReport", "Violation", "Waiver", "lint_paths"]
