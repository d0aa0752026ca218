"""AccumPolicy: the one overflow/precision contract of FCT aggregation.

The paper's second MapReduce job is pure integer counting, so the correctness
contract of every execution path is arithmetical, not numerical: a term's
total frequency must come back *exactly*, or the query must fail loudly.
Every layer (volumes, histograms, the cross-CN sum, collection) consults a
single :class:`AccumPolicy`:

``INT32_CHECKED``
    Volumes and histograms accumulate in int32.  Totals past 2^31 wrap to
    negative on device and are detected on the host, which raises
    ``OverflowError`` instead of returning silently wrong counts.  The check
    is best-effort: a double wrap (past 2^32) can land positive again.

``INT64_EXACT``
    Volumes and histograms accumulate in int64.  Totals are exact over the
    full practically reachable range; no wrap check is needed or performed.

Both policies are served by the same integer-exact ``fct_count`` kernel:
device accumulation is exact *modulo* the policy width — bit-identical to a
host int32/int64 accumulation — so the policy fully describes the precision a
result carries.  The policy rides the runtime's
:class:`~repro_torch.runtime.batch.PlanSignature` (so built programs key on
it), is configured per session via ``SessionConfig.accum_policy`` and
advertised per response via ``FCTResponse.accum_policy``.  The policy alone
decides the width: no process-wide flag is consulted.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AccumPolicy:
    """Device accumulation width + overflow behavior for FCT aggregation.

    ``name`` is the wire string advertised through response stats; ``bits``
    the accumulator width (32 or 64); ``check_wrap`` whether host collection
    must raise ``OverflowError`` on wrapped (negative) totals.  Frozen and
    hashable: it is part of the program-cache key via
    ``PlanSignature.accum``.
    """

    name: str
    bits: int
    check_wrap: bool

    @property
    def dtype(self) -> torch.dtype:
        """The torch accumulator dtype (volumes, num-array probes,
        histograms)."""
        return torch.int64 if self.bits == 64 else torch.int32

    def check_totals(self, arr) -> None:
        """Host-side wrap check on collected device totals (numpy array).

        int32 totals past 2^31 wrap to negative — fail loudly.  Best-effort:
        a total that wraps past 2^32 back to positive is not detected.  The
        message is the one the reference engine raises, word for word.
        """
        if self.check_wrap and bool((arr < 0).any()):
            raise OverflowError(
                "int32 term totals overflowed 2^31 during FCT aggregation; "
                "re-run with jax_enable_x64=True (JAX_ENABLE_X64=1) for "
                "int64 device histograms")

    @classmethod
    def resolve(cls, spec: str) -> "AccumPolicy":
        """Resolve a config spelling: ``"auto"`` (the default,
        int32-checked, as the reference engine resolves it without its x64
        flag), ``"int32"`` or ``"int64"``."""
        if spec in ("auto", "int32"):
            return INT32_CHECKED
        if spec == "int64":
            return INT64_EXACT
        raise ValueError(
            f"accum_policy must be 'auto', 'int32' or 'int64', got {spec!r}")

    @classmethod
    def for_dtype(cls, dtype) -> "AccumPolicy":
        """The policy a collected device array was accumulated under —
        the dtype *is* the policy signal on the collection side."""
        return INT64_EXACT if np.dtype(dtype) == np.int64 else INT32_CHECKED


INT32_CHECKED = AccumPolicy(name="int32-checked", bits=32, check_wrap=True)
INT64_EXACT = AccumPolicy(name="int64-exact", bits=64, check_wrap=False)
