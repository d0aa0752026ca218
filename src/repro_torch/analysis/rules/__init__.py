"""Rule registry: one module per rule, listed here in catalog order."""
from __future__ import annotations

from repro_torch.analysis.rules.r1_trace_containment import R1TraceContainment
from repro_torch.analysis.rules.r2_accum_discipline import R2AccumDiscipline
from repro_torch.analysis.rules.r3_lock_discipline import R3LockDiscipline
from repro_torch.analysis.rules.r4_host_sync import R4HostSync
from repro_torch.analysis.rules.r5_epoch_fence import R5EpochFence

ALL_RULES = (R1TraceContainment, R2AccumDiscipline, R3LockDiscipline,
             R4HostSync, R5EpochFence)

__all__ = ["ALL_RULES", "R1TraceContainment", "R2AccumDiscipline",
           "R3LockDiscipline", "R4HostSync", "R5EpochFence"]
