"""Roofline terms of one cell on one NVIDIA H100: the port's counterpart of
the reference's ``launch/roofline.py``.

Peaks are the H100 SXM's published ones (NVIDIA's data sheet; dense rates,
no sparsity, at the full 700 W power limit):

    bf16 on the tensor cores      989e12 FLOP/s   (the cells' compute dtype)
    float32 outside them           67e12 FLOP/s
    HBM3                          3.35e12 B/s

    compute    = flops / 989e12
    memory     = bytes / 3.35e12
    collective = 0 on one card

``flops`` and ``bytes`` come from ``launch/op_analysis.py`` (the plain
versions' aten ops, trip-counted).  The reference's collective term is
per-device ICI traffic of a 256-device mesh; the port runs on one card,
where the virtual mesh's collectives (``launch/mesh.py``) are views and
sums on the same device and move no bytes between cards: the census's
calls are recorded, and the term is 0.  The reference's ``xla_raw_flops``
and ``xla_raw_bytes`` are XLA's own cost analysis, which has no
counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_BF16_FLOPS = 989e12        # dense bf16 on the tensor cores, FLOP/s
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12       # HBM3, B/s
HBM_BYTES = 80e9                # one card's memory


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    collectives: Dict
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float
    per_device_memory_gb: float

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(counts, model_flops: float, memory_bytes: float) -> Roofline:
    """``counts``: an ``op_analysis.OpCounts`` of one call on one card;
    ``memory_bytes``: what the card holds for it (arguments and the call's
    peak)."""
    terms = {"compute": counts.flops / PEAK_BF16_FLOPS,
             "memory": counts.bytes / HBM_BYTES_PER_S,
             "collective": 0.0}
    return Roofline(
        flops=counts.flops, hbm_bytes=counts.bytes, collective_bytes=0.0,
        collectives=dict(counts.collectives),
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"],
        bottleneck=max(terms, key=terms.get), model_flops=model_flops,
        useful_ratio=(model_flops / counts.flops) if counts.flops else 0.0,
        per_device_memory_gb=memory_bytes / 1e9)


def roofline_fraction(r: Roofline) -> float:
    """The reference's score: useful model time over the largest term,
    ``(model_flops / peak) / max(compute, memory, collective)``."""
    worst = max(r.compute_s, r.memory_s, r.collective_s)
    model_time = r.model_flops / PEAK_BF16_FLOPS
    return (model_time / worst) if worst > 0 else 0.0
