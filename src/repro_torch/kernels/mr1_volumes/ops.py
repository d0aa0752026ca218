"""Public op: MR¹'s statistics on routed relations, dispatched by device.

    backend="auto"   the tensors' device decides: a CPU tensor takes the
                     plain version (ref.py), a CUDA tensor the hand-written
                     kernels (kernel.py) — which raise if they cannot build
                     or launch; nothing falls back
    backend="ref"    the plain version on any device (explicit only: the
                     chip smoke's and the tests' kernel-vs-plain comparisons)
    backend="cuda"   the kernels; raises on a CPU tensor

``PATH_COUNTS`` tallies which path each call took, so a run can show that
its MR¹ stages went through the kernels (the engine's
``engine.mr1_by_kernel`` counts its groups' ``"cuda"`` calls).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mr1_volumes import kernel, ref

PATH_COUNTS = {"ref": 0, "cuda": 0}


def reset_path_counts() -> None:
    _build.reset_counts(PATH_COUNTS)


def mr1_volumes(routed_fact, routed_dims, domains: Sequence[int],
                dtype: torch.dtype, backend: str = "auto"):
    """Per-worker num-arrays, fact volumes and dimension volumes of a CN
    batch's routed relations.

    ``routed_fact`` is ``(keys [N, P, R, m] int32, mask [N, P, R] bool)``,
    each of the ``m`` ``routed_dims`` ``(keys [N, P, R_i] int32, mask)``,
    ``domains`` their key domains -> ``(vol_fact [N, P, R], [vol_i [N, P,
    R_i]])`` in ``dtype``, exact modulo its width."""
    if backend == "auto":
        backend = "cuda" if routed_fact[1].is_cuda else "ref"
    if backend == "ref":
        _build.bump(PATH_COUNTS, "ref")
        return ref.mr1_volumes(routed_fact, routed_dims, domains, dtype)
    if backend == "cuda":
        out = kernel.mr1_volumes(routed_fact, routed_dims, domains, dtype)
        _build.bump(PATH_COUNTS, "cuda")
        return out
    raise ValueError(f"unknown mr1_volumes backend {backend!r}")
