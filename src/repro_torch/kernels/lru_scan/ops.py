"""Public op: the RG-LRU diagonal recurrence, dispatched by device.

    backend="auto"   the tensors' device decides: a CPU tensor takes the
                     plain version (ref.py), a CUDA tensor the hand-written
                     kernel (kernel.py) — which raises if it cannot build or
                     launch; nothing falls back
    backend="ref"    the plain version on any device (explicit only: the
                     chip smoke's and the tests' kernel-vs-plain comparisons)
    backend="cuda"   the kernel; raises on a CPU tensor

``PATH_COUNTS`` tallies which path each call took, so a run can show that
its scans went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lru_scan import kernel, ref

PATH_COUNTS = {"ref": 0, "cuda": 0}


def reset_path_counts() -> None:
    _build.reset_counts(PATH_COUNTS)


def lru_scan(a: torch.Tensor, b: torch.Tensor,
             backend: str = "auto") -> torch.Tensor:
    """a, b [B, S, W] -> h [B, S, W] with h_t = a_t·h_{t-1} + b_t, h_{-1} = 0,
    in the dtype of ``a`` with a float32 carry."""
    if backend == "auto":
        backend = "cuda" if a.is_cuda else "ref"
    if backend == "ref":
        _build.bump(PATH_COUNTS, "ref")
        return ref.lru_scan(a, b)
    if backend == "cuda":
        out = kernel.lru_scan(a.contiguous(), b.contiguous())
        _build.bump(PATH_COUNTS, "cuda")
        return out
    raise ValueError(f"unknown lru_scan backend {backend!r}")
