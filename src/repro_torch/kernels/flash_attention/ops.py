"""Public op: flash attention in the reference's ``[B, S, H, D]`` layout,
dispatched by device.

    backend="auto"   the tensors' device decides: a CPU tensor takes the
                     plain version (ref.py), a CUDA tensor the hand-written
                     kernel (kernel.py) — which raises if it cannot build or
                     launch; nothing falls back
    backend="ref"    the plain version on any device (explicit only: the
                     chip smoke's and the tests' kernel-vs-plain comparisons)
    backend="cuda"   the kernel; raises on a CPU tensor

The kernel picks its own tiles: ``block_q``/``block_k`` shape only the plain
version.  ``PATH_COUNTS`` tallies which path each call took, so a run can
show that its attention went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel, ref

PATH_COUNTS = {"ref": 0, "cuda": 0}


def reset_path_counts() -> None:
    _build.reset_counts(PATH_COUNTS)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = 512, block_k: int = 512,
                    backend: str = "auto") -> torch.Tensor:
    """q [B,Sq,H,D], k [B,Skv,Hkv,D], v [B,Skv,Hkv,Dv] -> [B,Sq,H,Dv]."""
    if backend == "auto":
        backend = "cuda" if q.is_cuda else "ref"
    if backend == "ref":
        _build.bump(PATH_COUNTS, "ref")
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   block_q=block_q, block_k=block_k)
    if backend == "cuda":
        out = kernel.flash_attention(q, k, v, causal=causal, window=window)
        _build.bump(PATH_COUNTS, "cuda")
        return out
    raise ValueError(f"unknown flash_attention backend {backend!r}")
