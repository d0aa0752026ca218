"""Loader and wrapper of the hand-written CUDA ``lru_scan`` kernel.

The source is ``csrc/lru_scan.cu`` (see its header for the design and what
bounds it).  ``kernels/_build.py`` compiles it with ``nvcc`` for ``sm_90a``
at the first CUDA call — never at import — and loads it with ``ctypes``.
When ``nvcc`` is missing or the build fails, a CUDA call raises: there is no
fallback.  Each exported C function launches on PyTorch's current stream,
never synchronises, and returns ``cudaGetLastError()``; ``LIB.launch`` raises
on anything but 0.  ``LAUNCHES`` moves only where the kernel is launched.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I64, PTR

SOURCE = Path(__file__).resolve().parent / "csrc" / "lru_scan.cu"
NAME = "lru_scan"

#: input dtype -> C launcher
INSTANTIATIONS = {torch.float32: "lru_scan_float32",
                  torch.bfloat16: "lru_scan_bfloat16"}
#: a, b, h, batch, seq, width, stream
SYMBOLS = {s: (PTR, PTR, PTR, I64, I64, I64, PTR)
           for s in INSTANTIATIONS.values()}

LIB = _build.Library(NAME, SOURCE, SYMBOLS)
#: launches since the last ``LIB.reset_launches()``
LAUNCHES = LIB.launches



def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t on the card.

    ``a, b [B, S, W]``, contiguous CUDA tensors of one dtype (float32 or
    bfloat16) on one device -> ``h [B, S, W]`` in that dtype, carry in
    float32.  Raises on anything the kernel does not take."""
    if not (a.is_cuda and b.is_cuda):
        raise ValueError(f"lru_scan kernel needs CUDA tensors, got "
                         f"{a.device} / {b.device}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.dtype != b.dtype or a.dtype not in INSTANTIATIONS:
        raise TypeError(f"lru_scan takes a and b of one dtype in "
                        f"{sorted(map(str, INSTANTIATIONS))}, got {a.dtype} "
                        f"and {b.dtype}")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"need a, b [B, S, W] of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    B, S, W = a.shape
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    LIB.launch(INSTANTIATIONS[a.dtype], NAME, a.device, a.data_ptr(),
               b.data_ptr(), h.data_ptr(), B, S, W)
    return h
