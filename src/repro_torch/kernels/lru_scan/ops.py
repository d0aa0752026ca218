"""Public op: the RG-LRU diagonal recurrence, dispatched by device.

    backend="auto"   the tensors' device decides: a CPU tensor takes the
                     plain version (ref.py), a CUDA tensor the hand-written
                     kernel (kernel.py) — which raises if it cannot build or
                     launch; nothing falls back
    backend="ref"    the plain version on any device (explicit only: the
                     chip smoke's and the tests' kernel-vs-plain comparisons)
    backend="cuda"   the kernel; raises on a CPU tensor

The op is differentiable on every path.  A CPU tensor (or ``"ref"``) runs
the plain loop under autograd.  On the card, a call whose a or b needs a
gradient goes through :class:`LruScan`, an autograd Function whose forward
is the kernel (saving a and h) and whose backward is the reverse-scan
kernel (``kernel.lru_scan_bwd``); a call that needs none is the kernel
alone.  A backward that cannot build or launch raises.

``PATH_COUNTS`` tallies which path each call took, so a run can show that
its scans went through the kernel; the backward's launches are counted in
``kernel.LAUNCHES["lru_scan_bwd"]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lru_scan import kernel, ref

PATH_COUNTS = {"ref": 0, "cuda": 0}


def reset_path_counts() -> None:
    _build.reset_counts(PATH_COUNTS)


class LruScan(torch.autograd.Function):
    """The CUDA scan and its reverse-scan backward as one differentiable op;
    saves a and h for the backward."""

    @staticmethod
    def forward(ctx, a, b):
        h = kernel.lru_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return kernel.lru_scan_bwd(a, h, dh.contiguous())


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
        a, b = a.contiguous(), b.contiguous()
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            out = LruScan.apply(a, b)
        else:
            out = kernel.lru_scan(a, b)
        _build.bump(PATH_COUNTS, "cuda")
        return out
    raise ValueError(f"unknown lru_scan backend {backend!r}")
