"""Public op: flash attention in the reference's ``[B, S, H, D]`` layout,
dispatched by device.

    backend="auto"   the tensors' device decides: a CPU tensor takes the
                     plain version (ref.py), a CUDA tensor the hand-written
                     kernel (kernel.py) — which raises if it cannot build or
                     launch; nothing falls back
    backend="ref"    the plain version on any device (explicit only: the
                     chip smoke's and the tests' kernel-vs-plain comparisons)
    backend="cuda"   the kernel; raises on a CPU tensor

The op is differentiable on every path.  A CPU tensor (or ``"ref"``) runs
the plain version under autograd.  On the card, a call whose q, k or v needs
a gradient goes through :class:`FlashAttention`, an autograd Function whose
forward is the kernel with its log-sum-exp output and whose backward is the
hand-written backward kernel (``kernel.flash_attention_bwd``: bf16 on the
tensor cores, float32 on the CUDA cores, as the forward); a call that
needs none (inference, ``torch.inference_mode``) is the kernel alone, with
no log-sum-exp.  A backward that cannot build or launch raises: nothing
takes the plain autograd path on the card unless asked for by ``"ref"``.

The kernel picks its own tiles: ``block_q``/``block_k`` shape only the plain
version.  ``PATH_COUNTS`` tallies which path each call took, so a run can
show that its attention went through the kernel; the backward's calls are
counted in ``kernel.LAUNCHES["flash_attention_bwd"]``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel, ref

PATH_COUNTS = {"ref": 0, "cuda": 0}


def reset_path_counts() -> None:
    _build.reset_counts(PATH_COUNTS)


class FlashAttention(torch.autograd.Function):
    """The CUDA kernel and its backward kernel as one differentiable op.
    Saves q, k, v, the output and the float32 log-sum-exp for the backward
    (under activation checkpointing they are dropped and recomputed)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        o, lse = kernel.flash_attention(q, k, v, causal=causal, window=window,
                                        lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = kernel.flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


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
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            out = FlashAttention.apply(q, k, v, causal, window)
        else:
            out = kernel.flash_attention(q, k, v, causal=causal,
                                         window=window)
        _build.bump(PATH_COUNTS, "cuda")
        return out
    raise ValueError(f"unknown flash_attention backend {backend!r}")
