"""Loader and wrapper of the hand-written CUDA ``flash_attention`` kernel.

The source is ``csrc/flash_attention.cu`` (see its header for the design and
what bounds it).  ``kernels/_build.py`` compiles it with ``nvcc`` for
``sm_90a`` at the first CUDA call — never at import — and loads it with
``ctypes``.  When ``nvcc`` is missing or the build fails, a CUDA call raises:
there is no fallback.  Each exported C function launches on PyTorch's
current stream, never synchronises, and returns ``cudaGetLastError()`` (or
the error of raising the kernel's shared-memory limit); ``LIB.launch``
raises on anything but 0.  ``LAUNCHES`` moves only where the kernel is
launched.

Two kernels, chosen by dtype alone: bfloat16 runs on the tensor cores
(``mma.sync`` m16n8k16 with float32 accumulators, P·V as a split product
P_hi·V + P_lo·V, k/v tiles of 64 keys in a two-stage ``cp.async`` ring),
float32 on the CUDA cores in float32 (TF32 would break its tolerance).  A
failed build or launch raises; neither dtype ever reaches the other kernel.
``LAUNCHES["flash_attention"]`` counts the launches of both.

With ``lse=True`` the forward also writes the float32 log-sum-exp of each
row's scaled scores, ``[B, H, Sq]``, which the backward reads; without it the
kernel gets a null pointer and runs as it always did.  The backward
(:func:`flash_attention_bwd`) lives in the same source and library, as a
second counted kernel (``LAUNCHES["flash_attention_bwd"]``, one per
backward, whose three kernels it launches): float32 arithmetic on the CUDA
cores for both dtypes, no atomics, so two calls give the same bits.  It has
no fallback either: a failed build or launch raises.

The kernels read q, k and v in the reference's ``[B, S, H, D]`` layout
through their strides (the last dimension must be contiguous), so the
model's projections go in without a copy; the output is a new contiguous
``[B, Sq, H, Dv]`` tensor.  bfloat16 inputs whose pointers or strides are
not 16-byte aligned are copied into shared memory by plain loads in the
same kernel.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F32, I32, I64, PTR

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
NAME = "flash_attention"

#: input dtype -> C launcher
INSTANTIATIONS = {torch.float32: "flash_attention_float32",
                  torch.bfloat16: "flash_attention_bfloat16"}
#: q, k, v, o, lse, 12 strides, batch, heads, kv_heads, sq, skv, d, dv,
#: causal, window, scale, stream
SYMBOLS = {s: (PTR,) * 5 + (I64,) * 12 + (I32,) * 9 + (F32, PTR)
           for s in INSTANTIATIONS.values()}
BWD_NAME = "flash_attention_bwd"
BWD_INSTANTIATIONS = {torch.float32: "flash_attention_bwd_float32",
                      torch.bfloat16: "flash_attention_bwd_bfloat16"}
#: q, k, v, o, dout, lse, delta, dq, dk, dv, 15 strides, batch, heads,
#: kv_heads, sq, skv, d, dv, causal, window, scale, stream
SYMBOLS.update({s: (PTR,) * 10 + (I64,) * 15 + (I32,) * 9 + (F32, PTR)
                for s in BWD_INSTANTIATIONS.values()})
#: (D, Dv) pairs the source instantiates, forward and backward
HEAD_DIMS = frozenset({(16, 16), (16, 8), (32, 32), (32, 16), (64, 64),
                       (64, 32), (80, 80), (128, 128), (128, 64), (192, 128),
                       (256, 256), (256, 128)})
MAX_GRID_Y = 65535

LIB = _build.Library(NAME, SOURCE, SYMBOLS, kernels=(NAME, BWD_NAME))
#: launches of each kernel since the last ``LIB.reset_launches()``
LAUNCHES = LIB.launches



def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    tensors = (q, k, v)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash_attention kernel needs CUDA tensors, got "
                         f"{[str(t.device) for t in tensors]}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in INSTANTIATIONS:
        raise TypeError(f"flash_attention takes q, k, v of one dtype in "
                        f"{sorted(map(str, INSTANTIATIONS))}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError("need q [B,Sq,H,D], k [B,Skv,Hkv,D], v [B,Skv,Hkv,Dv]")
    B, Sq, H, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    if k.shape != (B, Skv, Hkv, D) or v.shape[0] != B:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} heads do not split into {Hkv} kv groups")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"no kernel for head dims (D, Dv) = ({D}, {Dv}); "
                         f"built: {sorted(HEAD_DIMS)}")
    if B * H > MAX_GRID_Y:
        raise ValueError(f"batch*heads {B * H} exceeds the grid's y limit")
    if max(Sq, Skv) >= 2 ** 31:
        raise ValueError("sequence lengths must stay below 2^31")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("the last dimension of q, k and v must be "
                         "contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    lse: bool = False):
    """Attention on the card: q [B,Sq,H,D], k [B,Skv,Hkv,D],
    v [B,Skv,Hkv,Dv], all CUDA tensors of one dtype (float32 or bfloat16)
    on one device -> [B,Sq,H,Dv] in that dtype.  ``window`` keeps keys with
    0 <= q_pos - k_pos < window and implies causal.  With ``lse`` returns
    ``(o, lse)``, lse the float32 log-sum-exp ``[B, H, Sq]`` of each row's
    scaled scores (+inf for a row with no key in its band).  Raises on
    anything the kernel does not take."""
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    stats = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
             if lse else None)
    if o.numel() and Skv == 0:      # no key: zeros, and no row has a band
        o.zero_()
        if lse:
            stats.fill_(math.inf)
    elif o.numel():
        strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
        LIB.launch(INSTANTIATIONS[q.dtype], NAME, q.device, q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   stats.data_ptr() if lse else None, *strides, B, H, Hkv,
                   Sq, Skv, D, Dv, int(bool(causal)), int(window or 0),
                   1.0 / math.sqrt(D))
    return (o, stats) if lse else o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None):
    """The gradient of :func:`flash_attention` on the card: from its inputs,
    its output ``o``, its ``lse`` and the output's gradient ``do``
    ([B,Sq,H,Dv]), returns ``(dq, dk, dv)``, new contiguous tensors in the
    inputs' dtype.  Raises on anything the kernel does not take."""
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != (B, Sq, H, Dv) or t.dtype != q.dtype \
                or t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"{name} must be [B,Sq,H,Dv] = "
                             f"{[B, Sq, H, Dv]} in {q.dtype} on {q.device} "
                             f"with a contiguous last dimension, got "
                             f"{list(t.shape)} {t.dtype} {t.device}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 [B,H,Sq] = "
                         f"{[B, H, Sq]} on {q.device}")
    # the kernels write every element
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Skv, Hkv, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Skv, Hkv, Dv), dtype=q.dtype, device=q.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, o, do) for s in t.stride()[:3]]
    LIB.launch(BWD_INSTANTIATIONS[q.dtype], BWD_NAME, q.device,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *strides, B, H,
               Hkv, Sq, Skv, D, Dv, int(bool(causal)), int(window or 0),
               1.0 / math.sqrt(D))
    return dq, dk, dv
