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
backward, whose kernels it launches), chosen by dtype as the forward is:
bfloat16 on the tensor cores (``mma.sync`` bf16 with float32 accumulators;
S and dP from the bf16 inputs, dV, dK and dQ as split products of P and dS
in bf16 hi + lo; q/dO or k/v tiles in a two-stage ``cp.async`` ring),
float32 on the CUDA cores in float32.  Delta, dK/dV per 64-key block and dQ
per 64-row block, no atomics, so two calls give the same bits: where a kv
group's query heads are split over several dK/dV blocks
(:func:`head_splits`), each writes float32 partials to a scratch this
wrapper allocates and one more pass sums them in a fixed order.  It has no
fallback either: a failed build or launch raises, and no bf16 call reaches
the float32 kernels.

The kernels read q, k and v in the reference's ``[B, S, H, D]`` layout
through their strides (the last dimension must be contiguous), so the
model's projections go in without a copy; the output is a new contiguous
``[B, Sq, H, Dv]`` tensor.  bfloat16 inputs whose pointers or strides are
not 16-byte aligned are copied into shared memory by plain loads in the
same kernel.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
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
#: q, k, v, o, dout, lse, delta, dq, dk, dv, partial, 15 strides, batch,
#: heads, kv_heads, sq, skv, d, dv, causal, window, splits, scale, stream
SYMBOLS.update({s: (PTR,) * 11 + (I64,) * 15 + (I32,) * 10 + (F32, PTR)
                for s in BWD_INSTANTIATIONS.values()})
#: the bf16 backward's geometry at (d, dv): d, dv, int64 out[7]
BWD_GEOMETRY = "flash_attention_bwd_geometry"
SYMBOLS[BWD_GEOMETRY] = (I32, I32, PTR)
BWD_GEOMETRY_KEYS = ("rows", "step", "threads", "dkdv_smem_bytes",
                     "dq_smem_bytes", "dkdv_blocks_per_sm",
                     "dq_blocks_per_sm")
#: the bf16 backward's design, as reports name it
BWD_DESIGN = ("mma.sync m16n8k16 bf16, split P/dS products, 64 own rows x "
              "32-row cp.async stream tiles, 8 warps, no atomics")
#: (D, Dv) pairs the source instantiates, forward and backward
HEAD_DIMS = frozenset({(16, 16), (16, 8), (32, 32), (32, 16), (64, 64),
                       (64, 32), (80, 80), (128, 128), (128, 64), (192, 128),
                       (256, 256), (256, 128)})
MAX_GRID_Y = 65535

LIB = _build.Library(NAME, SOURCE, SYMBOLS, kernels=(NAME, BWD_NAME))
#: launches of each kernel since the last ``LIB.reset_launches()``
LAUNCHES = LIB.launches



def _strides(*tensors: torch.Tensor) -> list:
    """The batch, sequence and head strides of each tensor, in elements,
    with 0 for a dimension of size 1: its stride is never used, and
    PyTorch leaves any value there (``contiguous()`` of a batch of one may
    keep batch stride 1), which would fail the kernels' 16-byte test and
    send them to plain loads."""
    return [st if n > 1 else 0 for t in tensors
            for n, st in zip(t.shape[:3], t.stride()[:3])]


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
        strides = _strides(q, k, v, o)
        LIB.launch(INSTANTIATIONS[q.dtype], NAME, q.device, q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   stats.data_ptr() if lse else None, *strides, B, H, Hkv,
                   Sq, Skv, D, Dv, int(bool(causal)), int(window or 0),
                   1.0 / math.sqrt(D))
    return (o, stats) if lse else o


def band_tiles(sq: int, skv: int, causal: bool, window: Optional[int],
               rows: int, step: int) -> list:
    """How many ``step``-row q tiles each ``rows``-key block of the dK/dV
    kernel visits: the q rows of its keys' band, from its first key when
    causal to its last key's window end (the kernel's own range)."""
    causal = causal or window is not None
    out = []
    for r0 in range(0, skv, rows):
        begin = r0 if causal else 0
        end = min(sq, r0 + rows - 1 + window) if window else sq
        out.append(max(0, -(-(end - begin) // step)))
    return out


@functools.lru_cache(maxsize=256)
def head_splits(tiles: tuple, batch_kv: int, group: int, slots: int) -> int:
    """How many dK/dV blocks share the ``group`` query heads of one kv
    head.  ``tiles``: the q tiles each key block visits (:func:`band_tiles`)
    for each of ``batch_kv`` (batch, kv head) pairs; ``slots``: blocks the
    card runs at once (SMs x blocks an SM).  For each divisor n of the group
    the blocks, n per key block, each ``tiles x group / n`` steps (plus 2
    for its own tiles and stores), go in launch order to the first free
    slot; the least n that finishes within 5% of the earliest wins (more
    splits write more partials and lengthen their sum).  One block per key
    block leaves SMs idle at MQA with few key tiles, and a causal band
    makes the last key blocks' work short, so a count of blocks alone
    misjudges both (``chip_smoke.py`` times every divisor at the GQA/MQA
    training shapes beside this choice)."""
    slots = max(1, slots)
    if len(tiles) * batch_kv >= 8 * slots:   # enough blocks to balance
        return 1
    ends = {}
    for n in range(1, group + 1):
        if group % n:
            continue
        free = [0] * slots
        for _ in range(n * batch_kv):
            for t in tiles:
                heapq.heappush(free, heapq.heappop(free) + t * group // n + 2)
        ends[n] = max(free)
    return min(n for n, end in ends.items()
               if end <= 1.05 * min(ends.values()))


_GEOMETRY: dict = {}


def bwd_geometry(d: int, dv: int, device: torch.device) -> dict:
    """The bf16 backward's tiles, threads, shared bytes and blocks an SM at
    head dims (d, dv), as the built library reports them (it alone decides
    them); read once per (d, dv, device)."""
    key = (d, dv, torch.device(device))
    if key not in _GEOMETRY:
        out = (ctypes.c_int64 * len(BWD_GEOMETRY_KEYS))()
        with torch.cuda.device(device):
            err = getattr(LIB.load(), BWD_GEOMETRY)(d, dv, out)
        if err != 0:
            raise RuntimeError(f"{BWD_GEOMETRY}({d}, {dv}) failed: CUDA "
                               f"error {err}")
        _GEOMETRY[key] = dict(zip(BWD_GEOMETRY_KEYS, out))
    return dict(_GEOMETRY[key])


def bwd_plan(q: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
             window: Optional[int] = None) -> dict:
    """What the bf16 backward launches for these inputs and mask: its
    geometry, the head splits, the dK/dV grid (key blocks, B * Hkv,
    splits), the dQ grid (q blocks, B * H) and the partials' scratch
    bytes."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    geo = bwd_geometry(D, Dv, q.device)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    key_blocks = -(-Skv // geo["rows"])
    tiles = band_tiles(Sq, Skv, causal, window, geo["rows"], geo["step"])
    splits = head_splits(tuple(tiles), B * Hkv, H // Hkv,
                         sms * geo["dkdv_blocks_per_sm"])
    return {"design": BWD_DESIGN, **geo, "sms": sms, "head_splits": splits,
            "dkdv_grid": [key_blocks, B * Hkv, splits],
            "dq_grid": [-(-Sq // geo["rows"]), B * H],
            "partial_bytes": (4 * splits * B * Skv * Hkv * (D + Dv)
                              if splits > 1 else 0)}


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
    splits, partial = 1, None
    if q.dtype == torch.bfloat16:
        splits = bwd_plan(q, v, causal=causal, window=window)["head_splits"]
        if splits > 1:   # every element written by its split's block
            partial = torch.empty((splits, B, Skv, Hkv, D + Dv),
                                  dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, o, do)
    LIB.launch(BWD_INSTANTIATIONS[q.dtype], BWD_NAME, q.device,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               partial.data_ptr() if partial is not None else None,
               *strides, B, H, Hkv, Sq, Skv, D, Dv, int(bool(causal)),
               int(window or 0), splits, 1.0 / math.sqrt(D))
    return dq, dk, dv
