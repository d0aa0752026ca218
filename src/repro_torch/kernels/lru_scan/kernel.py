"""Loader and wrapper of the hand-written CUDA ``lru_scan`` kernel.

The source is ``csrc/lru_scan.cu``.  ``kernels/_build.py`` compiles it with
``nvcc`` for ``sm_90a`` at the first CUDA call — never at import — and loads
it with ``ctypes``.  When ``nvcc`` is missing or the build fails, a CUDA call
raises: there is no fallback.  Each exported C launcher runs on
PyTorch's current stream, never synchronises, and returns
``cudaGetLastError()``; ``LIB.launch`` raises on anything but 0.
``LAUNCHES`` moves only where the kernel is launched: one per call.

Design (the source's header has the details): a single-pass chunked scan,
parallel over S as well as over channels and batch.  One block takes a chunk
of timesteps x a tile of channels of one batch row, in the order of a ticket
from a device counter (chunk-major), copies its a and b into shared memory,
and per channel publishes the chunk's aggregate (prod a, zero-carry end),
looks back over its predecessors' words to the nearest inclusive carry,
folds forward from it, publishes its own inclusive carry, and re-runs the
plain loop over its tile from the carry-in.  The source alone decides the
chunk and tile; :func:`geometry` asks the built library for them.

Deterministic: every chunk's carry is the serial chain
P_c = fmaf(A_c, P_{c-1}, H_c) over the same aggregates, whatever predecessor
the look-back stops at, so repeated calls give the same bits.  They differ
from the plain loop's by the rounding of the aggregates, inside the 1e-5
rule (``tests/_lru_kernel_order.py`` emulates the order bit for bit).

Bound: 3 * B*S*W * sizeof(T) bytes (a and b read once, h written once) at
3.35 TB/s.  The wrapper allocates the scratch and passes it in (the kernel
allocates nothing): ``geometry(...)["scratch_words"]`` int32 words filled
with -1 ("not ready"): the ticket counter, then per (chunk, batch, channel)
the aggregate (two words) and the inclusive carry (one), 1.97 MB at the
prefill's ``[1, 8192, 2560]``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I64, PTR

SOURCE = Path(__file__).resolve().parent / "csrc" / "lru_scan.cu"
NAME = "lru_scan"

#: input dtype -> C launcher
INSTANTIATIONS = {torch.float32: "lru_scan_float32",
                  torch.bfloat16: "lru_scan_bfloat16"}
GEOMETRY = "lru_scan_geometry"
#: launchers: a, b, h, batch, seq, width, scratch, scratch words, stream;
#: the geometry: element bytes, batch, seq, width, int64 out[5]
SYMBOLS = {**{s: (PTR, PTR, PTR, I64, I64, I64, PTR, I64, PTR)
              for s in INSTANTIATIONS.values()},
           GEOMETRY: (I64, I64, I64, I64, PTR)}

LIB = _build.Library(NAME, SOURCE, SYMBOLS)
#: launches since the last ``LIB.reset_launches()``
LAUNCHES = LIB.launches

GEOMETRY_KEYS = ("sub_steps", "chunk_steps", "tile_channels", "tickets",
                 "scratch_words")


def geometry(dtype: torch.dtype, batch: int, seq: int,
             width: int) -> Dict[str, int]:
    """What the built kernel takes for one launch at ``[batch, seq, width]``
    of ``dtype``: timesteps a sub-chunk (one thread's piece) and a chunk (a
    block), channels a tile, tickets (blocks), and int32 words of scratch.
    Builds the library if needed; launches nothing."""
    if dtype not in INSTANTIATIONS:
        raise TypeError(f"lru_scan takes {sorted(map(str, INSTANTIATIONS))}, "
                        f"got {dtype}")
    out = (ctypes.c_int64 * len(GEOMETRY_KEYS))()
    err = getattr(LIB.load(), GEOMETRY)(
        dtype.itemsize, batch, seq, width, out)
    if err != 0:
        raise RuntimeError(f"{GEOMETRY} failed: CUDA error {err}")
    return dict(zip(GEOMETRY_KEYS, out))


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
    # every word starts "not ready" (all ones); the counter's first ticket
    # is ~0 + 1 = 0
    n = geometry(a.dtype, B, S, W)["scratch_words"]
    scratch = torch.full((n,), -1, dtype=torch.int32, device=a.device)
    LIB.launch(INSTANTIATIONS[a.dtype], NAME, a.device, a.data_ptr(),
               b.data_ptr(), h.data_ptr(), B, S, W, scratch.data_ptr(), n)
    return h
