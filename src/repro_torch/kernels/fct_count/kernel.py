"""Loader and wrapper of the hand-written CUDA ``fct_count`` kernel.

The source is ``csrc/fct_count.cu`` (see its header for the design and what
bounds it).  ``kernels/_build.py`` compiles it with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface at the first CUDA call — never
at import — and loads it with ``ctypes``.  When ``nvcc`` is missing or the
build fails, a CUDA call raises: there is no fallback.

One exported C function per instantiation.  Each launches on PyTorch's
current stream, never synchronises, and returns ``cudaGetLastError()``;
``LIB.launch`` raises on anything but 0.  ``LAUNCHES`` counts launches per
instantiation and moves only where a kernel is launched.

The kernel (one template, three instantiations) runs one block of 1 024
threads per SM over a (row chunk x vocab tile, batch) grid, vocab tile
fastest so that the two int64 tiles of a chunk read its tokens from device
memory once.  Its warps read the weights of four 32-row groups at a time
and skip the tokens of rows that weigh 0; the rest are read 16 bytes a load
when ``L % 4 == 0`` and the tokens are 16-byte aligned (4 bytes a load
otherwise, in the same kernel).  int64 bins are two 32-bit words with a carry, since 64-bit
shared-memory atomics spin.  ``launch_shape`` picks the tile and the row
chunk; the bound and the design are in the source's header.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I32, I64, PTR

SOURCE = Path(__file__).resolve().parent / "csrc" / "fct_count.cu"

#: weight dtype -> (C symbol, kernel name as reported in launch counts)
INSTANTIATIONS = {
    torch.int32: ("fct_count_int32", "fct_count_exact_int32"),
    torch.int64: ("fct_count_int64", "fct_count_exact_int64"),
    torch.float32: ("fct_count_float32", "fct_count_float32"),
}

#: C launcher -> argument kinds: tokens, weights, out, batch, rows,
#: text_len, vocab, tile, rows_per_chunk, stream
SYMBOLS = {symbol: (PTR, PTR, PTR, I64, I64, I32, I32, I32, I64, PTR)
           for symbol, _ in INSTANTIATIONS.values()}

LIB = _build.Library("fct_count", SOURCE, SYMBOLS,
                     kernels=[name for _, name in INSTANTIATIONS.values()])
#: launches per kernel instantiation since the last ``LIB.reset_launches()``
LAUNCHES = LIB.launches

#: threads a block (one block an SM) and the rows a warp takes at a time
THREADS, GROUP_ROWS = 1024, 32
#: rows all warps of a block take in one step
BLOCK_ROWS = THREADS // 32 * GROUP_ROWS
#: shared-memory bytes for one block's vocab tile of bins: int32 and float32
#: tiles hold 32 768 bins, int64 tiles 16 384 (Hopper allows 227 KB a block)
TILE_BYTES = 128 * 1024
#: blocks the launch aims for: two waves of one block per SM on an H100
TARGET_BLOCKS = 2 * 132


def launch_shape(batch: int, rows: int, text_len: int, vocab: int,
                 itemsize: int):
    """(tile, rows_per_chunk) of one launch: the vocab tile that fits
    ``TILE_BYTES`` of bins, and row chunks of whole ``BLOCK_ROWS`` steps
    sized so the grid has about ``TARGET_BLOCKS`` blocks."""
    tile = min(vocab, TILE_BYTES // itemsize)
    tiles = -(-vocab // tile)
    chunks = max(1, -(-TARGET_BLOCKS // (tiles * batch)))
    rows_per_chunk = -(-rows // chunks)
    rows_per_chunk = -(-rows_per_chunk // BLOCK_ROWS) * BLOCK_ROWS
    return tile, rows_per_chunk


def fct_count(tokens: torch.Tensor, weights: torch.Tensor,
              vocab: int) -> torch.Tensor:
    """Weighted token histogram on the card.

    ``tokens [B, R, L]`` int32 and ``weights [B, R]`` (int32, int64 or
    float32), both contiguous CUDA tensors on one device -> ``[B, vocab]``
    in the weight dtype.  Raises on anything the kernel does not take."""
    if not (tokens.is_cuda and weights.is_cuda):
        raise ValueError("fct_count kernel needs CUDA tensors, got "
                         f"{tokens.device} / {weights.device}")
    if tokens.device != weights.device:
        raise ValueError(f"tokens on {tokens.device}, weights on "
                         f"{weights.device}")
    if tokens.dtype != torch.int32:
        raise TypeError(f"tokens must be int32, got {tokens.dtype}")
    if weights.dtype not in INSTANTIATIONS:
        raise TypeError(f"fct_count has no kernel for {weights.dtype} weights "
                        f"(takes {sorted(map(str, INSTANTIATIONS))})")
    if tokens.dim() != 3 or weights.shape != tokens.shape[:2]:
        raise ValueError(f"need tokens [B, R, L] and weights [B, R], got "
                         f"{tuple(tokens.shape)} and {tuple(weights.shape)}")
    if not (tokens.is_contiguous() and weights.is_contiguous()):
        raise ValueError("tokens and weights must be contiguous")
    vocab = int(vocab)
    if not 1 <= vocab < 2 ** 31:
        raise ValueError(f"vocab must be in [1, 2^31), got {vocab}")
    B, R, L = tokens.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's y limit")
    out = torch.zeros((B, vocab), dtype=weights.dtype, device=tokens.device)
    if B * R * L == 0:
        return out
    symbol, name = INSTANTIATIONS[weights.dtype]
    tile, rows_per_chunk = launch_shape(B, R, L, vocab,
                                        weights.element_size())
    LIB.launch(symbol, name, tokens.device, tokens.data_ptr(),
               weights.data_ptr(), out.data_ptr(), B, R, L, vocab, tile,
               rows_per_chunk)
    return out
