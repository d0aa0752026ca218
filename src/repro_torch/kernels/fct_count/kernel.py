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

The kernel (one body, two layouts of the rows) runs one block of 1 024
threads per SM over a (row chunk x vocab tile, batch) grid, vocab tile
fastest so that the two int64 tiles of a chunk read its tokens from device
memory once.  Its warps read the weights of four 32-row groups at a time
and skip the tokens of rows that weigh 0; the rest are read 16 bytes a load
when ``L % 4 == 0`` and the tokens are 16-byte aligned (4 bytes a load
otherwise, in the same kernel).  int64 bins are two 32-bit words with a
carry, since 64-bit shared-memory atomics spin.  ``launch_shape`` picks the
tile and the row chunk; the bound and the design are in the source's
header.

:func:`fct_count` takes the rows as given (``[B, R, L]``: three
instantiations, int32, int64 and float32 weights).  :func:`fct_count_routed`
is MR² by reference (int32 and int64 weights): each CN's rows are the
slots of its routed relation, and a slot's tokens are read where the send
table points, in the CN's store-resident text, found through a device table
of the texts' addresses (:func:`text_pointers`).  No routed copy of the
text exists.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

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

#: weight dtype -> (C symbol, kernel name) of the routed layout
ROUTED = {
    torch.int32: ("fct_count_routed_int32", "fct_count_routed_int32"),
    torch.int64: ("fct_count_routed_int64", "fct_count_routed_int64"),
}

#: C launcher -> argument kinds: tokens, weights, out, batch, rows,
#: text_len, vocab, tile, rows_per_chunk, stream; the routed ones: text
#: pointers, send, weights, out, batch, P, C, S, text_len, vocab, tile,
#: rows_per_chunk, stream
SYMBOLS = {
    **{symbol: (PTR, PTR, PTR, I64, I64, I32, I32, I32, I64, PTR)
       for symbol, _ in INSTANTIATIONS.values()},
    **{symbol: (PTR, PTR, PTR, PTR, I64, I32, I32, I32, I32, I32, I32, I64,
                PTR) for symbol, _ in ROUTED.values()}}

LIB = _build.Library("fct_count", SOURCE, SYMBOLS,
                     kernels=[name for _, name in (*INSTANTIATIONS.values(),
                                                   *ROUTED.values())])
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


def text_pointers(texts: Sequence[torch.Tensor],
                  device: torch.device) -> torch.Tensor:
    """``[N]`` int64 on ``device``: the address of each CN's text, as
    :func:`fct_count_routed` reads them.  An upload from the host: the
    engine memoizes the table per group of texts (``RelationStore.
    text_pointers``), so that a warm dispatch ships nothing."""
    return torch.tensor([t.data_ptr() for t in texts],
                        dtype=torch.int64).to(device)


def fct_count_routed(texts: Sequence[torch.Tensor], send: torch.Tensor,
                     weights: torch.Tensor, vocab: int,
                     pointers: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Weighted token histogram of routed relations, read by reference.

    ``texts`` holds CN n's contiguous ``[P, S, L]`` int32 text (the same
    shape for every CN), ``send [N, P(src), P(dst), C]`` int32 the CNs'
    send tables (-1 pads), ``weights [N, P(dst), P*C]`` (int32 or int64)
    the routed slots' weights.  Slot ``(n, dst, src*C + c)`` counts the
    tokens of row ``src*S + clamp(send[n, src, dst, c], 0, S-1)`` of
    ``texts[n]`` -> ``[N, vocab]`` in the weight dtype.  ``pointers`` is
    :func:`text_pointers` of ``texts`` on the device (built here when
    None, which a CUDA graph capture refuses).  Raises on anything the
    kernel does not take."""
    if not (send.is_cuda and weights.is_cuda):
        raise ValueError("fct_count kernel needs CUDA tensors, got "
                         f"{send.device} / {weights.device}")
    dev = send.device
    if send.dtype != torch.int32 or send.dim() != 4:
        raise ValueError(f"need an int32 send table [N, P, P, C], got "
                         f"{send.dtype} {tuple(send.shape)}")
    N, P, P2, C = send.shape
    if weights.dtype not in ROUTED:
        raise TypeError(f"routed fct_count has no kernel for {weights.dtype} "
                        f"weights (takes {sorted(map(str, ROUTED))})")
    if P2 != P or weights.shape != (N, P, P * C) or len(texts) != N:
        raise ValueError(f"need send [N, P, P, C], weights [N, P, P*C] and "
                         f"N texts, got {tuple(send.shape)}, "
                         f"{tuple(weights.shape)} and {len(texts)}")
    if not (send.is_contiguous() and weights.is_contiguous()):
        raise ValueError("send and weights must be contiguous")
    shape = tuple(texts[0].shape) if N else (P, 0, 0)
    for t in texts:
        if (t.device != dev or t.dtype != torch.int32
                or tuple(t.shape) != shape or len(shape) != 3
                or shape[0] != P or not t.is_contiguous()):
            raise ValueError(f"texts must be contiguous int32 [P, S, L] of "
                             f"one shape on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    _, S, L = shape
    vocab = int(vocab)
    if not 1 <= vocab < 2 ** 31:
        raise ValueError(f"vocab must be in [1, 2^31), got {vocab}")
    if N > 65535:
        raise ValueError(f"batch {N} exceeds the grid's y limit")
    if P * S >= 2 ** 31 or P * P * C >= 2 ** 31:
        raise ValueError(f"{P * S} source rows or {P * P * C} slots a CN "
                         "pass the kernel's 32-bit row index")
    out = torch.zeros((N, vocab), dtype=weights.dtype, device=dev)
    if N * P * C * S * L == 0:
        return out
    if pointers is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a captured routed fct_count needs its text "
                               "pointers resident (text_pointers)")
        pointers = text_pointers(texts, dev)
    elif (pointers.device != dev or pointers.dtype != torch.int64
          or tuple(pointers.shape) != (N,)):
        raise ValueError(f"pointers must be int64 [{N}] on {dev}, got "
                         f"{pointers.dtype} {tuple(pointers.shape)} on "
                         f"{pointers.device}")
    symbol, name = ROUTED[weights.dtype]
    rows = P * P * C
    tile, rows_per_chunk = launch_shape(N, rows, L, vocab,
                                        weights.element_size())
    LIB.launch(symbol, name, dev, pointers.data_ptr(), send.data_ptr(),
               weights.data_ptr(), out.data_ptr(), N, P, C, S, L, vocab,
               tile, rows_per_chunk)
    return out
