"""Loader and wrapper of the hand-written CUDA ``fct_count`` kernel.

The source is ``csrc/fct_count.cu`` (see its header for the design and what
bounds it).  It is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at the first CUDA call — never at import —
into ``build/repro_torch/`` at the checkout root, under a name keyed by a hash
of the source, so an edited source rebuilds.  The library is loaded with
``ctypes``.  When ``nvcc`` is missing or the build fails, a CUDA call raises:
there is no fallback.

One exported C function per instantiation.  Each launches on PyTorch's
current stream, never synchronises, and returns ``cudaGetLastError()``; the
wrapper raises on anything but 0.  ``LAUNCHES`` counts launches per
instantiation and moves only where a kernel is launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "fct_count.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: weight dtype -> (C symbol, kernel name as reported in launch counts)
INSTANTIATIONS = {
    torch.int32: ("fct_count_int32", "fct_count_exact_int32"),
    torch.int64: ("fct_count_int64", "fct_count_exact_int64"),
    torch.float32: ("fct_count_float32", "fct_count_float32"),
}

#: launches per kernel instantiation since the last reset
LAUNCHES = {name: 0 for _, name in INSTANTIATIONS.values()}

THREADS = 256
#: shared-memory bytes for one block's vocab tile of bins: int32 and float32
#: tiles hold 32 768 bins, int64 tiles 16 384 (Hopper allows 227 KB a block)
TILE_BYTES = 128 * 1024
#: blocks the launch aims for: a few waves of one block per SM on an H100
TARGET_BLOCKS = 4 * 132
MIN_ROWS_PER_CHUNK = 64

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Optional[float] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libfct_count-{digest}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("fct_count: nvcc not found (PATH, CUDA_HOME); the "
                       "CUDA kernel cannot be built")


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; returns it.

    Sets ``BUILD_SECONDS`` to the time spent compiling (0.0 when a library
    built from the same source was already there)."""
    global _lib, BUILD_SECONDS
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        t0 = time.perf_counter()
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"fct_count: nvcc failed ({res.returncode}):\n"
                    f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
            os.replace(tmp, path)
        BUILD_SECONDS = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for symbol, _ in INSTANTIATIONS.values():
            fn = getattr(lib, symbol)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def launch_shape(batch: int, rows: int, text_len: int, vocab: int,
                 itemsize: int):
    """(tile, rows_per_chunk) of one launch: the vocab tile that fits
    ``TILE_BYTES`` of bins, and row chunks sized so the grid has about
    ``TARGET_BLOCKS`` blocks (never fewer than ``MIN_ROWS_PER_CHUNK`` rows a
    block, and chunk elements below 2^31)."""
    tile = min(vocab, TILE_BYTES // itemsize)
    tiles = -(-vocab // tile)
    chunks = max(1, -(-TARGET_BLOCKS // (tiles * batch)))
    chunks = min(chunks, max(1, -(-rows // MIN_ROWS_PER_CHUNK)))
    rows_per_chunk = max(1, -(-rows // chunks))
    rows_per_chunk = min(rows_per_chunk, (2 ** 31 - 1) // max(1, text_len))
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
        raise ValueError(f"batch {B} exceeds the grid's z limit")
    out = torch.zeros((B, vocab), dtype=weights.dtype, device=tokens.device)
    if B * R * L == 0:
        return out
    symbol, name = INSTANTIATIONS[weights.dtype]
    fn = getattr(build(), symbol)
    tile, rows_per_chunk = launch_shape(B, R, L, vocab,
                                        weights.element_size())
    with torch.cuda.device(tokens.device):
        stream = torch.cuda.current_stream(tokens.device).cuda_stream
        err = fn(tokens.data_ptr(), weights.data_ptr(), out.data_ptr(),
                 B, R, L, vocab, tile, rows_per_chunk, stream)
    if err != 0:
        raise RuntimeError(f"fct_count launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out
