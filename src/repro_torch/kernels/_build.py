"""Build and load a hand-written CUDA source as a ctypes library.

Each kernel keeps its source under ``csrc/`` and exports plain C launchers.
A :class:`Library` stands for one source: at its first ``load()`` — a
kernel's first CUDA call, never at import — it compiles the source with
``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the checkout root,
under a name keyed by a hash of the source, so an edited source rebuilds.
The library is loaded with ``ctypes`` and every exported launcher gets its
``argtypes`` (pointers and the stream as ``c_void_p``, or ctypes would cut
them to 32 bits) and an ``int`` return, the kernel's ``cudaGetLastError()``.
When ``nvcc`` is missing or the build fails, ``load`` raises: there is no
fallback.  ``launch`` runs one launcher on PyTorch's current stream, raises
on a non-zero return and counts the launch in ``launches``, which moves
nowhere else.  Launch counts and the ops' path counts move through
:func:`bump` and :func:`reset_counts` under one process-wide lock, so they
stay exact when several threads dispatch (the serving gateway's flush pool,
the submit pipeline).  Inside :func:`held_bumps` a thread's bumps are held
back instead: a CUDA graph capture launches nothing, so the engine holds
what its capture would count and adds it (:func:`add_bumps`) at each
replay, which runs the captured launches.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# ctypes argument kinds of the exported C functions
PTR, I32, I64, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_float)

_COUNT_LOCK = threading.Lock()
_HELD = threading.local()


def bump(counts: Dict[str, int], key: str) -> None:
    """``counts[key] += 1``, exact under threads; inside :func:`held_bumps`
    the bump is held in that block's list instead."""
    held = getattr(_HELD, "bumps", None)
    if held is not None:
        held.append((counts, key))
        return
    with _COUNT_LOCK:
        counts[key] += 1


@contextlib.contextmanager
def held_bumps() -> Iterator[List[Tuple[Dict[str, int], str]]]:
    """Holds back this thread's bumps inside the block and yields them as
    ``(counts, key)`` pairs, for :func:`add_bumps` to apply later."""
    outer = getattr(_HELD, "bumps", None)
    _HELD.bumps = held = []
    try:
        yield held
    finally:
        _HELD.bumps = outer


def add_bumps(bumps: Iterable[Tuple[Dict[str, int], str]]) -> None:
    """Applies bumps held by :func:`held_bumps`, each once."""
    for counts, key in bumps:
        bump(counts, key)


def reset_counts(counts: Dict[str, int]) -> None:
    """Every entry of ``counts`` to 0, under the same lock as :func:`bump`."""
    with _COUNT_LOCK:
        for k in counts:
            counts[k] = 0


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME); the CUDA kernels "
                       "cannot be built")


class Library:
    """One CUDA source: its lazily built library and its launch counts.

    ``symbols`` maps each exported function to its argument kinds: a
    launcher's end with the stream, and a function that launches nothing
    (called on ``load()``'s library, not through ``launch``) has none;
    ``kernels`` names the counters in ``launches`` (default:
    one counter named after the library)."""

    def __init__(self, name: str, source: Path,
                 symbols: Dict[str, Sequence],
                 kernels: Optional[Iterable[str]] = None):
        self.name = name
        self.source = Path(source)
        self.symbols = dict(symbols)
        self.launches: Dict[str, int] = {k: 0 for k in (kernels or (name,))}
        #: seconds ``nvcc`` took (about 0 when the library was already built)
        self.build_seconds: Optional[float] = None
        #: what ``nvcc`` printed when it built the library here (ptxas's
        #: registers, spills and shared memory per kernel), else None
        self.build_log: Optional[str] = None
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def load(self) -> ctypes.CDLL:
        """Compile the source unless its library is there, load it and type
        its launchers; later calls return the loaded library."""
        with self._lock:
            if self._lib is None:
                t0 = time.perf_counter()
                path = self.path
                if not path.exists():
                    self._compile(path)
                self.build_seconds = time.perf_counter() - t0
                lib = ctypes.CDLL(str(path))
                for symbol, argtypes in self.symbols.items():
                    fn = getattr(lib, symbol)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def _compile(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{self.name}: nvcc failed ({res.returncode}):"
                               f"\n{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, path)
        self.build_log = res.stdout + res.stderr

    def launch(self, symbol: str, kernel: str, device: torch.device,
               *args) -> None:
        """Call launcher ``symbol`` with ``args`` and the current stream of
        ``device``; raise on its non-zero ``cudaGetLastError()`` (a refused
        launch never runs, and a later synchronize would not report it),
        else count one launch of ``kernel``."""
        fn = getattr(self.load(), symbol)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        bump(self.launches, kernel)

    def reset_launches(self) -> None:
        reset_counts(self.launches)


def build_all(libraries: Sequence[Library]) -> None:
    """Load several libraries at once: one ``nvcc`` per source, all started
    together."""
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        for future in [pool.submit(lib.load) for lib in libraries]:
            future.result()
