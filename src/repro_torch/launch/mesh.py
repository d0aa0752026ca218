"""The FCT engine's worker mesh as a virtual mesh on one device.

The reference runs P workers on a ``("w",)`` device mesh.  Here P workers are
a leading tensor axis on ONE device: an all_to_all swaps the ``[src, dst]``
axes of a routed buffer, a psum is a sum over the worker axis, and a
psum_scatter is that sum over a vocab padded to a multiple of P.  Routing,
shuffle accounting and results are those of P real workers; only the
hardware parallelism differs.

Every movement across the virtual workers goes through one of the named
functions below (:func:`all_to_all`, :func:`psum`, :func:`psum_scatter`,
:func:`all_gather`), so a :func:`collective_census` can count them, as the
reference's contract checker counts the collectives of a traced program.
Outside a census they cost one thread-local lookup.  A program replayed
from a CUDA graph calls none of them: the engine counts its collectives at
capture, in a census of its own, and adds them at each replay
(:func:`add_to_census`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Iterator, Optional, Tuple, Union

import torch

#: the collectives a census counts
COLLECTIVES = ("all_to_all", "psum", "psum_scatter", "all_gather")

_CENSUS = threading.local()


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means CUDA.  Asking for CUDA where there is none raises —
    entry points never carry on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    """``n_workers`` simulated workers on one ``device``.  Frozen and
    hashable: it is part of the program-cache key, as the reference's mesh
    is."""

    n_workers: int
    device: torch.device

    def __post_init__(self) -> None:
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")

    @property
    def size(self) -> int:
        return self.n_workers


def make_worker_mesh(n: int = 1, device=None) -> VirtualMesh:
    """P = ``n`` workers on ``device`` (``None`` = CUDA, see
    :func:`resolve_device`)."""
    return VirtualMesh(int(n), resolve_device(device))


def vocab_padded(vocab: int, n_devices: int) -> int:
    """Vocab rounded up so each worker owns an equal ``vocab/P`` bin shard
    under reduce-scatter aggregation.  The pad bins are structurally zero
    (the histogram never writes past ``vocab``), so slicing them off on the
    host is exact."""
    return -(-vocab // n_devices) * n_devices


@contextlib.contextmanager
def collective_census() -> Iterator[Dict[str, int]]:
    """Counts the collectives this thread runs inside the block, by name
    (:data:`COLLECTIVES`); yields the live counts."""
    counts = dict.fromkeys(COLLECTIVES, 0)
    outer = getattr(_CENSUS, "counts", None)
    _CENSUS.counts = counts
    try:
        yield counts
    finally:
        _CENSUS.counts = outer


def _tally(name: str) -> None:
    counts = getattr(_CENSUS, "counts", None)
    if counts is not None:
        counts[name] += 1


def add_to_census(counts: Dict[str, int]) -> None:
    """Adds collectives counted elsewhere to this thread's census, if one is
    open."""
    active = getattr(_CENSUS, "counts", None)
    if active is not None:
        for name, n in counts.items():
            active[name] += n


def all_to_all(send: torch.Tensor) -> torch.Tensor:
    """The routing shuffle: a ``[N, P(src), P(dst), ...]`` send table seen
    from the destinations, ``[N, P(dst), P(src), ...]``.  One swap routes a
    relation's text, keys and mask together: each destination gathers the
    rows its sources name (the reference moves the three buffers by three
    ``all_to_all``\\ s)."""
    _tally("all_to_all")
    return send.transpose(1, 2)


def psum(hist: torch.Tensor) -> torch.Tensor:
    """The sum over workers in the psum layout (the whole vocab on every
    worker).  MR² counts every worker's rows in one histogram, the worker
    axis folded into the row axis, so the histogram it is given is that sum
    already (integer addition is associative: the same bits)."""
    _tally("psum")
    return hist


def psum_scatter(hist: torch.Tensor, n_workers: int) -> torch.Tensor:
    """The sum over workers in the reduce-scatter layout: as :func:`psum`,
    with the last (vocab) axis zero-padded to a multiple of ``n_workers``,
    so worker w owns bins ``[w*V/P, (w+1)*V/P)``."""
    _tally("psum_scatter")
    vocab = hist.shape[-1]
    pad = vocab_padded(vocab, n_workers) - vocab
    return torch.nn.functional.pad(hist, (0, pad)) if pad else hist


def all_gather(*shards: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Tiled all_gather over the worker axis: each ``[P, k]`` tensor (worker
    w's k values in row w) as ``[P * k]``, worker-major.  One call moves
    every tensor given (the reference gathers each separately)."""
    _tally("all_gather")
    return tuple(s.reshape(-1) for s in shards)
