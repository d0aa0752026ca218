"""The FCT engine's worker mesh as a virtual mesh on one device.

The reference runs P workers on a ``("w",)`` device mesh.  Here P workers are
a leading tensor axis on ONE device: an all_to_all swaps the ``[src, dst]``
axes of a routed buffer, a psum is a sum over the worker axis, and a
psum_scatter is that sum over a vocab padded to a multiple of P.  Routing,
shuffle accounting and results are those of P real workers; only the
hardware parallelism differs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


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
