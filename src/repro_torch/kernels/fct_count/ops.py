"""Public op: weighted token histogram, dispatched by device.

    backend="auto"   the tensors' device decides: a CPU tensor takes the
                     plain version (ref.py), a CUDA tensor the hand-written
                     kernel (kernel.py) — which raises if it cannot build or
                     launch; nothing falls back
    backend="ref"    the plain version on any device (explicit only: the
                     chip smoke's kernel-vs-plain comparison asks for it)
    backend="cuda"   the kernel; raises on a CPU tensor

Integer weights (int32, int64) take the integer-exact kernel
instantiations, float32 weights the float one (exact only for totals below
2^24; its atomics add in no fixed order).

:func:`routed_histogram` is MR² by reference, dispatched the same way: on
the card the routed kernel reads each routed slot's tokens through the
send table from the CNs' store-resident texts; the plain version builds
the routed tokens and counts them.

``PATH_COUNTS`` tallies which path each call took ("ref", "cuda_exact",
"cuda_float", "cuda_routed") so a run can show that its histograms went
through the kernel.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fct_count import kernel, ref

PATH_COUNTS = {"ref": 0, "cuda_exact": 0, "cuda_float": 0, "cuda_routed": 0}


def reset_path_counts() -> None:
    _build.reset_counts(PATH_COUNTS)


def weighted_histogram(tokens: torch.Tensor, weights: torch.Tensor,
                       vocab: int, backend: str = "auto") -> torch.Tensor:
    """freq[..., w] = Σ_rows weight[..., row]·count(tokens[..., row], w).

    ``tokens [B, R, L]`` with ``weights [B, R]`` -> ``[B, vocab]``, or the
    unbatched ``[R, L]`` / ``[R]`` -> ``[vocab]``.  PAD is never counted;
    the output dtype follows ``weights``.
    """
    unbatched = tokens.dim() == 2
    if unbatched:
        tokens, weights = tokens.unsqueeze(0), weights.unsqueeze(0)
    if backend == "auto":
        backend = "cuda" if tokens.is_cuda else "ref"
    if backend == "ref":
        _build.bump(PATH_COUNTS, "ref")
        out = ref.weighted_histogram(tokens, weights, vocab)
    elif backend == "cuda":
        out = kernel.fct_count(tokens.contiguous(), weights.contiguous(),
                               vocab)
        _build.bump(PATH_COUNTS, "cuda_float"
                    if weights.dtype.is_floating_point else "cuda_exact")
    else:
        raise ValueError(f"unknown fct_count backend {backend!r}")
    return out[0] if unbatched else out


def routed_histogram(texts: Sequence[torch.Tensor], send: torch.Tensor,
                     weights: torch.Tensor, vocab: int,
                     pointers: Optional[torch.Tensor] = None,
                     backend: str = "auto") -> torch.Tensor:
    """freq[n, w] = Σ_(dst, src, c) weights[n, dst, src·C + c] ·
    count(texts[n][src, clamp(send[n, src, dst, c], 0, S-1)], w).

    ``texts``: N ``[P, S, L]`` int32 texts, ``send [N, P, P, C]`` int32,
    ``weights [N, P, P*C]`` -> ``[N, vocab]`` in the weight dtype.
    ``pointers`` (the card only) is the texts' resident address table
    (``kernel.text_pointers``).  Backends as :func:`weighted_histogram`."""
    if backend == "auto":
        backend = "cuda" if send.is_cuda else "ref"
    if backend == "ref":
        _build.bump(PATH_COUNTS, "ref")
        return ref.routed_weighted_histogram(texts, send, weights, vocab)
    if backend == "cuda":
        out = kernel.fct_count_routed(texts, send.contiguous(),
                                      weights.contiguous(), vocab, pointers)
        _build.bump(PATH_COUNTS, "cuda_routed")
        return out
    raise ValueError(f"unknown fct_count backend {backend!r}")
