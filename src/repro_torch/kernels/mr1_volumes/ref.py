"""Plain PyTorch version of MR¹'s statistics on routed relations (paper
Algorithm 3, stage 2): per-worker num-arrays, then each fact slot's volume
and its per-dimension contributions, gathered back onto the dimension
slots.

Index semantics follow the reference package explicitly, since torch index
ops raise where JAX's clamp or drop: gathers wrap a negative index once and
then clamp (:func:`clamp_index`); scatter-adds wrap once and drop what is
still out of range (:func:`scatter_add_drop`).  On the main path every
index is in range.
"""
from __future__ import annotations

from typing import Sequence

import torch


def clamp_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Gather index under JAX semantics: negative counts from the end
    (once), then out-of-range clamps to the edge."""
    idx = torch.where(idx < 0, idx + size, idx)
    return idx.clamp(0, size - 1)


def scatter_add_drop(target: torch.Tensor, dim: int, idx: torch.Tensor,
                     src: torch.Tensor) -> None:
    """In-place ``target.scatter_add_`` under ``.at[].add(mode="drop")``
    semantics: negative counts from the end (once); indices still outside
    ``[0, size)`` add nothing."""
    size = target.shape[dim]
    idx = torch.where(idx < 0, idx + size, idx)
    ok = (idx >= 0) & (idx < size)
    # fct-lint: waive[R2] -- every caller allocates target with an explicit dtype (num, contrib in mr1_volumes)
    target.scatter_add_(dim, torch.where(ok, idx, 0),
                        torch.where(ok, src, torch.zeros_like(src)))


def mr1_volumes(routed_fact, routed_dims, domains: Sequence[int],
                dtype: torch.dtype):
    """``routed_fact`` ``(keys [N, P, R, m], mask [N, P, R])`` and each
    routed dimension ``(keys [N, P, R_i], mask)`` -> ``(vol_fact [N, P,
    R], [vol_i [N, P, R_i]])`` in ``dtype``; products wrap as the
    reference's do."""
    fkeys, fmask = routed_fact
    N, P = fmask.shape[:2]
    dev = fmask.device
    m = len(routed_dims)
    nums = []
    for (dkeys, dmask), dom in zip(routed_dims, domains):
        num = torch.zeros((N, P, dom), dtype=torch.int32, device=dev)
        scatter_add_drop(num, 2, dkeys.long(), dmask.to(torch.int32))
        nums.append(num)
    fk = [fkeys[..., i].long() for i in range(m)]
    probes = [nums[i].gather(2, clamp_index(fk[i], domains[i])).to(dtype)
              for i in range(m)]
    fvalid = fmask.to(dtype)
    vol_fact = fvalid
    for pr in probes:
        vol_fact = vol_fact * pr
    dim_vols = []
    for i in range(m):
        others = fvalid
        for j in range(m):
            if j != i:
                others = others * probes[j]
        contrib = torch.zeros((N, P, domains[i]), dtype=dtype, device=dev)
        scatter_add_drop(contrib, 2, fk[i], others)
        dkeys, dmask = routed_dims[i]
        dim_vols.append(
            contrib.gather(2, clamp_index(dkeys.long(), domains[i]))
            * dmask.to(dtype))
    return vol_fact, dim_vols
