"""Hypercube (shares) task grid and key-bucket hashing (paper §4.1, §4.3.2).

A reduce *task* is a coordinate in the m-dimensional grid of shares
(a_1, ..., a_m); task id = row-major flattening.  Dimension-i rows with
``h_i(key) == c`` belong to every task whose i-th coordinate is ``c``;
a fact row belongs to exactly one task, ``(h_1(k_1), ..., h_m(k_m))``.

Hashing happens ONLY on the host planner (the paper's map-side
``getPartition()``); devices never hash — they execute a static routing plan.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

_MULT = np.int64(2654435761)
_MASK = np.int64(2**32 - 1)


def bucket_hash(keys: np.ndarray, n_buckets: int, salt: int = 0) -> np.ndarray:
    """Multiplicative hash of dense int keys into [0, n_buckets)."""
    x = (keys.astype(np.int64) + np.int64(salt + 1)) * _MULT & _MASK
    x ^= x >> np.int64(16)
    return (x % np.int64(n_buckets)).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class TaskGrid:
    shares: Tuple[int, ...]

    @property
    def n_tasks(self) -> int:
        return int(np.prod(self.shares))

    def coords_to_task(self, coords: np.ndarray) -> np.ndarray:
        """[rows, m] coords -> [rows] flat task ids (row-major)."""
        task = np.zeros(coords.shape[0], np.int64)
        for i, a in enumerate(self.shares):
            task = task * a + coords[:, i]
        return task

    def axis_coords(self, axis: int) -> np.ndarray:
        """Coordinate along ``axis`` of every task id (row-major layout)."""
        stride = int(np.prod(self.shares[axis + 1:], dtype=np.int64))
        return (np.arange(self.n_tasks) // stride) % self.shares[axis]

    def tasks_with_coord(self, axis: int, value: int) -> np.ndarray:
        """All task ids whose ``axis`` coordinate equals ``value``."""
        grids = np.meshgrid(
            *[np.arange(a) for a in self.shares], indexing="ij")
        sel = grids[axis] == value
        coords = np.stack([g[sel] for g in grids], axis=1)
        return self.coords_to_task(coords)

    def fact_tasks(self, key_cols: Sequence[np.ndarray], salt: int = 0) -> np.ndarray:
        coords = np.stack(
            [bucket_hash(k, a, salt + i)
             for i, (k, a) in enumerate(zip(key_cols, self.shares))], axis=1)
        return self.coords_to_task(coords)

    def dim_buckets(self, axis: int, keys: np.ndarray, salt: int = 0) -> np.ndarray:
        return bucket_hash(keys, self.shares[axis], salt + axis)


def over_decompose(shares: Tuple[int, ...], rho: int) -> Tuple[int, ...]:
    """Multiply the task grid by ρ for skew-aware scheduling (§4.2/§6.4).

    ρ is distributed over axes largest-first (keeps the grid near-cubic,
    which keeps dimension replication low).
    """
    shares = list(shares)
    r = rho
    while r > 1:
        # double the axis with the currently smallest share (cheapest to split)
        i = int(np.argmin(shares))
        shares[i] *= 2
        r //= 2
    return tuple(shares)
