"""The one general generator of request streams, driven by a traffic file.

A traffic file (``bench/traffic/<mix>.json``) names a ``pool`` of keyword
sets (indexes into the configuration's planted keywords), the ``top_k``
values and optional integer ``weights`` of the pool's entries.  The stream
is made of blocks: each block holds every (pool entry, top_k) pair
``weight`` times, in an order drawn from the seed.  So every seed sends the
same mix in another order, and the work of a window does not depend on the
seed beyond the data itself.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

STREAM = 1          # seeds the request order apart from the data


def pool(cfg: dict, traffic: dict) -> List[Tuple[int, ...]]:
    """The traffic's keyword sets as token ids."""
    kws = cfg["planted"]["keywords"]
    return [tuple(kws[i] for i in entry) for entry in traffic["pool"]]


def block(traffic: dict) -> List[Tuple[int, int]]:
    """One block of ``(pool index, top_k)`` pairs, in order."""
    weights = traffic.get("weights", [1] * len(traffic["pool"]))
    return [(i, k) for i, w in enumerate(weights)
            for k in traffic["top_k"] for _ in range(w)]


def requests(traffic: dict, seed: int) -> Iterator[Tuple[int, int]]:
    """Endless ``(pool index, top_k)`` stream of shuffled blocks."""
    rng = np.random.default_rng([int(seed), STREAM])
    pairs = block(traffic)
    while True:
        for j in rng.permutation(len(pairs)):
            yield pairs[j]
