"""Performance switches: the reference's ``distributed/perf_options.py``,
with the same option names and scoping.

Each option is one hypothesis->change pair from the reference's
performance log; ``perf_options(...)`` turns options on for a ``with``
block (nested blocks add to the outer set), ``enabled(name)`` reads them.
What each does in the port:

    rwkv_chunked    the chunk-parallel WKV (``models/rwkv6.py``
                    ``_wkv_chunked``) for a prefill whose length is a
                    multiple of 16
    remat_dots      activation checkpointing that keeps the 2-D matrix
                    products' outputs (``models/model.py``), whatever
                    ``cfg.remat`` says
    moe_shardmap    the expert-parallel MoE over the virtual (data x
                    model) grid that ``virtual_grid`` sets
                    (``models/moe.py``); without a grid the single-program
                    path runs, as the reference's needs a mesh
    bf16_flash, flash_big_blocks
                    shape only the reference's Pallas kernel (its block
                    math dtype and q block); the port's kernel picks its
                    own tiles and always keeps float32 statistics
    no_fsdp, seq_shard_attn
                    no counterpart on one card: there are no weights
                    sharded over a data axis to replicate, and no model
                    axis to shard the attention's sequence over

``virtual_grid(data, model)`` stands for the reference's activation-sharding
context (a (data, model) device mesh): P = data x model simulated ranks on
one device.
"""
from __future__ import annotations

import contextlib
from typing import FrozenSet, Optional, Tuple

_ACTIVE: FrozenSet[str] = frozenset()
_GRID: Optional[Tuple[int, int]] = None

KNOWN = frozenset({"bf16_flash", "seq_shard_attn", "moe_shardmap",
                   "remat_dots", "no_fsdp", "flash_big_blocks",
                   "rwkv_chunked"})


def active() -> FrozenSet[str]:
    return _ACTIVE


def enabled(name: str) -> bool:
    return name in _ACTIVE


@contextlib.contextmanager
def perf_options(*names: str):
    global _ACTIVE
    bad = set(names) - KNOWN
    assert not bad, f"unknown perf options: {bad}"
    old = _ACTIVE
    _ACTIVE = frozenset(names) | old
    try:
        yield
    finally:
        _ACTIVE = old


def grid() -> Optional[Tuple[int, int]]:
    """The (data, model) ranks of the active ``virtual_grid``, or None."""
    return _GRID


@contextlib.contextmanager
def virtual_grid(data: int, model: int):
    global _GRID
    if data < 1 or model < 1:
        raise ValueError(f"grid ranks must be >= 1, got {data} x {model}")
    old = _GRID
    _GRID = (int(data), int(model))
    try:
        yield
    finally:
        _GRID = old
