"""Relational substrate with dense, static-shape storage.

A Relation is stored as
  * one int32 key column per join attribute (dense key ids in [0, domain)),
  * an int32 token matrix ``text[rows, text_len]`` (PAD_ID padded) holding the
    tokenized concatenation of all non-key attributes.

A Schema describes a star (or snowflake, after pre-joining) layout: one fact
relation joined to ``m`` dimension relations through (fact_col -> dim_col)
foreign keys.  This mirrors the paper's experimental setup (LINEITEM fact;
PART / SUPPLIER / ORDERS dimensions).

Everything here is host numpy; only :func:`as_device_arrays` touches torch.
:meth:`StarSchema.from_arrays` and :func:`schema_from_reference` build a
schema from plain arrays, or from any object that exposes the same attribute
layout (``.fact``, ``.dims``, ``.edges``, ``.vocab_size``; per relation
``.name``, ``.keys``, ``.key_domains``, ``.text``), so one generated dataset
can be handed to another implementation of the same engine array for array.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

PAD_ID = 0  # token id reserved for padding; never counted as a term


@dataclasses.dataclass
class Relation:
    """A relation with dense int key columns and a fixed-width token matrix.

    ``chunks`` records an append history as per-chunk row counts (None =
    one chunk covering every row).  The runtime's device store does not
    take multi-chunk relations yet (incremental ingest is not ported).
    """

    name: str
    keys: Mapping[str, np.ndarray]        # col -> int32 [rows]
    key_domains: Mapping[str, int]        # col -> domain size (keys < domain)
    text: np.ndarray                      # int32 [rows, text_len]
    chunks: Optional[Tuple[int, ...]] = None  # append-chunk row counts

    def __post_init__(self) -> None:
        rows = self.text.shape[0]
        for col, arr in self.keys.items():
            assert arr.shape == (rows,), (self.name, col, arr.shape, rows)
            assert arr.dtype == np.int32
        assert self.text.dtype == np.int32
        if self.chunks is not None:
            assert sum(self.chunks) == rows, (self.name, self.chunks, rows)
            assert all(c > 0 for c in self.chunks), (self.name, self.chunks)

    @property
    def rows(self) -> int:
        return int(self.text.shape[0])

    @property
    def text_len(self) -> int:
        return int(self.text.shape[1])

    def take(self, idx: np.ndarray) -> "Relation":
        # a row subset is not chunk-aligned: the copy is a fresh single chunk
        return Relation(
            name=self.name,
            keys={c: np.asarray(a[idx], np.int32) for c, a in self.keys.items()},
            key_domains=dict(self.key_domains),
            text=np.asarray(self.text[idx], np.int32),
        )

    @classmethod
    def from_arrays(cls, name: str, keys: Mapping[str, np.ndarray],
                    key_domains: Mapping[str, int], text: np.ndarray,
                    chunks: Optional[Sequence[int]] = None) -> "Relation":
        """A relation over copies of array-likes, cast to the storage dtypes."""
        return cls(name=str(name),
                   keys={str(c): np.array(a, np.int32) for c, a in keys.items()},
                   key_domains={str(c): int(d) for c, d in key_domains.items()},
                   text=np.array(text, np.int32),
                   chunks=None if chunks is None else tuple(int(c)
                                                            for c in chunks))


@dataclasses.dataclass(frozen=True)
class JoinEdge:
    """fact.fact_col references dim.dim_col (FK -> PK in the schema graph)."""

    dim_name: str
    fact_col: str
    dim_col: str


@dataclasses.dataclass
class StarSchema:
    """One fact relation + m dimensions; the paper's star candidate network."""

    fact: Relation
    dims: Sequence[Relation]
    edges: Sequence[JoinEdge]  # edges[i] joins fact to dims[i]
    vocab_size: int

    def __post_init__(self) -> None:
        assert len(self.dims) == len(self.edges)
        for dim, edge in zip(self.dims, self.edges):
            assert dim.name == edge.dim_name
            d_fact = self.fact.key_domains[edge.fact_col]
            d_dim = dim.key_domains[edge.dim_col]
            assert d_fact == d_dim, (edge, d_fact, d_dim)

    @property
    def m(self) -> int:
        return len(self.dims)

    def key_domain(self, i: int) -> int:
        return self.fact.key_domains[self.edges[i].fact_col]

    def fact_keys(self, i: int) -> np.ndarray:
        return self.fact.keys[self.edges[i].fact_col]

    def dim_keys(self, i: int) -> np.ndarray:
        return self.dims[i].keys[self.edges[i].dim_col]

    @classmethod
    def from_arrays(cls, fact: Mapping, dims: Sequence[Mapping],
                    edges: Sequence[Tuple[str, str, str]],
                    vocab_size: int) -> "StarSchema":
        """Build a schema from plain data.

        ``fact`` and each of ``dims`` map ``name``, ``keys`` (column ->
        array), ``key_domains`` (column -> int), ``text`` (``[rows, L]``)
        and optionally ``chunks``; ``edges`` are ``(dim_name, fact_col,
        dim_col)`` triples, one per dimension in order.
        """
        return cls(fact=Relation.from_arrays(**fact),
                   dims=[Relation.from_arrays(**d) for d in dims],
                   edges=[JoinEdge(str(a), str(b), str(c)) for a, b, c in edges],
                   vocab_size=int(vocab_size))


def _relation_fields(rel) -> dict:
    return {"name": rel.name,
            "keys": {c: np.asarray(a) for c, a in rel.keys.items()},
            "key_domains": dict(rel.key_domains),
            "text": np.asarray(rel.text),
            "chunks": getattr(rel, "chunks", None)}


def schema_from_reference(obj) -> StarSchema:
    """A :class:`StarSchema` copied from any object with the star-schema
    attribute layout (see the module docstring).  Reads arrays through
    numpy only; the source object's package is never imported."""
    return StarSchema.from_arrays(
        fact=_relation_fields(obj.fact),
        dims=[_relation_fields(d) for d in obj.dims],
        edges=[(e.dim_name, e.fact_col, e.dim_col) for e in obj.edges],
        vocab_size=obj.vocab_size)


def keyword_mask(text: np.ndarray, keywords: Sequence[int]) -> np.ndarray:
    """Bitmask [rows] of which query keywords each row's text contains."""
    rows = text.shape[0]
    mask = np.zeros((rows,), np.int64)
    for bit, kw in enumerate(keywords):
        mask |= (text == kw).any(axis=1).astype(np.int64) << bit
    return mask


def count_token(text: np.ndarray, token: int) -> np.ndarray:
    """Occurrences (with multiplicity) of ``token`` per row."""
    return (text == token).sum(axis=1).astype(np.int64)


def tokens_histogram(text: np.ndarray, weights: np.ndarray, vocab: int) -> np.ndarray:
    """Weighted token histogram: hist[w] = sum_rows weight[row]*count(row, w).

    Host/numpy oracle used by the single-machine star baseline.
    """
    flat = text.reshape(-1)
    w = np.repeat(np.asarray(weights, np.int64), text.shape[1])
    hist = np.bincount(flat, weights=w, minlength=vocab)[:vocab]
    hist[PAD_ID] = 0
    return hist.astype(np.int64)


def as_device_arrays(rel: Relation, device) -> dict:
    """Pack a relation into int32 torch tensors on ``device``."""
    out = {f"key:{c}": torch.as_tensor(v, device=device)
           for c, v in rel.keys.items()}
    out["text"] = torch.as_tensor(rel.text, device=device)
    return out
