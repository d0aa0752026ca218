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

    ``chunks`` records the append history as per-chunk row counts (None =
    one chunk covering every row).  Appends are the ONLY mutation that
    preserves derived state: :meth:`append_rows` returns a NEW Relation
    whose column arrays are fresh concatenations — the old object (and any
    plan/ref holding its arrays) keeps seeing the pre-append snapshot, and
    a prefix of the new arrays is value-identical to the old ones, so
    content-addressed device columns stay valid per chunk.
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

    def append_rows(self, keys: Mapping[str, np.ndarray],
                    text: np.ndarray,
                    domain_overrides: Optional[Mapping[str, int]] = None
                    ) -> "Relation":
        """New Relation with ``text.shape[0]`` rows appended as one chunk.

        Validates column set, dtypes, text width and key domains; an empty
        append returns ``self`` unchanged (no new chunk).  The returned
        relation's ``chunks`` grows by one entry; existing chunk boundaries
        never move, so refs built against the old object stay exact.
        ``domain_overrides`` grows named key domains (never shrinks them) —
        a dimension append introduces fresh primary-key values, and
        :meth:`StarSchema.with_appended` mirrors the growth into the fact's
        foreign-key domain to keep the schema invariant.
        """
        n_new = int(text.shape[0])
        if n_new == 0:
            return self
        if set(keys) != set(self.keys):
            raise ValueError(
                f"append to {self.name!r} must provide exactly the key "
                f"columns {sorted(self.keys)}, got {sorted(keys)}")
        if text.shape[1:] != self.text.shape[1:]:
            raise ValueError(
                f"append to {self.name!r}: text width {text.shape[1:]} != "
                f"{self.text.shape[1:]}")
        text = np.ascontiguousarray(text, np.int32)
        new_domains = dict(self.key_domains)
        for col, dom in (domain_overrides or {}).items():
            if dom < new_domains[col]:
                raise ValueError(
                    f"append to {self.name!r}: key domain {col!r} cannot "
                    f"shrink ({new_domains[col]} -> {dom})")
            new_domains[col] = int(dom)
        new_keys = {}
        for col, arr in keys.items():
            arr = np.ascontiguousarray(arr, np.int32)
            if arr.shape != (n_new,):
                raise ValueError(
                    f"append to {self.name!r}: key column {col!r} has shape "
                    f"{arr.shape}, expected ({n_new},)")
            dom = new_domains[col]
            if arr.size and (arr.min() < 0 or arr.max() >= dom):
                raise ValueError(
                    f"append to {self.name!r}: key column {col!r} outside "
                    f"[0, {dom})")
            new_keys[col] = np.concatenate([self.keys[col], arr])
        old_chunks = self.chunks if self.chunks is not None else (self.rows,)
        return Relation(
            name=self.name, keys=new_keys, key_domains=new_domains,
            text=np.concatenate([self.text, text]),
            chunks=old_chunks + (n_new,))

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

    def relation_role(self, name: str) -> Tuple[str, int]:
        """("fact", -1) or ("dim", i) for a relation name; KeyError else."""
        if name == self.fact.name:
            return "fact", -1
        for i, dim in enumerate(self.dims):
            if dim.name == name:
                return "dim", i
        raise KeyError(f"unknown relation {name!r} (fact is "
                       f"{self.fact.name!r}, dims are "
                       f"{[d.name for d in self.dims]})")

    def with_appended(self, name: str, keys: Mapping[str, np.ndarray],
                      text: np.ndarray) -> "StarSchema":
        """New StarSchema with rows appended to one relation as a chunk.

        The receiver is NOT mutated: callers that hold the old object (plans
        in flight, cached tuple sets) keep a consistent pre-append snapshot.
        Unchanged relations are shared by reference.

        A dimension append may introduce primary-key values past the current
        domain (new dim rows ARE new keys); the domain grows to cover them
        and the fact's matching foreign-key domain grows in lockstep (the
        schema invariant ``d_fact == d_dim``) — its column arrays are still
        shared, only the metadata dict is replaced.  Fact appends must
        reference existing dimension keys.
        """
        role, i = self.relation_role(name)
        if role == "fact":
            return StarSchema(fact=self.fact.append_rows(keys, text),
                              dims=self.dims, edges=self.edges,
                              vocab_size=self.vocab_size)
        edge = self.edges[i]
        dims = list(self.dims)
        pk = np.asarray(keys[edge.dim_col]) if edge.dim_col in keys else None
        new_dom = dims[i].key_domains[edge.dim_col]
        if pk is not None and pk.size:
            new_dom = max(new_dom, int(pk.max()) + 1)
        dims[i] = dims[i].append_rows(
            keys, text, domain_overrides={edge.dim_col: new_dom})
        fact = self.fact
        if new_dom != fact.key_domains[edge.fact_col]:
            fact = dataclasses.replace(
                fact, key_domains={**fact.key_domains,
                                   edge.fact_col: new_dom})
        return StarSchema(fact=fact, dims=tuple(dims), edges=self.edges,
                          vocab_size=self.vocab_size)

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
