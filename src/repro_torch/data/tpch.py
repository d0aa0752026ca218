"""Synthetic TPC-H-like dataset generator (the paper's benchmark layout).

LINEITEM is the fact relation; PART, SUPPLIER and ORDERS are dimensions
(the paper links PART and SUPPLIER directly to LINEITEM, §6.1).  CUSTOMER is
generated too so the chain-type queries can pre-join CUSTOMER⋈ORDERS exactly
as the paper does for Q4–Q9.

Two key-frequency modes:
  * ``skew=0``  — foreign keys drawn uniformly (the §4.1 assumption),
  * ``skew>0``  — foreign keys drawn Zipf(a=1+skew) (the §4.2 "travel agent"
                  scenario: a handful of dimension keys own most fact rows).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.schema import PAD_ID, JoinEdge, Relation, StarSchema


@dataclasses.dataclass(frozen=True)
class TpchConfig:
    scale: float = 1.0          # multiplies all row counts
    fact_rows: int = 8192
    part_rows: int = 1024
    supp_rows: int = 512
    order_rows: int = 2048
    cust_rows: int = 256
    text_len: int = 12
    vocab_size: int = 4096
    skew: float = 0.0           # Zipf exponent - 1 for fact foreign keys
    seed: int = 0

    def rows(self, base: int) -> int:
        return max(4, int(base * self.scale))


def _zipf_keys(rng: np.random.Generator, n: int, domain: int, skew: float) -> np.ndarray:
    if skew <= 0:
        return rng.integers(0, domain, size=n, dtype=np.int64).astype(np.int32)
    ranks = np.arange(1, domain + 1, dtype=np.float64)
    p = ranks ** -(1.0 + skew)
    p /= p.sum()
    return rng.choice(domain, size=n, p=p).astype(np.int32)


def _text(rng: np.random.Generator, rows: int, length: int, vocab: int) -> np.ndarray:
    # Zipf-ish token frequencies so "frequent co-occurring terms" exist.
    ranks = np.arange(1, vocab, dtype=np.float64)
    p = ranks ** -1.1
    p /= p.sum()
    t = rng.choice(np.arange(1, vocab), size=(rows, length), p=p).astype(np.int32)
    # sprinkle PAD to emulate variable-length records
    pad = rng.random((rows, length)) < 0.1
    t[pad] = PAD_ID
    return t


def generate(cfg: TpchConfig) -> StarSchema:
    rng = np.random.default_rng(cfg.seed)
    nf, np_, ns, no = (cfg.rows(cfg.fact_rows), cfg.rows(cfg.part_rows),
                       cfg.rows(cfg.supp_rows), cfg.rows(cfg.order_rows))

    part = Relation(
        "PART",
        keys={"partkey": np.arange(np_, dtype=np.int32)},
        key_domains={"partkey": np_},
        text=_text(rng, np_, cfg.text_len, cfg.vocab_size),
    )
    supplier = Relation(
        "SUPPLIER",
        keys={"suppkey": np.arange(ns, dtype=np.int32)},
        key_domains={"suppkey": ns},
        text=_text(rng, ns, cfg.text_len, cfg.vocab_size),
    )
    orders = Relation(
        "ORDERS",
        keys={"orderkey": np.arange(no, dtype=np.int32)},
        key_domains={"orderkey": no},
        text=_text(rng, no, cfg.text_len, cfg.vocab_size),
    )
    lineitem = Relation(
        "LINEITEM",
        keys={
            "partkey": _zipf_keys(rng, nf, np_, cfg.skew),
            "suppkey": _zipf_keys(rng, nf, ns, cfg.skew),
            "orderkey": _zipf_keys(rng, nf, no, cfg.skew),
        },
        key_domains={"partkey": np_, "suppkey": ns, "orderkey": no},
        text=_text(rng, nf, cfg.text_len, cfg.vocab_size),
    )
    return StarSchema(
        fact=lineitem,
        dims=[part, supplier, orders],
        edges=[
            JoinEdge("PART", "partkey", "partkey"),
            JoinEdge("SUPPLIER", "suppkey", "suppkey"),
            JoinEdge("ORDERS", "orderkey", "orderkey"),
        ],
        vocab_size=cfg.vocab_size,
    )


def generate_customer(cfg: TpchConfig) -> Relation:
    """CUSTOMER relation for chain-type queries (pre-joined with ORDERS)."""
    rng = np.random.default_rng(cfg.seed + 1)
    nc = cfg.rows(cfg.cust_rows)
    return Relation(
        "CUSTOMER",
        keys={"custkey": np.arange(nc, dtype=np.int32)},
        key_domains={"custkey": nc},
        text=_text(rng, nc, cfg.text_len, cfg.vocab_size),
    )


def prejoin_orders_customer(orders: Relation, customer: Relation,
                            cust_of_order: np.ndarray) -> Relation:
    """Repartition-join CUSTOMER into ORDERS (the paper's chain/mix recipe).

    The merged relation keeps ORDERS' key column and concatenates texts —
    afterwards the chain query runs through the same star machinery.
    """
    ctext = customer.text[cust_of_order]
    merged = np.concatenate([orders.text, ctext], axis=1)
    return Relation(
        name="ORDERS_CUSTOMER",
        keys=dict(orders.keys),
        key_domains=dict(orders.key_domains),
        text=np.asarray(merged, np.int32),
    )


def plant_keywords(schema: StarSchema, keywords_per_relation: dict,
                   frac: float = 0.3, seed: int = 7) -> StarSchema:
    """Inject query keywords into a fraction of rows of chosen relations.

    ``keywords_per_relation``: relation name -> list of token ids to plant.
    Guarantees the generated keyword queries have non-empty result sets
    (the paper's query-generation step 1-2, §6.1).
    """
    rng = np.random.default_rng(seed)

    def plant(rel: Relation, kws) -> Relation:
        text = rel.text.copy()
        for kw in kws:
            rows = rng.random(rel.rows) < frac
            col = rng.integers(0, rel.text_len, size=rel.rows)
            idx = np.nonzero(rows)[0]
            text[idx, col[idx]] = kw
        return Relation(rel.name, rel.keys, rel.key_domains, text)

    fact = schema.fact
    dims = list(schema.dims)
    if fact.name in keywords_per_relation:
        fact = plant(fact, keywords_per_relation[fact.name])
    for i, d in enumerate(dims):
        if d.name in keywords_per_relation:
            dims[i] = plant(d, keywords_per_relation[d.name])
    return StarSchema(fact=fact, dims=dims, edges=schema.edges,
                      vocab_size=schema.vocab_size)
