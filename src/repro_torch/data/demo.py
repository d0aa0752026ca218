"""A small TPC-H-like star database with real string payloads.

PART/SUPPLIER/ORDERS ⋈ LINEITEM, with texts drawn from small word lists
and tokenized by a :class:`HashingTokenizer`, so queries such as
{"alps", "bordeaux"} decode to readable terms.  Used by
``python -m repro_torch.launch.fct_run``.
"""
import numpy as np

from repro_torch.data.schema import JoinEdge, Relation, StarSchema
from repro_torch.data.tokenizer import HashingTokenizer

VOCAB = 4096
TOK = HashingTokenizer(VOCAB)

PART_WORDS = ["anodized", "brushed", "burnished", "polished", "plated"]
COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque"]
SUPP_WORDS = ["alps", "express", "logistics", "freight", "dispatch"]
ORDER_WORDS = ["bordeaux", "priority", "economy", "registered", "fragile"]


def build_db(seed=0, n_part=120, n_supp=60, n_order=150, n_fact=2000):
    rng = np.random.default_rng(seed)

    def texts(words, n, extra):
        rows = []
        for i in range(n):
            w = list(rng.choice(words, size=2)) + list(rng.choice(extra, size=2))
            rows.append(" ".join(w))
        return TOK.encode_batch(rows, 6)

    part = Relation("PART", {"partkey": np.arange(n_part, dtype=np.int32)},
                    {"partkey": n_part}, texts(PART_WORDS, n_part, COLORS))
    supp = Relation("SUPPLIER", {"suppkey": np.arange(n_supp, dtype=np.int32)},
                    {"suppkey": n_supp}, texts(SUPP_WORDS, n_supp, COLORS))
    orders = Relation("ORDERS", {"orderkey": np.arange(n_order, dtype=np.int32)},
                      {"orderkey": n_order},
                      texts(ORDER_WORDS, n_order, COLORS))
    fact = Relation(
        "LINEITEM",
        {"partkey": rng.integers(0, n_part, n_fact).astype(np.int32),
         "suppkey": rng.integers(0, n_supp, n_fact).astype(np.int32),
         "orderkey": rng.integers(0, n_order, n_fact).astype(np.int32)},
        {"partkey": n_part, "suppkey": n_supp, "orderkey": n_order},
        texts(["shipped", "returned", "pending"], n_fact, COLORS))
    return StarSchema(fact=fact, dims=[part, supp, orders],
                      edges=[JoinEdge("PART", "partkey", "partkey"),
                             JoinEdge("SUPPLIER", "suppkey", "suppkey"),
                             JoinEdge("ORDERS", "orderkey", "orderkey")],
                      vocab_size=VOCAB)
