"""The benchmark's TPC-H chain generator: the raw tables of the chain
CUSTOMER - ORDERS - LINEITEM - SUPPLIER (and PART), before CUSTOMER is
pre-joined into ORDERS.

Drawn as ``bench/data/tpch.py`` draws the star (its text, planting and
foreign-key draws, on ``device`` from ``torch.Generator``s), with:

* CUSTOMER: ``rows["CUSTOMER"]`` rows, dense keys ``0..n-1``, text as every
  other relation's;
* ORDERS' ``custkey`` (TPC-H clause 4.2.3's O_CUSTKEY): uniform over the
  customers whose 1-based key is not a multiple of ``skip_multiples_of``
  (those hold no orders);
* planting into the base relations the configuration names, before any
  join: a keyword planted in CUSTOMER reaches every order of the customer
  once the pre-join concatenates the texts.

What the seed changes.  The rows, and the customer of each order, are
drawn from the configuration's ``data_seed``; the run's seed then permutes
the rows of LINEITEM (with its foreign keys), and the texts of PART,
SUPPLIER and ORDERS against their primary keys, an order's ``custkey``
moving with its text.  CUSTOMER keeps its order, so the pre-joined rows
are the same for every seed: the same tuple sets and the same candidate
networks, joined to LINEITEM differently.

Tables come back as numpy int32 arrays, ``{name: {"keys": {col: [rows]},
"domains": {col: n}, "text": [rows, text_len]}}``; ORDERS holds its
``orderkey`` and ``custkey`` columns.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bench.data.tpch import foreign_keys, plant, text_draws


def custkeys(n_orders: int, n_customers: int, spec: dict,
             gen: torch.Generator, device) -> torch.Tensor:
    """Each order's customer row: uniform over the customers whose 1-based
    key is not a multiple of ``spec["skip_multiples_of"]``."""
    if spec["dist"] != "uniform":
        raise ValueError(f"unknown custkey distribution {spec['dist']!r}")
    keys = torch.arange(n_customers, device=device)
    eligible = keys[(keys + 1) % int(spec["skip_multiples_of"]) != 0]
    pick = torch.randint(0, len(eligible), (n_orders,), generator=gen,
                         device=device)
    return eligible[pick]


def generate(cfg: dict, seed: int, device) -> Dict[str, dict]:
    """The configuration's raw chain tables for the run's ``seed``, made on
    ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["data_seed"]))
    order = torch.Generator(device=device)
    order.manual_seed(int(seed))
    rows, planted = cfg["rows"], cfg["planted"]
    kws = planted["keywords"]
    pj = cfg["prejoin"]

    def base_text(name: str) -> torch.Tensor:
        text = text_draws(rows[name], cfg, gen, device)
        plant(text, [kws[i] for i in planted["relations"].get(name, [])],
              planted["frac"], gen)
        return text

    def to_host(t: torch.Tensor) -> np.ndarray:
        return t.to(torch.int32).cpu().numpy()

    tables: Dict[str, dict] = {}
    n_cust = rows[pj["customer"]]
    tables[pj["customer"]] = {
        "keys": {pj["key"]: np.arange(n_cust, dtype=np.int32)},
        "domains": {pj["key"]: n_cust}, "text": to_host(base_text(
            pj["customer"]))}
    dims = [(pj["orders"] if d == pj["name"] else d, k)
            for d, k in cfg["star"]["dims"]]
    for dim, key in dims:
        n = rows[dim]
        text = base_text(dim)
        entry = {"keys": {key: np.arange(n, dtype=np.int32)},
                 "domains": {key: n}}
        perm = torch.randperm(n, generator=order, device=device)
        if dim == pj["orders"]:
            cust = custkeys(n, n_cust, cfg["custkey"], gen, device)
            entry["keys"][pj["key"]] = to_host(cust[perm])
            entry["domains"][pj["key"]] = n_cust
        entry["text"] = to_host(text[perm])
        tables[dim] = entry
    fact = cfg["star"]["fact"]
    n = rows[fact]
    keys = {key: foreign_keys(rows[dim], n, cfg["foreign_keys"], gen, device)
            for dim, key in dims}
    text = base_text(fact)
    perm = torch.randperm(n, generator=order, device=device)
    tables[fact] = {"keys": {k: to_host(v[perm]) for k, v in keys.items()},
                    "domains": {key: rows[dim] for dim, key in dims},
                    "text": to_host(text[perm])}
    return tables
