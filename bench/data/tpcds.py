"""The benchmark's TPC-DS star generator: the ``store_sales`` star, a fact
with no text among dimensions of their own text widths.

Drawn as ``bench/data/tpch.py`` draws the TPC-H star (its Zipf text,
planting and foreign-key draws, on ``device`` from ``torch.Generator``s),
with:

* one text width per relation (``text_len[name]``); a relation of width 0
  (the fact, STORE_SALES, which has no character column) gets no text and
  no planting, and its rows hold no keyword;
* every dimension with dense primary keys ``0..n-1``; the fact with one
  foreign key into each, uniform over the dimension, or over the rows
  ``[first, last]`` where ``foreign_keys["windows"]`` names a window for the
  column (``ss_sold_date_sk``: the five sales years of DATE_DIM).  A window
  is given in the rows of the published relation (``of`` rows); a cut-down
  relation takes the same share of its rows.

What the seed changes.  The rows are drawn from the configuration's fixed
``data_seed``; the run's seed then permutes the fact's rows with their
foreign keys, and each dimension's texts against its primary keys.  Every
seed so holds the same rows, the same tuple-set sizes and the same
candidate networks, joined differently.

Tables come back as numpy int32 arrays: ``{name: {"keys": {col: [rows]},
"domains": {col: n}, "text": [rows, text_len[name]]}}``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bench.data.tpch import foreign_keys, plant, text_draws


def window_rows(spec: dict, n: int):
    """``(first, last)`` rows of a key window over a relation of ``n``
    rows: the published window's share of the published ``of`` rows."""
    of = int(spec["of"])
    if n == of:
        return int(spec["first"]), int(spec["last"])
    return int(spec["first"]) * n // of, int(spec["last"]) * n // of


def fact_key(domain: int, n: int, col: str, cfg: dict,
             gen: torch.Generator, device) -> torch.Tensor:
    """``n`` foreign keys of column ``col`` into a dimension of ``domain``
    rows: uniform over its window where the configuration names one, else
    as ``foreign_keys`` states."""
    spec = cfg["foreign_keys"].get("windows", {}).get(col)
    if spec is None:
        return foreign_keys(domain, n, cfg["foreign_keys"], gen, device)
    first, last = window_rows(spec, domain)
    return torch.randint(first, last + 1, (n,), generator=gen, device=device)


def generate(cfg: dict, seed: int, device) -> Dict[str, dict]:
    """The configuration's star tables for the run's ``seed``, made on
    ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["data_seed"]))
    order = torch.Generator(device=device)
    order.manual_seed(int(seed))
    star, rows, widths = cfg["star"], cfg["rows"], cfg["text_len"]
    planted = cfg["planted"]
    kws = planted["keywords"]

    def text(name: str, n: int) -> torch.Tensor:
        if not widths[name]:
            return torch.zeros((n, 0), dtype=torch.int32, device=device)
        t = text_draws(n, {**cfg, "text_len": widths[name]}, gen, device)
        plant(t, [kws[i] for i in planted["relations"].get(name, [])],
              planted["frac"], gen)
        return t

    tables: Dict[str, dict] = {}
    for dim, key in star["dims"]:
        n = rows[dim]
        t = text(dim, n)[torch.randperm(n, generator=order, device=device)]
        tables[dim] = {"keys": {key: np.arange(n, dtype=np.int32)},
                       "domains": {key: n}, "text": t.cpu().numpy()}
    fact = star["fact"]
    n = rows[fact]
    keys = {key: fact_key(rows[dim], n, key, cfg, gen, device)
            for dim, key in star["dims"]}
    t = text(fact, n)
    perm = torch.randperm(n, generator=order, device=device)
    tables[fact] = {
        "keys": {k: v[perm].to(torch.int32).cpu().numpy()
                 for k, v in keys.items()},
        "domains": {key: rows[dim] for dim, key in star["dims"]},
        "text": t[perm].cpu().numpy()}
    return tables
