"""The benchmark's own TPC-H star generator.

Copied in its semantics from ``src/repro_torch/data/tpch.py`` (commit
b56447e; ``generate`` and ``plant_keywords``) and the SF1 recipe of
``chip_smoke.py::build_schema``, so that a later change to the program cannot
move the data the benchmark measures on:

* dimensions PART, SUPPLIER and ORDERS carry dense primary keys ``0..n-1``;
  LINEITEM, the fact, carries one foreign key into each, drawn uniformly
  (TPC-H's ``dbgen``) or Zipf with exponent ``z`` over the key domain
  (key ``k`` with probability proportional to ``(k + 1) ** -z``);
* every row has ``text_len`` token ids drawn Zipf(``token_zipf``) over the
  ids ``1..vocab-1`` (id 1 the most frequent), each slot PAD (id 0) with
  probability ``pad_frac``;
* planting: for each relation and each of its planted keywords, a row is
  chosen with probability ``frac`` and one of its slots, drawn uniformly,
  is set to the keyword.

What the seed changes.  The rows themselves are drawn from the
configuration's fixed ``data_seed``; the run's seed then permutes each
relation's rows: the fact's rows with their foreign keys, and each
dimension's texts against its primary keys.  Every seed so holds the same
rows, the same tuple-set sizes and the same candidate networks, in another
order and joined differently: the answers differ from seed to seed, the
work does not.  (Drawn from the run's seed, the few natural occurrences of
the rare keyword ids would make or drop whole candidate networks, and with
them the host work of a query.)

The draws run on ``device`` from ``torch.Generator``s, as a few large calls:
inverse-CDF sampling (``searchsorted`` over the float64 CDF) in place of
``rng.choice(p=...)``.  The same seed on the same kind of device gives the
same tables.  Tables come back as numpy int32 arrays: ``{name: {"keys":
{col: [rows]}, "domains": {col: n}, "text": [rows, text_len]}}``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

PAD_ID = 0


def _inverse_cdf(weights: torch.Tensor, n: int, gen: torch.Generator
                 ) -> torch.Tensor:
    """``n`` draws of indices ``0..len(weights)-1`` with probability
    proportional to ``weights`` (float64)."""
    cdf = torch.cumsum(weights, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, dtype=torch.float64, generator=gen,
                   device=weights.device)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=len(weights) - 1)


def zipf_draws(domain: int, n: int, z: float, gen: torch.Generator,
               device) -> torch.Tensor:
    """``n`` keys in ``[0, domain)``, key ``k`` with probability
    proportional to ``(k + 1) ** -z``."""
    ranks = torch.arange(1, domain + 1, dtype=torch.float64, device=device)
    return _inverse_cdf(ranks ** -z, n, gen)


def text_draws(rows: int, cfg: dict, gen: torch.Generator,
               device) -> torch.Tensor:
    """``[rows, text_len]`` int32 token ids: Zipf over ``1..vocab-1`` and
    PAD with probability ``pad_frac``."""
    vocab, length = cfg["vocab"], cfg["text_len"]
    t = zipf_draws(vocab - 1, rows * length, cfg["token_zipf"], gen,
                   device) + 1
    t = t.to(torch.int32).view(rows, length)
    pad = torch.rand((rows, length), generator=gen, device=device)
    t[pad < cfg["pad_frac"]] = PAD_ID
    return t


def plant(text: torch.Tensor, keywords, frac: float,
          gen: torch.Generator) -> None:
    """Set one uniformly drawn slot of a ``frac`` share of the rows to each
    keyword in turn, in place."""
    rows, length = text.shape
    for kw in keywords:
        chosen = torch.rand(rows, generator=gen, device=text.device) < frac
        col = torch.randint(0, length, (rows,), generator=gen,
                            device=text.device)
        idx = chosen.nonzero().squeeze(1)
        text[idx, col[idx]] = int(kw)


def foreign_keys(domain: int, n: int, dist: dict, gen: torch.Generator,
                 device) -> torch.Tensor:
    if dist["dist"] == "uniform":
        return torch.randint(0, domain, (n,), generator=gen, device=device)
    if dist["dist"] == "zipf":
        return zipf_draws(domain, n, float(dist["z"]), gen, device)
    raise ValueError(f"unknown foreign-key distribution {dist['dist']!r}")


def generate(cfg: dict, seed: int, device) -> Dict[str, dict]:
    """The configuration's star tables for the run's ``seed``, made on
    ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["data_seed"]))
    order = torch.Generator(device=device)
    order.manual_seed(int(seed))
    star, rows = cfg["star"], cfg["rows"]
    planted = cfg["planted"]
    kws = planted["keywords"]
    tables: Dict[str, dict] = {}
    for dim, key in star["dims"]:
        n = rows[dim]
        text = text_draws(n, cfg, gen, device)
        plant(text, [kws[i] for i in planted["relations"].get(dim, [])],
              planted["frac"], gen)
        text = text[torch.randperm(n, generator=order, device=device)]
        tables[dim] = {"keys": {key: np.arange(n, dtype=np.int32)},
                       "domains": {key: n}, "text": text.cpu().numpy()}
    fact = star["fact"]
    n = rows[fact]
    keys = {key: foreign_keys(rows[dim], n, cfg["foreign_keys"], gen, device)
            for dim, key in star["dims"]}
    text = text_draws(n, cfg, gen, device)
    plant(text, [kws[i] for i in planted["relations"].get(fact, [])],
          planted["frac"], gen)
    perm = torch.randperm(n, generator=order, device=device)
    tables[fact] = {
        "keys": {k: v[perm].to(torch.int32).cpu().numpy()
                 for k, v in keys.items()},
        "domains": {key: rows[dim] for dim, key in star["dims"]},
        "text": text[perm].cpu().numpy()}
    return tables
