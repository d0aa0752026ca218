"""The plain reference of the chain query: CUSTOMER pre-joined into ORDERS,
then FCT (the paper's Def. 6) over the resulting star.

Imports nothing of the program and takes nothing the program built.
:func:`prejoin` gathers each order's customer row by its ``custkey`` from
the raw tables (``bench/data/chain.py``) and appends the customer's text
to the order's: the paper's chain recipe, done again here.  :func:`fct` is
``bench/reference/star.py::fct`` (same tuple sets, CNs, volumes and
histogram, from that module's pieces) with one more statistic,
``weighted_tokens``: over the CNs that join the fact with a dimension, the
rows whose weight is not 0, each counted at its own relation's text width
(24 for the pre-joined ORDERS, 12 elsewhere), which is what MR² has to
read when the relations differ in width.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from bench.reference.star import (PAD_ID, StarTables, _histogram,
                                  enumerate_cns, keyword_masks)


def prejoin(tables: Dict[str, dict], cfg: dict, device) -> Dict[str, dict]:
    """``tables`` with the pre-joined relation in place of ORDERS and
    CUSTOMER: ORDERS' keys, its text followed by its customer's, on
    ``device``."""
    pj = cfg["prejoin"]
    dev = torch.device(device)
    orders, customer = tables[pj["orders"]], tables[pj["customer"]]
    cust = torch.as_tensor(orders["keys"][pj["key"]], device=dev).long()
    text = torch.cat([torch.as_tensor(orders["text"], device=dev),
                      torch.as_tensor(customer["text"], device=dev)[cust]],
                     dim=1)
    out = {k: v for k, v in tables.items()
           if k not in (pj["orders"], pj["customer"])}
    out[pj["name"]] = {"keys": orders["keys"], "domains": orders["domains"],
                       "text": text}
    return out


def fct(t: StarTables, keywords: Sequence[int], r_max: int, vocab: int,
        acc: torch.dtype = torch.int64) -> Tuple[np.ndarray, dict]:
    """``(freq, stats)`` as ``star.fct`` gives them, ``stats`` with
    ``weighted_tokens`` besides."""
    dev = t.fact_text.device
    fact_kw = keyword_masks(t.fact_text, keywords)
    dim_kw = [keyword_masks(d, keywords) for d in t.dim_text]
    full = (1 << len(keywords)) - 1
    freq = torch.zeros(vocab, dtype=acc, device=dev)
    stats = {"cns": 0, "joined_cns": 0, "joined_rows": 0, "weighted_rows": 0,
             "weighted_tokens": 0}

    def one(n: int) -> torch.Tensor:
        return torch.ones(n, dtype=acc, device=dev)

    def weighted(text: torch.Tensor, w: torch.Tensor) -> None:
        n = int((w != 0).sum())
        stats["weighted_rows"] += n
        stats["weighted_tokens"] += n * text.shape[1]

    for fact_mask, dim_masks, single in enumerate_cns(
            len(keywords), len(t.dim_text), r_max):
        if single >= 0:
            rows = (dim_kw[single] == full).nonzero().squeeze(1)
            if len(rows):
                stats["cns"] += 1
                _histogram(freq, t.dim_text[single][rows], one(len(rows)))
            continue
        frows = (fact_kw == fact_mask).nonzero().squeeze(1)
        inc = [i for i, m in enumerate(dim_masks) if m is not None]
        drows = [(dim_kw[i] == dim_masks[i]).nonzero().squeeze(1)
                 for i in inc]
        if len(frows) == 0 or any(len(r) == 0 for r in drows):
            continue
        stats["cns"] += 1
        if not inc:
            _histogram(freq, t.fact_text[frows], one(len(frows)))
            continue
        per = []
        for i, rows in zip(inc, drows):
            num = torch.bincount(t.dim_keys[i][rows],
                                 minlength=t.domains[i]).to(acc)
            per.append(num[t.fact_keys[i][frows]])
        vol = one(len(frows))
        for p in per:
            vol = vol * p
        _histogram(freq, t.fact_text[frows], vol)
        stats["joined_cns"] += 1
        stats["joined_rows"] += len(frows) + sum(len(r) for r in drows)
        weighted(t.fact_text, vol)
        for p, (i, rows) in enumerate(zip(inc, drows)):
            others = one(len(frows))
            for q in range(len(inc)):
                if q != p:
                    others = others * per[q]
            by_key = torch.zeros(t.domains[i], dtype=acc, device=dev)
            by_key.index_add_(0, t.fact_keys[i][frows], others)
            w = by_key[t.dim_keys[i][rows]]
            _histogram(freq, t.dim_text[i][rows], w)
            weighted(t.dim_text[i], w)
    freq[PAD_ID] = 0
    out = freq.cpu().numpy()
    if out.dtype.kind == "f":
        out = np.rint(out)
    return out.astype(np.int64), stats
