"""The plain reference of a star of any number of dimensions whose
relations differ in text width: FCT (the paper's Def. 6) by the star
method, for the TPC-DS ``store_sales`` star.

Imports nothing of the program and takes nothing the program built.  The
tuple sets, candidate networks (CNs), num-arrays and volumes are those of
``bench/reference/star.py::fct``, built from that module's pieces
(``StarTables``, ``enumerate_cns``, ``keyword_masks``, ``_histogram``),
with what a wide star and a fact without text ask for:

* a relation of width 0 (STORE_SALES) holds no keyword, so its rows all
  fall in the tuple set of mask 0; it adds weight to the other relations
  and no terms;
* tuple sets and num-arrays are made once per (relation, mask) and reused
  by every CN that names them, and a CN whose tuple sets are empty is
  dropped before any fact-sized work: nine dimensions give 1 918 CN
  templates at ``r_max`` 4 over three keywords;
* ``stats`` adds, over the CNs that join the fact with a dimension,
  ``weighted_tokens`` (the rows whose weight is not 0, each at its own
  relation's width, so the fact's count 0) and ``text_rows`` (the tuple-set
  rows of the relations that carry text: the weights MR² has to read).

``acc`` is the accumulation dtype of the weights and the histogram:
``torch.int64`` is exact at every size the benchmark runs; ``torch.int16``
is the control that the correctness check has to catch.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from bench.reference.star import (PAD_ID, StarTables, _histogram,
                                  enumerate_cns, keyword_masks)


def fct(t: StarTables, keywords: Sequence[int], r_max: int, vocab: int,
        acc: torch.dtype = torch.int64) -> Tuple[np.ndarray, dict]:
    """``(freq, stats)``: the int64 frequency vector over the vocabulary
    (PAD 0) and the statistics above, with ``star.fct``'s ``cns``,
    ``joined_cns``, ``joined_rows`` and ``weighted_rows``."""
    dev = t.fact_text.device
    full = (1 << len(keywords)) - 1
    fact_kw = keyword_masks(t.fact_text, keywords)
    dim_kw = [keyword_masks(d, keywords) for d in t.dim_text]
    freq = torch.zeros(vocab, dtype=acc, device=dev)
    stats = {"cns": 0, "joined_cns": 0, "joined_rows": 0, "weighted_rows": 0,
             "weighted_tokens": 0, "text_rows": 0}
    fact_sets: Dict[int, torch.Tensor] = {}
    dim_sets: Dict[Tuple[int, int], torch.Tensor] = {}
    nums: Dict[Tuple[int, int, int], torch.Tensor] = {}

    def fact_rows(mask: int) -> torch.Tensor:
        if mask not in fact_sets:
            fact_sets[mask] = (fact_kw == mask).nonzero().squeeze(1)
        return fact_sets[mask]

    def dim_rows(i: int, mask: int) -> torch.Tensor:
        if (i, mask) not in dim_sets:
            dim_sets[i, mask] = (dim_kw[i] == mask).nonzero().squeeze(1)
        return dim_sets[i, mask]

    def num_at_fact(i: int, mask: int, fmask: int) -> torch.Tensor:
        """``num_i[key_i]`` of every row of the fact's tuple set ``fmask``:
        how many of dimension ``i``'s rows of mask ``mask`` each joins."""
        if (i, mask, fmask) not in nums:
            num = torch.bincount(t.dim_keys[i][dim_rows(i, mask)],
                                 minlength=t.domains[i]).to(acc)
            nums[i, mask, fmask] = num[t.fact_keys[i][fact_rows(fmask)]]
        return nums[i, mask, fmask]

    def one(n: int) -> torch.Tensor:
        return torch.ones(n, dtype=acc, device=dev)

    def count(text: torch.Tensor, w: torch.Tensor) -> None:
        """One relation's weighted rows: their terms, and the statistics
        of what MR² reads of them."""
        n = int((w != 0).sum())
        stats["weighted_rows"] += n
        stats["weighted_tokens"] += n * text.shape[1]
        if text.shape[1]:
            stats["text_rows"] += len(w)
            _histogram(freq, text, w)

    for fact_mask, dim_masks, single in enumerate_cns(
            len(keywords), len(t.dim_text), r_max):
        if single >= 0:
            rows = dim_rows(single, full)
            if len(rows):
                stats["cns"] += 1
                _histogram(freq, t.dim_text[single][rows], one(len(rows)))
            continue
        inc = [i for i, m in enumerate(dim_masks) if m is not None]
        if any(len(dim_rows(i, dim_masks[i])) == 0 for i in inc):
            continue
        frows = fact_rows(fact_mask)
        if len(frows) == 0:
            continue
        stats["cns"] += 1
        if not inc:
            _histogram(freq, t.fact_text[frows], one(len(frows)))
            continue
        drows = [dim_rows(i, dim_masks[i]) for i in inc]
        per = [num_at_fact(i, dim_masks[i], fact_mask) for i in inc]
        vol = one(len(frows))
        for p in per:
            vol = vol * p
        stats["joined_cns"] += 1
        stats["joined_rows"] += len(frows) + sum(len(r) for r in drows)
        count(t.fact_text[frows], vol)
        for p, (i, rows) in enumerate(zip(inc, drows)):
            others = one(len(frows))
            for q in range(len(inc)):
                if q != p:
                    others = others * per[q]
            by_key = torch.zeros(t.domains[i], dtype=acc, device=dev)
            by_key.index_add_(0, t.fact_keys[i][frows], others)
            count(t.dim_text[i][rows], by_key[t.dim_keys[i][rows]])
    freq[PAD_ID] = 0
    out = freq.cpu().numpy()
    if out.dtype.kind == "f":
        out = np.rint(out)
    return out.astype(np.int64), stats
