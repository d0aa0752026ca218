"""The plain reference: FCT (the paper's Def. 6) by the star method.

A frozen copy of the semantics of ``src/repro_torch/core/star.py::fct_star``
and ``topk_terms`` and of ``core/candidate_network.py`` (commit b56447e),
written in plain PyTorch so that it runs on the card at SF1 in about a
second.  It imports nothing of the program and takes nothing the program
built: it works out the tuple sets, the candidate networks (CNs) and the
volumes again from the benchmark's own tables.

* Tuple sets: a row's keyword mask is the set of query keywords its text
  contains; ``R^K`` holds the rows whose mask is exactly ``K``.
* CNs of a star with at most ``r_max`` relations: the fact alone with the
  full mask; each dimension alone with the full mask; and the fact joined
  with a non-empty set of dimensions, each leaf with a non-empty mask, the
  masks' union full and every node needed (dropping any leaf loses a
  keyword; one leaf with the full mask makes the fact removable).  A CN with
  an empty tuple set is dropped.
* Frequencies: for a joined CN, ``num_i[a]`` counts dimension ``i``'s tuple
  set rows with key ``a``; a fact row weighs ``prod_i num_i[key_i]``, a
  dimension row the sum over the fact rows that join it of the other
  dimensions' ``num``.  ``freq[w] = sum`` over CNs and rows of weight times
  the row's count of ``w``; PAD never counts.
* Top-k: the ``k`` largest frequencies with PAD and the query keywords
  excluded, ties by ascending id.

``acc`` is the accumulation dtype of the weights and the histogram:
``torch.int64`` is exact at every size the benchmark runs; a narrower dtype
is the control that the correctness check has to catch.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

PAD_ID = 0


def enumerate_cns(n_keywords: int, m_dims: int, r_max: int
                  ) -> List[Tuple[int, Tuple[Optional[int], ...], int]]:
    """``(fact_mask, dim_masks, single_dim)`` of every valid star CN with at
    most ``r_max`` relations; ``dim_masks[i]`` is None where dimension ``i``
    is not in the CN, ``single_dim`` names the dimension of a CN that is one
    dimension alone (else -1)."""
    full = (1 << n_keywords) - 1
    out = []
    if r_max >= 1:
        out.append((full, (None,) * m_dims, -1))
        out.extend((-1, (None,) * m_dims, i) for i in range(m_dims))
    for r in range(1, m_dims + 1):
        if 1 + r > r_max:
            break
        for leaves in itertools.combinations(range(m_dims), r):
            for fact_mask in range(full + 1):
                for leaf_masks in itertools.product(range(1, full + 1),
                                                    repeat=r):
                    union = fact_mask
                    for lm in leaf_masks:
                        union |= lm
                    if union != full or not _needed(fact_mask, leaf_masks,
                                                    full):
                        continue
                    masks: List[Optional[int]] = [None] * m_dims
                    for leaf, lm in zip(leaves, leaf_masks):
                        masks[leaf] = lm
                    out.append((fact_mask, tuple(masks), -1))
    return out


def _needed(fact_mask: int, leaf_masks: Sequence[int], full: int) -> bool:
    for i in range(len(leaf_masks)):
        union = fact_mask
        for j, lm in enumerate(leaf_masks):
            if j != i:
                union |= lm
        if union == full:
            return False
    return not (len(leaf_masks) == 1 and leaf_masks[0] == full)


def keyword_masks(text: torch.Tensor, keywords: Sequence[int]) -> torch.Tensor:
    """int64 ``[rows]``: bit ``b`` set where the row holds ``keywords[b]``."""
    mask = torch.zeros(text.shape[0], dtype=torch.int64, device=text.device)
    for bit, kw in enumerate(keywords):
        mask |= (text == int(kw)).any(dim=1).to(torch.int64) << bit
    return mask


class StarTables:
    """The tables on ``device``: fact text and foreign keys, and per
    dimension its text, primary keys and key domain."""

    def __init__(self, tables: Dict[str, dict], star: dict, device) -> None:
        dev = torch.device(device)
        fact = tables[star["fact"]]
        self.fact_text = torch.as_tensor(fact["text"], device=dev)
        self.fact_keys, self.dim_text, self.dim_keys, self.domains = \
            [], [], [], []
        for dim, key in star["dims"]:
            d = tables[dim]
            self.fact_keys.append(
                torch.as_tensor(fact["keys"][key], device=dev).long())
            self.dim_text.append(torch.as_tensor(d["text"], device=dev))
            self.dim_keys.append(
                torch.as_tensor(d["keys"][key], device=dev).long())
            self.domains.append(int(d["domains"][key]))

    def prefix(self, fact_rows: int, dim_rows) -> "StarTables":
        """The tables cut to their first rows (views): the data as it stood
        before later appends.  Key domains stay, being upper bounds."""
        t = object.__new__(StarTables)
        t.fact_text = self.fact_text[:fact_rows]
        t.fact_keys = [k[:fact_rows] for k in self.fact_keys]
        t.dim_text = [x[:n] for x, n in zip(self.dim_text, dim_rows)]
        t.dim_keys = [k[:n] for k, n in zip(self.dim_keys, dim_rows)]
        t.domains = list(self.domains)
        return t


def _histogram(freq: torch.Tensor, text: torch.Tensor,
               weights: torch.Tensor) -> None:
    """``freq[w] += sum over rows of weight * count(row, w)``, in
    ``freq``'s dtype."""
    flat = text.reshape(-1).long()
    w = weights.to(freq.dtype).repeat_interleave(text.shape[1])
    freq.index_add_(0, flat, w)


def fct(t: StarTables, keywords: Sequence[int], r_max: int, vocab: int,
        acc: torch.dtype = torch.int64) -> Tuple[np.ndarray, dict]:
    """``(freq, stats)``: the int64 frequency vector over the vocabulary
    (PAD 0) and, over the CNs that join the fact with a dimension, the rows
    of their tuple sets (``joined_rows``) and those whose weight is not 0
    (``weighted_rows``)."""
    dev = t.fact_text.device
    fact_kw = keyword_masks(t.fact_text, keywords)
    dim_kw = [keyword_masks(d, keywords) for d in t.dim_text]
    full = (1 << len(keywords)) - 1
    freq = torch.zeros(vocab, dtype=acc, device=dev)
    stats = {"cns": 0, "joined_cns": 0, "joined_rows": 0, "weighted_rows": 0}

    def one(n: int) -> torch.Tensor:
        return torch.ones(n, dtype=acc, device=dev)

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
        stats["weighted_rows"] += int((vol != 0).sum())
        for p, (i, rows) in enumerate(zip(inc, drows)):
            others = one(len(frows))
            for q in range(len(inc)):
                if q != p:
                    others = others * per[q]
            by_key = torch.zeros(t.domains[i], dtype=acc, device=dev)
            by_key.index_add_(0, t.fact_keys[i][frows], others)
            w = by_key[t.dim_keys[i][rows]]
            _histogram(freq, t.dim_text[i][rows], w)
            stats["weighted_rows"] += int((w != 0).sum())
    freq[PAD_ID] = 0
    out = freq.cpu().numpy()
    if out.dtype.kind == "f":
        out = np.rint(out)
    return out.astype(np.int64), stats


def topk(freq: np.ndarray, keywords: Sequence[int], k: int
         ) -> Tuple[np.ndarray, np.ndarray]:
    """Def. 6's top-k: ids and counts, PAD and the keywords excluded, ties
    by ascending id."""
    f = freq.copy()
    f[PAD_ID] = 0
    f[list(keywords)] = 0
    order = np.argsort(-f, kind="stable")[:k]
    return order, f[order]
