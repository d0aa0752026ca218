"""Single-machine FCT baselines.

``fct_bruteforce``  — materializes every MTJNT and counts terms (Def. 6 /
                      Eq. 1–3 taken literally).  Exponential; tests only.
``fct_star``        — the star method of Tao & Yu [12] (the paper's §3
                      starting point): join-free frequency computation via
                      num-arrays and volumes.  This is the correctness oracle
                      for the distributed engine and the "single machine"
                      baseline of the paper's §6.1 comparison.
Both return an int64 frequency vector over the vocabulary (query keywords and
PAD included — callers mask before top-k, matching Def. 6's "not in q").
"""
from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np

from repro_torch.core.candidate_network import StarCN, TupleSets, enumerate_star_cns, prune_empty_cns
from repro_torch.data.schema import PAD_ID, StarSchema, tokens_histogram


def _row_histogram(text_rows: np.ndarray, vocab: int) -> np.ndarray:
    return tokens_histogram(text_rows, np.ones(text_rows.shape[0], np.int64), vocab)


def fct_bruteforce(schema: StarSchema, keywords: Sequence[int],
                   r_max: int) -> np.ndarray:
    """Materialize all MTJNTs of all CNs; count term occurrences."""
    ts = TupleSets.build(schema, keywords)
    cns = prune_empty_cns(
        enumerate_star_cns(len(keywords), schema.m, r_max), ts)
    freq = np.zeros((schema.vocab_size,), np.int64)
    for cn in cns:
        freq += _bruteforce_cn(schema, ts, cn)
    freq[PAD_ID] = 0
    return freq


def _bruteforce_cn(schema: StarSchema, ts: TupleSets, cn: StarCN) -> np.ndarray:
    vocab = schema.vocab_size
    freq = np.zeros((vocab,), np.int64)
    fact_idx, dim_idx = ts.cn_rows(cn)
    if fact_idx is None:  # single-dimension CN: each qualifying row is a MTJNT
        (i, rows), = dim_idx.items()
        return _row_histogram(schema.dims[i].text[rows], vocab)
    if len(dim_idx) == 0:  # fact-alone CN
        return _row_histogram(schema.fact.text[fact_idx], vocab)
    inc = sorted(dim_idx)
    # group dim rows by join key
    by_key = []
    for i in inc:
        rows = dim_idx[i]
        keys = schema.dim_keys(i)[rows]
        groups: dict = {}
        for r, a in zip(rows, keys):
            groups.setdefault(int(a), []).append(int(r))
        by_key.append(groups)
    for t in fact_idx:
        choices = []
        ok = True
        for pos, i in enumerate(inc):
            a = int(schema.fact_keys(i)[t])
            rows = by_key[pos].get(a)
            if not rows:
                ok = False
                break
            choices.append(rows)
        if not ok:
            continue
        fact_hist = _row_histogram(schema.fact.text[t:t + 1], vocab)
        for combo in itertools.product(*choices):
            freq += fact_hist
            for pos, i in enumerate(inc):
                freq += _row_histogram(schema.dims[i].text[combo[pos]:combo[pos] + 1], vocab)
    return freq


def fct_star(schema: StarSchema, keywords: Sequence[int],
             r_max: int) -> np.ndarray:
    """Star method: freq(w) = Σ_CN Σ_tuples count(text, w) · vol(tuple)."""
    ts = TupleSets.build(schema, keywords)
    cns = prune_empty_cns(
        enumerate_star_cns(len(keywords), schema.m, r_max), ts)
    freq = np.zeros((schema.vocab_size,), np.int64)
    for cn in cns:
        freq += star_cn_frequencies(schema, ts, cn)
    freq[PAD_ID] = 0
    return freq


def star_cn_frequencies(schema: StarSchema, ts: TupleSets,
                        cn: StarCN) -> np.ndarray:
    """Join-free per-CN frequencies (Eq. 2 via num-arrays and volumes)."""
    vocab = schema.vocab_size
    fact_idx, dim_idx = ts.cn_rows(cn)
    if fact_idx is None:
        (i, rows), = dim_idx.items()
        return _row_histogram(schema.dims[i].text[rows], vocab)
    if len(dim_idx) == 0:
        return _row_histogram(schema.fact.text[fact_idx], vocab)
    inc = sorted(dim_idx)
    # num-arrays: per included dim, matches per join-key over its tuple set
    nums = []
    for i in inc:
        dom = schema.key_domain(i)
        keys = schema.dim_keys(i)[dim_idx[i]]
        nums.append(np.bincount(keys, minlength=dom).astype(np.int64))
    # fact volumes: vol(t) = Π_i num_i(key_i(t))
    fkeys = [schema.fact_keys(i)[fact_idx] for i in inc]
    per_dim_num = [nums[p][fkeys[p]] for p in range(len(inc))]
    vol_fact = np.ones(len(fact_idx), np.int64)
    for v in per_dim_num:
        vol_fact *= v
    freq = tokens_histogram(schema.fact.text[fact_idx], vol_fact, vocab)
    # dim-row volumes: vol_i(a) = Σ_{t: key_i(t)=a} Π_{j≠i} num_j(key_j(t))
    for p, i in enumerate(inc):
        others = np.ones(len(fact_idx), np.int64)
        for q in range(len(inc)):
            if q != p:
                others *= per_dim_num[q]
        dom = schema.key_domain(i)
        vol_by_key = np.zeros((dom,), np.int64)
        np.add.at(vol_by_key, fkeys[p], others)
        rows = dim_idx[i]
        w = vol_by_key[schema.dim_keys(i)[rows]]
        freq += tokens_histogram(schema.dims[i].text[rows], w, vocab)
    return freq


def cn_volume_mass(schema: StarSchema, ts: TupleSets, cn: StarCN) -> float:
    """Total volume-weighted token mass of a CN: Σ_{w != PAD} freq_CN(w).

    The same num-array/volume pass as :func:`star_cn_frequencies`, collapsed
    over the vocab axis — O(rows·(m+L)) with no histogram.  Every per-term
    frequency is nonnegative, so the mass upper-bounds ``max_w freq_CN(w)``
    and is zero iff the CN contributes nothing to any (non-PAD) term; the
    runtime uses it as the cross-CN-group threshold-pruning bound (the
    bounding trick of "Computing n-Gram Statistics in MapReduce").  float64
    on purpose: a bound needs monotonicity, not bit-exactness — except at
    zero, where products of nonnegative integers are exactly 0.0 iff a
    factor is zero.
    """
    fact_idx, dim_idx = ts.cn_rows(cn)
    if fact_idx is None:
        (i, rows), = dim_idx.items()
        return float(np.count_nonzero(schema.dims[i].text[rows] != PAD_ID))
    if len(dim_idx) == 0:
        return float(np.count_nonzero(schema.fact.text[fact_idx] != PAD_ID))
    inc = sorted(dim_idx)
    nums = []
    for i in inc:
        dom = schema.key_domain(i)
        keys = schema.dim_keys(i)[dim_idx[i]]
        nums.append(np.bincount(keys, minlength=dom).astype(np.float64))
    fkeys = [schema.fact_keys(i)[fact_idx] for i in inc]
    per_dim_num = [nums[p][fkeys[p]] for p in range(len(inc))]
    vol_fact = np.ones(len(fact_idx), np.float64)
    for v in per_dim_num:
        vol_fact *= v
    fact_tokens = (schema.fact.text[fact_idx] != PAD_ID).sum(axis=1)
    mass = float(vol_fact @ fact_tokens.astype(np.float64))
    for p, i in enumerate(inc):
        others = np.ones(len(fact_idx), np.float64)
        for q in range(len(inc)):
            if q != p:
                others *= per_dim_num[q]
        dom = schema.key_domain(i)
        vol_by_key = np.zeros((dom,), np.float64)
        np.add.at(vol_by_key, fkeys[p], others)
        rows = dim_idx[i]
        w = vol_by_key[schema.dim_keys(i)[rows]]
        dim_tokens = (schema.dims[i].text[rows] != PAD_ID).sum(axis=1)
        mass += float(w @ dim_tokens.astype(np.float64))
    return mass


def topk_terms(freq: np.ndarray, keywords: Sequence[int], k: int,
               stop_mask: np.ndarray | None = None):
    """Def. 6: top-k terms by frequency, excluding q (and stopwords/PAD)."""
    f = freq.copy()
    f[PAD_ID] = 0
    for kw in keywords:
        f[kw] = 0
    if stop_mask is not None:
        f[stop_mask] = 0
    order = np.argsort(-f, kind="stable")[:k]
    return order, f[order]
