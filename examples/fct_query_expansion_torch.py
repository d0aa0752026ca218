"""The paper's motivating application on the PyTorch port: FCT-driven
keyword-query expansion.  The port's counterpart of
``examples/fct_query_expansion.py``; it imports only ``repro_torch``.

1. run the FCT query for the user's keywords,
2. take the top co-occurring terms as expansion candidates,
3. re-run keyword search with each expanded query and show how the result
   set narrows (the paper's "constrain users to a specific set of results").

Run:  PYTHONPATH=src python examples/fct_query_expansion_torch.py  # the card
      PYTHONPATH=src python examples/fct_query_expansion_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.api import FCTRequest, FCTSession
from repro_torch.core.candidate_network import (TupleSets, enumerate_star_cns,
                                                prune_empty_cns)
from repro_torch.data.demo import TOK, build_db

QUERY = ["alps", "bordeaux"]
TOP_K, R_MAX = 5, 4


def result_count(schema, kws, r_max=R_MAX):
    """Number of MTJNTs (via star-method volumes: count, not materialize)."""
    ts = TupleSets.build(schema, kws)
    cns = prune_empty_cns(enumerate_star_cns(len(kws), schema.m, r_max), ts)
    total = 0
    for cn in cns:
        fact_idx, dim_idx = ts.cn_rows(cn)
        if fact_idx is None:
            (i, rows), = dim_idx.items()
            total += len(rows)
            continue
        if not dim_idx:
            total += len(fact_idx)
            continue
        inc = sorted(dim_idx)
        nums = []
        for i in inc:
            dom = schema.key_domain(i)
            nums.append(np.bincount(schema.dim_keys(i)[dim_idx[i]],
                                    minlength=dom))
        vol = np.ones(len(fact_idx), np.int64)
        for p, i in enumerate(inc):
            vol *= nums[p][schema.fact_keys(i)[fact_idx]]
        total += int(vol.sum())
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; no fallback)")
    args = ap.parse_args(argv)
    schema = build_db()
    session = FCTSession(schema, tokenizer=TOK, device=args.device)
    kws = list(session.resolve_keywords(QUERY))
    n0 = result_count(schema, kws)
    res = session.query(FCTRequest(keywords=tuple(QUERY), top_k=TOP_K,
                                   r_max=R_MAX))
    terms = res.topk()
    print(f"query {QUERY}: {n0} results; top co-occurring terms: {terms}")
    expanded = []
    for word, _ in terms[:3]:
        n1 = result_count(schema, kws + list(session.resolve_keywords([word])))
        expanded.append((word, n1))
        print(f"  + '{word}': {n1} results "
              f"({100 * (1 - n1 / max(n0, 1)):.1f}% narrower)")
    print(f"term ids {[int(t) for t in res.term_ids]} "
          f"freqs {[int(f) for f in res.freqs]} on {session.device}")
    return {"results": n0, "response": res, "expanded": expanded}


if __name__ == "__main__":
    main()
