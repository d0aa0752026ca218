"""Quickstart of the PyTorch port: an FCT query over a TPC-H-like database,
end to end.  The port's counterpart of ``examples/quickstart.py``; it
imports only ``repro_torch``.

Builds the synthetic PART/SUPPLIER/ORDERS ⋈ LINEITEM star database of
``repro_torch.data.demo`` (real string payloads), runs the keyword query
{"alps", "bordeaux"} through the MapReduce-style FCT engine
(shares-partitioned shuffle -> num/vol arrays -> weighted histogram on the
``fct_count`` kernel -> top-k) and prints the frequent co-occurring terms,
then their term ids and frequencies, and the device, on one line.

Run:  PYTHONPATH=src python examples/quickstart_torch.py           # the card
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch.api import FCTRequest, FCTSession
from repro_torch.data.demo import TOK, build_db

QUERY = ["alps", "bordeaux"]
TOP_K, R_MAX = 8, 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; no fallback)")
    args = ap.parse_args(argv)
    schema = build_db()
    # the session owns the tokenizer: requests carry raw keyword strings
    session = FCTSession(schema, tokenizer=TOK, device=args.device)
    res = session.query(FCTRequest(keywords=tuple(QUERY), top_k=TOP_K,
                                   r_max=R_MAX))
    print(f"keyword query: {QUERY}  "
          f"(term ids {list(session.resolve_keywords(QUERY))})")
    print(f"candidate networks: {res.n_cns} ({res.n_joined_cns} joined)")
    print(f"shuffle: {res.shuffle_rows} rows / {res.shuffle_bytes / 1e6:.2f} MB"
          f" | worker imbalance {res.imbalance:.2f}")
    print(f"latency: {res.timings['total_ms']:.1f}ms "
          f"(plan {res.timings['plan_ms']:.1f}ms, "
          f"exec {res.timings['execute_ms']:.1f}ms, "
          f"{'cold' if res.cold else 'warm'})")
    print("top frequent co-occurring terms:")
    for word, freq in res.topk():
        print(f"  {word:15s} freq={freq}")
    print(f"term ids {[int(t) for t in res.term_ids]} "
          f"freqs {[int(f) for f in res.freqs]} on {session.device}")
    return res


if __name__ == "__main__":
    main()
