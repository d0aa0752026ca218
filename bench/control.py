"""The control of the correctness check: the plain reference put in the
program's place, accumulating in a narrower dtype than the configuration's
int32, must come out not correct.

    python3 bench/control.py --config tpch_sf1_uniform --seeds 11 12 13 [--acc int16 float32]

For each seed it makes the configuration's tables on the card, computes the
exact reference (int64) and the control, answers one block of the traffic's
requests from the control's frequencies, as the program's host finalize
would (its top-k of its own vector), and prints ``check.compare``'s numbers
against the exact reference.  ``int16`` is the nearest integer width below
the stated int32 and wraps past 32 767; ``float32`` rounds past 2^24.
"""
from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from bench import check, harness, loadgen  # noqa: E402
from bench.data import tpch  # noqa: E402
from bench.reference import star  # noqa: E402

ACC = {"int16": torch.int16, "float32": torch.float32, "int64": torch.int64}


def answer(freq, keywords, k):
    """A stand-in for a program response computed from ``freq``."""
    ids, f = star.topk(freq, keywords, k)
    return types.SimpleNamespace(all_freqs=freq, term_ids=ids, freqs=f)


def readings(cfg: dict, traffic: dict, seed: int, acc: str, device) -> dict:
    """``check.compare``'s numbers of the control at ``acc`` over one block
    of the traffic, and the largest exact count."""
    tables = star.StarTables(tpch.generate(cfg, seed, device), cfg["star"],
                             device)
    pool = loadgen.pool(cfg, traffic)
    exact, control = {}, {}
    for i, keywords in enumerate(pool):
        exact[i] = star.fct(tables, keywords, cfg["r_max"], cfg["vocab"])[0]
        control[i] = star.fct(tables, keywords, cfg["r_max"], cfg["vocab"],
                              ACC[acc])[0]
    answers = [(pool[i], k, answer(control[i], pool[i], k), exact[i])
               for i, k in loadgen.block(traffic)]
    out = {n: c["value"] for n, c in check.compare(answers, 0).items()}
    out["max_count"] = int(max(f.max() for f in exact.values()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="warm_pool")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--acc", nargs="+", default=["int16", "float32"])
    args = ap.parse_args(argv)
    spec = harness.load_spec()
    entry = {c["name"]: c for c in spec["configs"]}[args.config]
    cfg = json.loads((harness.ROOT / entry["file"]).read_text())
    traffic = json.loads((harness.BENCH / "traffic" /
                          f"{args.traffic}.json").read_text())
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        for acc in args.acc:
            print(json.dumps({"config": args.config, "seed": seed,
                              "acc": acc, **readings(cfg, traffic, seed, acc,
                                                     device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
