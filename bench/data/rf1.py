"""TPC-H's new-sales refresh function RF1 over the benchmark's star.

TPC-H v3 clause 2.5.2: each RF1 inserts ``SF * 1500`` new ORDERS rows and,
for each, 1 to 7 (uniform) LINEITEM rows.  Here the new orders take the next
dense order keys, their LINEITEM rows reference them and draw their part
and supplier keys as the configuration draws foreign keys, and every new
row's text is drawn and planted as its relation's rows are
(``bench/data/tpch.py``), so that each refresh changes the answers of the
planted keyword sets.  All refreshes of a run are drawn in one go on the
device from the configuration's ``data_seed``, so that every run appends the
same rows; they join the run's permuted dimensions.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench.data import tpch

STREAM = 2              # seeds the refreshes apart from the tables


def generate(cfg: dict, tables: Dict[str, dict], count: int,
             device) -> List[Dict[str, dict]]:
    """``count`` refreshes: each ``{relation: {"keys": {col: [n]}, "text":
    [n, text_len]}}`` for ORDERS, then LINEITEM (numpy int32)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(cfg["data_seed"]), STREAM])
                        .generate_state(1, np.uint64)[0] >> 1))
    star, planted = cfg["star"], cfg["planted"]
    kws = planted["keywords"]
    fact = star["fact"]
    (odim, okey), = [(d, k) for d, k in star["dims"] if d == "ORDERS"]
    n_orders = int(1500 * cfg["scale_factor"])
    next_key = int(tables[odim]["domains"][okey])
    out = []
    for _ in range(count):
        otext = tpch.text_draws(n_orders, cfg, gen, device)
        tpch.plant(otext, [kws[i] for i in planted["relations"].get(odim, [])],
                   planted["frac"], gen)
        okeys = torch.arange(next_key, next_key + n_orders, device=device)
        per = torch.randint(1, 8, (n_orders,), generator=gen, device=device)
        lkeys = {okey: okeys.repeat_interleave(per)}
        n = int(lkeys[okey].numel())
        for dim, key in star["dims"]:
            if dim != odim:
                lkeys[key] = tpch.foreign_keys(
                    int(tables[dim]["domains"][key]), n, cfg["foreign_keys"],
                    gen, device)
        ltext = tpch.text_draws(n, cfg, gen, device)
        tpch.plant(ltext, [kws[i] for i in planted["relations"].get(fact, [])],
                   planted["frac"], gen)
        out.append({
            odim: {"keys": {okey: okeys.to(torch.int32).cpu().numpy()},
                   "text": otext.cpu().numpy()},
            fact: {"keys": {k: v.to(torch.int32).cpu().numpy()
                            for k, v in lkeys.items()},
                   "text": ltext.cpu().numpy()}})
        next_key += n_orders
    return out


def rows(chunk: dict) -> List[dict]:
    """One relation's new rows as ``Gateway.append`` takes them."""
    keys = {c: v.tolist() for c, v in chunk["keys"].items()}
    return [dict({c: v[r] for c, v in keys.items()}, text=chunk["text"][r])
            for r in range(chunk["text"].shape[0])]


def appends(refreshes: List[Dict[str, dict]]) -> List[tuple]:
    """``(relation, chunk)`` of every append of ``refreshes``, in order."""
    return [(name, chunk) for r in refreshes for name, chunk in r.items()]


def applied(tables: Dict[str, dict], refreshes: List[Dict[str, dict]],
            star: dict) -> Dict[str, dict]:
    """The tables with every chunk of ``refreshes`` appended; each key
    domain grows to cover the new keys."""
    out = {}
    for name, t in tables.items():
        chunks = [ch for n, ch in appends(refreshes) if n == name]
        out[name] = {
            "keys": {c: np.concatenate([v] + [ch["keys"][c] for ch in chunks])
                     for c, v in t["keys"].items()},
            "domains": dict(t["domains"]),
            "text": np.concatenate([t["text"]] + [ch["text"] for ch in chunks])}
    for dim, key in star["dims"]:
        dom = max(out[dim]["domains"][key],
                  int(out[dim]["keys"][key].max()) + 1)
        out[dim]["domains"][key] = out[star["fact"]]["domains"][key] = dom
    return out


def rows_after(tables: Dict[str, dict], refreshes: List[Dict[str, dict]],
               n_appends: int) -> Dict[str, int]:
    """Each relation's row count after the first ``n_appends`` appends."""
    out = {name: len(t["text"]) for name, t in tables.items()}
    for name, chunk in appends(refreshes)[:n_appends]:
        out[name] += len(chunk["text"])
    return out
