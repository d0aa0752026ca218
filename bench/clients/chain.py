"""One client in a closed loop through ``FCTSession.query``, over the chain
query: CUSTOMER pre-joined into ORDERS by the program
(``repro_torch.data.tpch.prejoin_orders_customer``), then the star.

Set-up makes the raw tables from the seed (``bench/data/chain.py``),
pre-joins them, builds the session over the star and runs every keyword
set of the pool ``warm_queries`` times, as ``bench/clients/session.py``
does; the window and the finish are that client's.  The reference does its
own pre-join of the same raw tables (``bench/reference/chain.py``).
"""
from __future__ import annotations

import time

from bench import harness, loadgen, port
from bench.clients.session import finish, window  # noqa: F401
from bench.data import chain
from bench.reference import chain as chain_ref
from bench.reference import star


def prejoined(tables: dict, cfg: dict) -> dict:
    """``tables`` with ORDERS and CUSTOMER replaced by the program's
    pre-joined relation."""
    from repro_torch.data.schema import Relation
    from repro_torch.data.tpch import prejoin_orders_customer
    pj = cfg["prejoin"]
    orders, customer = tables[pj["orders"]], tables[pj["customer"]]
    key = dict(cfg["star"]["dims"])[pj["name"]]
    merged = prejoin_orders_customer(
        Relation(pj["orders"], keys={key: orders["keys"][key]},
                 key_domains={key: orders["domains"][key]},
                 text=orders["text"]),
        Relation(pj["customer"], keys=dict(customer["keys"]),
                 key_domains=dict(customer["domains"]),
                 text=customer["text"]),
        orders["keys"][pj["key"]])
    out = {k: v for k, v in tables.items()
           if k not in (pj["orders"], pj["customer"])}
    out[pj["name"]] = {"keys": merged.keys, "domains": merged.key_domains,
                       "text": merged.text}
    return out


def setup(run) -> None:
    cfg, traffic = run.config, run.traffic
    t = time.perf_counter()
    tables = chain.generate(cfg, run.seed, run.device)
    harness.sync(run)
    run.phase("data_s", time.perf_counter() - t)
    run.state["tables"] = tables
    t = time.perf_counter()
    schema = port.star_schema(prejoined(tables, cfg), cfg)
    run.phase("prejoin_s", time.perf_counter() - t)
    t = time.perf_counter()
    session = port.session(schema, cfg, traffic, run.device)
    run.state["session"] = session
    run.phase("session_s", time.perf_counter() - t)
    run.pool = loadgen.pool(cfg, traffic)
    k = traffic["top_k"][0]
    for i, keywords in enumerate(run.pool):
        for j in range(traffic["warm_queries"]):
            t = time.perf_counter()
            resp = session.query(port.request(keywords, k, cfg["r_max"]))
            harness.sync(run)
            run.phase("cold_query_s" if j == 0 else "warm_query_s",
                      time.perf_counter() - t)
            run.setup_answers.append((i, k, resp))


def reference(run) -> list:
    """The reference per pool entry, then ``(keywords, top_k, response,
    reference freq)`` of every answer of the set-up and the window."""
    cfg = run.config
    tables = star.StarTables(
        chain_ref.prejoin(run.state.pop("tables"), cfg, run.device),
        cfg["star"], run.device)
    for i, keywords in enumerate(run.pool):
        run.reference[i] = chain_ref.fct(tables, keywords, cfg["r_max"],
                                         cfg["vocab"])
    return [(run.pool[a[0]], a[1], a[2], run.reference[a[0]][0])
            for a in run.setup_answers + run.answers]
