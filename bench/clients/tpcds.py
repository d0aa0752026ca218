"""One client in a closed loop through ``FCTSession.query``, over the
TPC-DS ``store_sales`` star: nine dimensions of their own text widths and a
fact without text.

Set-up makes the tables from the seed (``bench/data/tpcds.py``), builds the
session over the star and runs every keyword set of the pool
``warm_queries`` times, as ``bench/clients/session.py`` does; the window
and the finish are that client's.  The reference is
``bench/reference/tpcds.py``, which weighs each relation at its own width.
"""
from __future__ import annotations

import time

from bench import harness, loadgen, port
from bench.clients.session import finish, window  # noqa: F401
from bench.data import tpcds
from bench.reference import star
from bench.reference import tpcds as tpcds_ref


def setup(run) -> None:
    cfg, traffic = run.config, run.traffic
    t = time.perf_counter()
    tables = tpcds.generate(cfg, run.seed, run.device)
    harness.sync(run)
    run.phase("data_s", time.perf_counter() - t)
    run.state["tables"] = tables
    t = time.perf_counter()
    session = port.session(port.star_schema(tables, cfg), cfg, traffic,
                           run.device)
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
    tables = star.StarTables(run.state.pop("tables"), cfg["star"], run.device)
    for i, keywords in enumerate(run.pool):
        run.reference[i] = tpcds_ref.fct(tables, keywords, cfg["r_max"],
                                         cfg["vocab"])
    return [(run.pool[a[0]], a[1], a[2], run.reference[a[0]][0])
            for a in run.setup_answers + run.answers]
