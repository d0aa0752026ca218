"""Two closed loops through the serving ``Gateway``: one query client over
the traffic's pool, and one client running TPC-H's RF1 refresh.

The gateway keeps a result cache whose entries outlive the run, patches
them on every append (``append_policy="patch"``) and batches misses in a
``batch_window_ms`` window.  Set-up fills the cache with every keyword set
of the pool and runs the first refresh, so that the append and patch paths
are warm.  In the window, a refresh is two ``Gateway.append`` calls (the new
ORDERS rows, then their LINEITEM rows) and is timed from the first call to
the return of the last, when the patched answers are in the cache.  Every
answer carries the data epoch it was computed at (one epoch per append): the
reference checks it against the data as it stood then, and the epoch may not
be older than the appends that had returned before the query was called.
The answers read after the last refresh are held against the data with every
append in it.
"""
from __future__ import annotations

import threading
import time

from bench import harness, loadgen, port
from bench.data import rf1, tpch
from bench.devtrace import DeviceTrace, spans_of
from bench.reference import star

TENANT = "tpch"


def _refresh(run, j: int) -> float:
    """Apply refresh ``j``; milliseconds from the first append's call to
    the last one's return."""
    gw = run.state["gateway"]
    batches = [(name, rf1.rows(chunk))
               for name, chunk in run.state["refreshes"][j].items()]
    t = time.perf_counter()
    t_ns = time.perf_counter_ns()
    for name, rows in batches:
        gw.append(TENANT, name, rows)
        run.state["appends_done"] += 1
    ms = (time.perf_counter() - t) * 1e3
    run.state["refresh_spans"].append(("refresh", 1, t_ns,
                                       time.perf_counter_ns() - t_ns))
    run.state["applied"] = j + 1
    return ms


def setup(run) -> None:
    from repro_torch.serve import Gateway, GatewayConfig, SchemaRegistry
    cfg, traffic = run.config, run.traffic
    t = time.perf_counter()
    tables = tpch.generate(cfg, run.seed, run.device)
    refreshes = rf1.generate(cfg, tables, traffic["max_refreshes"],
                             run.device)
    harness.sync(run)
    run.phase("data_s", time.perf_counter() - t)
    run.state.update(tables=tables, refreshes=refreshes, applied=0,
                     appends_done=0, refresh_spans=[])
    t = time.perf_counter()
    registry = SchemaRegistry(device=run.device, n_workers=cfg["workers"])
    registry.register(TENANT, port.star_schema(tables, cfg),
                      config=port.session_config(cfg, traffic))
    gw = Gateway(registry, GatewayConfig(**traffic["gateway_config"]))
    run.state.update(registry=registry, gateway=gw)
    run.phase("session_s", time.perf_counter() - t)
    run.pool = loadgen.pool(cfg, traffic)
    k = traffic["top_k"][0]
    for i, keywords in enumerate(run.pool):
        for j in range(traffic["warm_queries"]):
            t = time.perf_counter()
            resp = gw.query(TENANT, port.request(keywords, k, cfg["r_max"]))
            harness.sync(run)
            run.phase("cold_query_s" if j == 0 else "warm_query_s",
                      time.perf_counter() - t)
            run.setup_answers.append((i, k, resp))
    t = time.perf_counter()
    _refresh(run, 0)
    harness.sync(run)
    run.phase("first_refresh_s", time.perf_counter() - t)
    run.state["refresh_spans"].clear()


def window(run) -> None:
    gw, cfg = run.state["gateway"], run.config
    stream = loadgen.requests(run.traffic, run.seed)
    tracer = DeviceTrace().__enter__() if run.trace else None
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    lock = threading.Lock()

    def refresher() -> None:
        j = run.state["applied"]
        while (time.perf_counter() < deadline
               and j < len(run.state["refreshes"])):
            try:
                ms = _refresh(run, j)
            except Exception as e:      # a failed refresh is counted
                with lock:
                    run.failed += 1
                    run.errors.append(repr(e))
                return
            with lock:
                run.attempted += 1
                run.refresh_ms.append(ms)
            j += 1

    thread = threading.Thread(target=refresher, name="rf1")
    thread.start()
    while time.perf_counter() < deadline:
        i, k = next(stream)
        req = port.request(run.pool[i], k, cfg["r_max"])
        before = run.state["appends_done"]
        t = time.perf_counter()
        try:
            resp = gw.query(TENANT, req)
        except Exception as e:          # a failed request is counted
            with lock:
                run.attempted += 1
                run.failed += 1
                run.errors.append(repr(e))
            continue
        with lock:
            run.attempted += 1
            run.answers.append((i, k, resp, (time.perf_counter() - t) * 1e3,
                                before))
    thread.join()
    run.window_s = time.perf_counter() - t0
    if tracer is not None:
        tracer.__exit__(None, None, None)
        run.state["tracer"] = tracer
        run.traced = [a[0] for a in run.answers]


def finish(run) -> None:
    """Read every keyword set's answer after the last refresh, read the
    trace, and drop the program's state."""
    gw, cfg = run.state["gateway"], run.config
    run.state["after"] = [
        (i, k, gw.query(TENANT, port.request(kws, k, cfg["r_max"])))
        for i, kws in enumerate(run.pool) for k in run.traffic["top_k"]]
    tracer = run.state.pop("tracer", None)
    if tracer is not None:
        spans = spans_of(a[2].trace for a in run.answers)
        run.device_trace = tracer.result(spans + run.state["refresh_spans"])
    gw.close()
    run.state.pop("registry").close()
    run.state.pop("gateway")
    harness.free(run)


def reference(run) -> list:
    """The reference at the data epoch each answer is due at, then
    ``(keywords, top_k, response, reference freq)`` of every answer.

    Set-up's answers are due before any append, the answers read after the
    last refresh after every append, and a window answer at the epoch it
    reports.  ``run.stale`` counts the answers whose epoch is older than the
    appends that had returned before their call, or newer than every
    append."""
    cfg = run.config
    tables = run.state.pop("tables")
    done = run.state["refreshes"][:run.state["applied"]]
    n = run.state["appends_done"]
    full = star.StarTables(rf1.applied(tables, done, cfg["star"]),
                           cfg["star"], run.device)
    dims = [d for d, _ in cfg["star"]["dims"]]
    due = ([(i, k, resp, 0, 0) for i, k, resp in run.setup_answers]
           + [(i, k, resp, before, min(resp.data_epoch, n))
              for i, k, resp, _, before in run.answers]
           + [(i, k, resp, n, n) for i, k, resp in run.state["after"]])
    run.stale = sum(not before <= resp.data_epoch <= n
                    for _, _, resp, before, _ in due)
    refs = {}
    out = []
    for i, k, resp, _, epoch in due:
        key = (i, epoch)
        if key not in refs:
            rows = rf1.rows_after(tables, done, epoch)
            t = full.prefix(rows[cfg["star"]["fact"]], [rows[d] for d in dims])
            refs[key] = star.fct(t, run.pool[i], cfg["r_max"], cfg["vocab"])
        out.append((run.pool[i], k, resp, refs[key][0]))
    last = {i: v for (i, _), v in sorted(refs.items())}
    run.reference.update(last)
    return out
