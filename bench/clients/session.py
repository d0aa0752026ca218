"""One client in a closed loop through ``FCTSession.query``.

Set-up makes the tables from the seed, builds the session, and runs every
keyword set of the pool ``warm_queries`` times, so that its plans are made,
its columns are on the device and its programs are built before the window
opens.  In the window, each request is the next of the generator's stream
and is timed by the client from its call to its answer.  With ``--trace 1``
the first ``trace_requests`` requests of the window run under the profiler.
"""
from __future__ import annotations

import time

from bench import harness, loadgen, port
from bench.data import tpch
from bench.devtrace import DeviceTrace, spans_of
from bench.reference import star


def setup(run) -> None:
    cfg, traffic = run.config, run.traffic
    t = time.perf_counter()
    tables = tpch.generate(cfg, run.seed, run.device)
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


def window(run) -> None:
    session, cfg = run.state["session"], run.config
    stream = loadgen.requests(run.traffic, run.seed)
    n_traced = run.traffic["trace_requests"] if run.trace else 0
    tracer = DeviceTrace().__enter__() if n_traced else None
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while time.perf_counter() < deadline:
        if tracer is not None and run.attempted == n_traced:
            tracer.__exit__(None, None, None)
            run.state["tracer"], tracer = tracer, None
        i, k = next(stream)
        req = port.request(run.pool[i], k, cfg["r_max"])
        run.attempted += 1
        t = time.perf_counter()
        try:
            resp = session.query(req)
        except Exception as e:          # a failed request is counted
            run.failed += 1
            run.errors.append(repr(e))
            continue
        run.answers.append((i, k, resp, (time.perf_counter() - t) * 1e3))
        if tracer is not None:
            run.traced.append(i)
    run.window_s = time.perf_counter() - t0
    if tracer is not None:
        tracer.__exit__(None, None, None)
        run.state["tracer"] = tracer


def finish(run) -> None:
    """Read the trace and drop the program's state."""
    tracer = run.state.pop("tracer", None)
    if tracer is not None:
        traces = [a[2].trace for a in run.answers[:len(run.traced)]]
        run.device_trace = tracer.result(spans_of(traces))
    run.state.pop("session", None)
    harness.free(run)


def reference(run) -> list:
    """The reference per pool entry, then ``(keywords, top_k, response,
    reference freq)`` of every answer of the set-up and the window."""
    cfg = run.config
    tables = star.StarTables(run.state.pop("tables"), cfg["star"], run.device)
    for i, keywords in enumerate(run.pool):
        run.reference[i] = star.fct(tables, keywords, cfg["r_max"],
                                    cfg["vocab"])
    return [(run.pool[a[0]], a[1], a[2], run.reference[a[0]][0])
            for a in run.setup_answers + run.answers]
