"""One client that keeps a fixed number of ``FCTSession.submit`` futures in
flight.

Set-up, ``finish`` and ``reference`` are the closed-loop client's
(``bench/clients/session.py``): the same tables, session, warmed pool and
check.  In the window the client submits the next request of the
generator's stream whenever fewer than the traffic's ``in_flight`` futures
are outstanding, so the session's planning, dispatch and finalize stages
overlap across requests.  Each request is timed from its ``submit`` to the
moment its future resolves, and the answers are kept in submission order
(the pipeline resolves them in that order).  At the deadline the client
submits nothing more, waits for what is in flight and closes the session's
pipeline.  A window that never held ``in_flight`` futures in flight at once
(submitted and not yet resolved) raises, so that the run prints no result.
With ``--trace 1`` the profiler records until the first ``trace_requests``
answers have come back.
"""
from __future__ import annotations

import collections
import time

from bench import loadgen, port
from bench.clients.session import finish, reference, setup  # noqa: F401
from bench.devtrace import DeviceTrace


def window(run) -> None:
    session, cfg = run.state["session"], run.config
    depth = int(run.traffic["in_flight"])
    stream = loadgen.requests(run.traffic, run.seed)
    n_traced = run.traffic["trace_requests"] if run.trace else 0
    tracer = DeviceTrace().__enter__() if n_traced else None
    pending = collections.deque()    # (pool index, top_k, t_submit, done, future)
    most = 0
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while True:
        while len(pending) < depth and time.perf_counter() < deadline:
            i, k = next(stream)
            done = []
            run.attempted += 1
            t = time.perf_counter()
            try:
                fut = session.submit(port.request(run.pool[i], k,
                                                  cfg["r_max"]))
            except Exception as e:      # a failed request is counted
                run.failed += 1
                run.errors.append(repr(e))
                continue
            # resolution time, taken on the thread that resolves the future
            fut.add_done_callback(
                lambda _f, done=done: done.append(time.perf_counter()))
            pending.append((i, k, t, done, fut))
        # futures not yet resolved, as the last refill left them
        most = max(most, sum(not p[4].done() for p in pending))
        if not pending:
            break
        i, k, t, done, fut = pending.popleft()
        try:
            resp = fut.result()
        except Exception as e:
            run.failed += 1
            run.errors.append(repr(e))
            continue
        # the callback may still be running when ``result`` returns
        t_done = done[0] if done else time.perf_counter()
        run.answers.append((i, k, resp, (t_done - t) * 1e3))
        if tracer is not None:
            run.traced.append(i)
            if len(run.answers) == n_traced:
                tracer.__exit__(None, None, None)
                run.state["tracer"], tracer = tracer, None
    run.window_s = time.perf_counter() - t0
    # stop the pipeline's threads, which hold the session, so that
    # ``finish`` frees its device memory before the reference runs
    session.close()
    if tracer is not None:
        tracer.__exit__(None, None, None)
        run.state["tracer"] = tracer
    if most < depth:
        raise RuntimeError(f"the window held at most {most} futures in "
                           f"flight, not {depth}")
