"""Time-windowed dynamic batching for one tenant's FCTSession.

``submit()``'s pipeline keeps a burst of queries *in flight* concurrently
but still dispatches each one individually
— only explicit ``query_batch`` callers get cross-query stacked dispatches.
Under heavy traffic the gateway should make that amortization automatic: a
``DynamicBatcher`` collects requests arriving within a small time window
(~1ms, configurable) and flushes each window through
``FCTSession.query_batch``, so same-signature CNs from *different users*
ride one stacked device dispatch.  The per-CN program family buckets its
CN-axis size (null-plan padding in the runtime), so varying window sizes
replay a handful of built programs instead of one per size.

The trade is explicit: up to ``window_ms`` of added latency per query buys
fewer device round-trips per query — the paper's batch-amortization argument
(n-gram statistics serving) applied to the online workload.

One *collector* thread per batcher opens and closes windows.  The window
opens when a request lands in an empty queue and closes ``window_ms`` later;
everything collected in between is one ``query_batch`` call.
``window_ms=0`` degenerates to flush-as-fast-as-possible (whatever
accumulated while the previous flush ran forms the next batch — still > 1
under load).  Errors during a flush land on every future of that window
(request *validation* errors are caught earlier, at gateway submit time).

Where the flush RUNS is pluggable: standalone, the collector flushes inline
(one tenant, nothing to contend with); under the gateway, every tenant's
batcher shares one :class:`FlushPool` — a small executor that runs windows
of *different tenants* in parallel.  Inline, tenant B's window waits while tenant A's flush blocks on
its device transfer; pooled, the collector hands the window off and
immediately reopens, so one slow tenant cannot convoy the others.  Every
flush thread enqueues on the device's current stream (the same default
stream for all of them), so the device runs windows in enqueue order and no
tensor crosses streams.  The pool
counts concurrently-running flushes (``flush_peak_inflight``) so load tests
can assert the cross-tenant parallelism actually happened.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Tuple

from repro_torch.api.request import FCTRequest
from repro_torch.api.session import FCTSession
from repro_torch.obs import OCCUPANCY_BUCKETS, Trace, default_registry


class FlushPool:
    """Shared flush executor + cross-tenant flush-concurrency telemetry.

    ``submit`` runs a window flush on one of ``max_workers`` threads and
    tracks how many flushes are running concurrently; the peak is the
    metric that proves (or disproves) cross-tenant flush parallelism.
    One pool serves all tenants of a gateway; ``shutdown`` drains it.
    """

    def __init__(self, max_workers: int = 4, metrics=None) -> None:
        if max_workers < 1:
            raise ValueError(f"max_workers must be >= 1, got {max_workers}")
        self.max_workers = max_workers
        self._ex = ThreadPoolExecutor(max_workers=max_workers,
                                      thread_name_prefix="fct-flush")
        self.metrics = metrics if metrics is not None else default_registry()
        self._c_flushes = self.metrics.counter("flush_pool.flushes")
        self._g_inflight = self.metrics.gauge("flush_pool.inflight")
        self._g_peak = self.metrics.gauge("flush_pool.peak_inflight",
                                          agg="max")

    def submit(self, flush) -> Future:
        def run():
            self._c_flushes.inc()
            # Gauge.add returns the post-add depth atomically, so the peak
            # never misses a concurrent spike
            self._g_peak.set_max(self._g_inflight.add(1))
            try:
                flush()
            finally:
                self._g_inflight.add(-1)

        return self._ex.submit(run)

    def stats(self) -> dict:
        flushes, inflight, peak = self.metrics.values(
            self._c_flushes, self._g_inflight, self._g_peak)
        return {"flush_workers": self.max_workers,
                "flushes": flushes,
                "flush_inflight": inflight,
                "flush_peak_inflight": peak}

    def shutdown(self) -> None:
        self._ex.shutdown(wait=True)


class DynamicBatcher:
    """Collect requests for ``window_ms``; flush through ``query_batch``."""

    def __init__(self, session: FCTSession, window_ms: float = 1.0,
                 name: str = "", pool: Optional[FlushPool] = None,
                 metrics=None) -> None:
        if window_ms < 0:
            raise ValueError(f"window_ms must be >= 0, got {window_ms}")
        self.session = session
        self.window_ms = window_ms
        self.name = name
        self._pool = pool
        self._outstanding: List[Future] = []   # pooled flushes not yet done
        # (request, future, trace, enqueue perf_counter_ns)
        self._pending: List[Tuple[FCTRequest, Future, Trace, int]] = []
        self._cv = threading.Condition()
        self._closed = False
        # occupancy telemetry (gateway passes a per-tenant labeled registry)
        self.metrics = metrics if metrics is not None else default_registry()
        self._c_windows = self.metrics.counter("batcher.windows_flushed")
        self._c_queries = self.metrics.counter("batcher.queries_batched")
        self._g_max_window = self.metrics.gauge("batcher.max_window_queries",
                                                agg="max")
        self._h_window = self.metrics.histogram("batcher.window_queries",
                                                buckets=OCCUPANCY_BUCKETS)
        self._thread = threading.Thread(
            target=self._loop, name=f"fct-batcher-{name or hex(id(self))}",
            daemon=True)
        self._thread.start()

    def submit(self, request: FCTRequest,
               trace: Optional[Trace] = None) -> Future:
        """Enqueue one request; ``trace`` continues a span tree the caller
        (the gateway) already opened — queue wait and session stages record
        onto it.  Standalone callers get a fresh trace per request."""
        fut: Future = Future()
        if trace is None:
            trace = Trace()
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._pending.append((request, fut, trace,
                                  time.perf_counter_ns()))
            self._cv.notify()
        return fut

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._pending:
                    # window opens at the first queued request; keep
                    # collecting until it elapses (spurious wakeups from
                    # later submits just re-check the deadline)
                    deadline = time.perf_counter() + self.window_ms / 1e3
                    while not self._closed:
                        remaining = deadline - time.perf_counter()
                        if remaining <= 0:
                            break
                        self._cv.wait(timeout=remaining)
                batch, self._pending = self._pending, []
                closed = self._closed
            if batch:
                if self._pool is not None:
                    # hand the window to the shared pool and reopen
                    # immediately: windows of different tenants (and, under
                    # backlog, consecutive windows of this one — the
                    # session's query_batch is thread-safe) flush in parallel
                    fut = self._pool.submit(
                        lambda batch=batch: self._flush(batch))
                    with self._cv:
                        self._outstanding.append(fut)
                        self._outstanding = [f for f in self._outstanding
                                             if not f.done()]
                else:
                    self._flush(batch)
            if closed:
                return

    def _flush(self, batch: List[Tuple[FCTRequest, Future, Trace, int]]) -> None:
        reqs = [r for r, _, _, _ in batch]
        traces = [t for _, _, t, _ in batch]
        t_flush_ns = time.perf_counter_ns()
        for _, _, trace, t_enq_ns in batch:
            # queue wait: enqueue -> flush start, one span per request
            trace.add_span("batcher.window", t_enq_ns,
                           t_flush_ns - t_enq_ns, queued=len(batch))
        try:
            responses = self.session.query_batch(reqs, traces=traces)
        except BaseException as exc:
            # batch-wide failure (e.g. histogram overflow): every request in
            # the window shared the dispatch, so every future gets the error
            for _, fut, _, _ in batch:
                if not fut.cancelled():
                    try:
                        fut.set_exception(exc)
                    except Exception:      # racing cancel()
                        pass
            return
        dur_ns = time.perf_counter_ns() - t_flush_ns
        for trace in traces:
            trace.add_span("batcher.flush", t_flush_ns, dur_ns,
                           window_queries=len(batch))
        self._c_windows.inc()
        self._c_queries.inc(len(batch))
        self._g_max_window.set_max(len(batch))
        self._h_window.observe(len(batch))
        for (_, fut, _, _), resp in zip(batch, responses):
            if not fut.cancelled():
                try:
                    fut.set_result(resp)
                except Exception:          # racing cancel()
                    pass

    def stats(self) -> dict:
        windows, queries, peak = self.metrics.values(
            self._c_windows, self._c_queries, self._g_max_window)
        return {"windows_flushed": windows, "queries_batched": queries,
                "max_window_queries": peak,
                "mean_window_queries": round(queries / windows, 3)
                if windows else 0.0}

    def close(self) -> None:
        """Flush whatever is pending, then stop the collector — and, with a
        pool, wait for every handed-off window to finish (idempotent)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify()
        self._thread.join()
        # after the join the collector has appended every pooled flush and no
        # new windows can open, but a concurrent close() racing this one must
        # not iterate a list the other is clearing — swap it out under the
        # condition first
        with self._cv:
            outstanding, self._outstanding = self._outstanding, []
        for fut in outstanding:
            fut.result()
