"""Planning/dispatch pipeline behind ``FCTSession.submit``.

The ROADMAP async item: overlap host-side planning of query k+1 with device
execution of query k.  Three single-worker stages connected by queues:

  planner    : request          -> planned query      (FCTSession._plan)
  dispatcher : planned query    -> in-flight handle   (async device enqueue)
  finalizer  : in-flight handle -> FCTResponse        (transfer + top-k)

CUDA kernel launches are asynchronous, so the dispatcher returns once its
work is enqueued on the device's current stream, and device compute of
query k proceeds while the planner plans k+1 (numpy, GIL mostly held) and
the finalizer blocks on k-1's transfer (GIL released).  Every stage uses the
same stream, so the device runs queries in dispatch order and no tensor
crosses streams.  The dispatcher never waits on the device itself, but the
store uploads and a new plan's send tables it ships are pageable host
memory, whose copies wait for the stream: how much a burst overlaps is
measured, not promised.  Each query runs the same deterministic
summed-output programs as ``query()`` (callers that want cross-query
stacked dispatches use ``query_batch``, whose composition they control).

Because every stage is a single thread, futures resolve in submission order;
a request that fails during planning still flows through the downstream
queues (as an error token) so ordering holds for mixed success/failure
streams.  Exceptions land on the future of the request that caused them and
never kill the worker threads.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.api.request import FCTRequest
    from repro_torch.api.session import FCTSession

_STOP = object()


class QueryPipeline:
    """FIFO plan/dispatch/finalize pipeline over one :class:`FCTSession`."""

    def __init__(self, session: "FCTSession", queue_depth: int = 64) -> None:
        self._session = session
        self._plan_q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._exec_q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._fin_q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._closed = False
        self._submit_lock = threading.Lock()  # submit() vs close() race
        self._threads = [
            threading.Thread(target=self._plan_loop, name="fct-planner",
                             daemon=True),
            threading.Thread(target=self._exec_loop, name="fct-dispatcher",
                             daemon=True),
            threading.Thread(target=self._fin_loop, name="fct-finalizer",
                             daemon=True),
        ]
        for t in self._threads:
            t.start()

    def submit(self, request: "FCTRequest") -> "Future":
        fut: Future = Future()
        # the check and the enqueue must be atomic vs close(), or a request
        # could land behind the _STOP sentinel and never resolve
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("pipeline is closed")
            self._plan_q.put((request, fut))
        return fut

    def _plan_loop(self) -> None:
        while True:
            item = self._plan_q.get()
            if item is _STOP:
                self._exec_q.put(_STOP)
                return
            request, fut = item
            try:
                planned = self._session._plan(request)
            except BaseException as exc:  # propagate, keep FIFO order
                self._exec_q.put((None, fut, exc))
            else:
                self._exec_q.put((planned, fut, None))

    def _exec_loop(self) -> None:
        while True:
            item = self._exec_q.get()
            if item is _STOP:
                self._fin_q.put(_STOP)
                return
            planned, fut, exc = item
            flight = None
            if exc is None:
                try:  # async enqueue: does not block on device compute
                    flight = self._session._dispatch_planned([planned])
                except BaseException as dispatch_exc:
                    exc = dispatch_exc
            self._fin_q.put((fut, flight, exc))

    @staticmethod
    def _resolve(fut: "Future", result=None, exc=None) -> None:
        """set_result/set_exception tolerating caller-side cancellation —
        an InvalidStateError here would kill the finalizer thread and wedge
        every later submit()."""
        if fut.cancelled():
            return
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except Exception:  # racing cancel()
            pass

    def _fin_loop(self) -> None:
        while True:
            item = self._fin_q.get()
            if item is _STOP:
                return
            fut, flight, err = item
            if err is not None:
                self._resolve(fut, exc=err)
                continue
            try:
                (response,) = self._session._finalize(flight)
            except BaseException as exc:
                self._resolve(fut, exc=exc)
            else:
                self._resolve(fut, result=response)

    def close(self) -> None:
        """Drain in-flight requests, then stop all workers (idempotent)."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._plan_q.put(_STOP)
        for t in self._threads:
            t.join()
