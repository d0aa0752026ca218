"""Per-request trace/span recording, lock-free per thread.

Every ``FCTRequest`` gets a ``Trace`` (created in ``FCTSession._plan`` or at
the gateway edge) carrying a process-unique request id.  Spans record into a
per-thread buffer inside the trace — appends touch only this thread's list,
and the dict insert / list append are single bytecode-level operations the
GIL makes atomic, so recording takes no lock on the hot path.  Readers
(``records()`` / ``chrome_events()``) copy the buffers, which is safe against
concurrent appends for the same reason.

Two recording styles:

* ``with trace.activate():`` binds the trace to the current thread; inside,
  ``with span("name", k=v):`` opens a nested span — nesting is tracked on a
  per-activation stack, so parent ids are correct without any coordination.
  ``span()`` is a cheap no-op when no trace is active, so library code can
  instrument unconditionally.
* ``trace.add_span(name, t0_ns, dur_ns, **args)`` records an explicitly
  timed span from any thread (used on the pipelined path where dispatch and
  finalize run on different threads than plan, and for batcher queue-wait
  windows measured after the fact).

Timestamps are ``time.perf_counter_ns`` — monotonic and shared across
threads of one process, which is what Chrome's trace viewer needs to line
spans up.

One hook (``set_span_hook``) lets a layer that knows a device profiler
mirror every ``span()`` into it: the hook is called with the span's name
when the span opens and returns an entered context (or ``None``), which is
exited when the span closes.  ``repro_torch.runtime`` installs one that opens
a ``torch.profiler.record_function`` range while a profiler is recording, so
this module stays free of torch.
"""
from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional

_REQUEST_IDS = itertools.count(1)  # itertools.count.__next__ is GIL-atomic
_TLS = threading.local()
#: called with a recorded span's name as it opens; returns an entered
#: context to exit when the span closes, or None (see ``set_span_hook``)
_SPAN_HOOK: Optional[Callable[[str], Any]] = None


def set_span_hook(hook: Optional[Callable[[str], Any]]):
    """Install ``hook`` for every recorded ``span()`` (None removes it);
    returns the hook it replaces.  The hook runs on the span's own thread
    and should cost one check when it has nothing to do."""
    global _SPAN_HOOK
    prev, _SPAN_HOOK = _SPAN_HOOK, hook
    return prev


class Span:
    """One timed interval.  ``parent_id == 0`` means a trace-root child."""

    __slots__ = ("name", "span_id", "parent_id", "t0_ns", "dur_ns",
                 "thread_id", "args")

    def __init__(self, name: str, span_id: int, parent_id: int, t0_ns: int,
                 dur_ns: int, thread_id: int, args: Dict[str, Any]) -> None:
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0_ns = t0_ns
        self.dur_ns = dur_ns
        self.thread_id = thread_id
        self.args = args

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, dur_us={self.dur_ns / 1e3:.1f})")


class Trace:
    """Span tree for one request (or one coalesced request family)."""

    def __init__(self, request_id: Optional[str] = None) -> None:
        if request_id is None:
            request_id = f"q{next(_REQUEST_IDS):06d}"
        self.request_id = request_id
        self.t0_ns = time.perf_counter_ns()
        self._seq = itertools.count(1)
        self._buffers: Dict[int, List[Span]] = {}

    # -- recording ------------------------------------------------------------
    def _record(self, sp: Span) -> None:
        buf = self._buffers.get(sp.thread_id)
        if buf is None:
            buf = self._buffers.setdefault(sp.thread_id, [])
        buf.append(sp)

    def add_span(self, name: str, t0_ns: int, dur_ns: int,
                 parent_id: int = 0, **args) -> Span:
        """Record an explicitly timed span (any thread, no activation)."""
        sp = Span(name, next(self._seq), parent_id, t0_ns, max(0, int(dur_ns)),
                  threading.get_ident(), dict(args))
        self._record(sp)
        return sp

    @contextmanager
    def activate(self) -> Iterator["Trace"]:
        """Bind this trace to the current thread for ``span()`` recording.
        Re-entrant: restores whatever was active before on exit."""
        prev = getattr(_TLS, "state", None)
        _TLS.state = (self, [0])  # (trace, open-span-id stack rooted at 0)
        try:
            yield self
        finally:
            _TLS.state = prev

    # -- reads ----------------------------------------------------------------
    def spans(self) -> List[Span]:
        out: List[Span] = []
        for buf in list(self._buffers.values()):
            out.extend(list(buf))
        out.sort(key=lambda s: (s.t0_ns, s.span_id))
        return out

    def span_names(self) -> List[str]:
        return [s.name for s in self.spans()]

    def records(self) -> List[Dict[str, Any]]:
        """Structured per-span dicts (what ``FCTResponse.trace`` consumers
        serialize); offsets are relative to trace start, microseconds."""
        return [{
            "request_id": self.request_id,
            "name": s.name,
            "span_id": s.span_id,
            "parent_id": s.parent_id,
            "t0_us": round((s.t0_ns - self.t0_ns) / 1e3, 3),
            "dur_us": round(s.dur_ns / 1e3, 3),
            "thread_id": s.thread_id,
            "args": dict(s.args),
        } for s in self.spans()]

    def chrome_events(self) -> List[Dict[str, Any]]:
        """Chrome ``trace_event`` complete ("X") events.  pid = request
        sequence number so chrome://tracing groups each request into its own
        process row; tid = the real OS thread id."""
        digits = "".join(ch for ch in self.request_id if ch.isdigit())
        pid = int(digits) if digits else (hash(self.request_id) & 0x7FFF) + 1
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": self.request_id},
        }]
        for s in self.spans():
            events.append({
                "name": s.name, "ph": "X", "pid": pid, "tid": s.thread_id,
                "ts": round(s.t0_ns / 1e3, 3), "dur": round(s.dur_ns / 1e3, 3),
                "args": {**s.args, "request_id": self.request_id,
                         "span_id": s.span_id, "parent_id": s.parent_id},
            })
        return events


def current_trace() -> Optional[Trace]:
    """The trace activated on this thread, if any."""
    state = getattr(_TLS, "state", None)
    return state[0] if state is not None else None


@contextmanager
def span(name: str, **args) -> Iterator[Span]:
    """Open a nested span on the thread-active trace; no-op (but still
    yields a scratch ``Span`` whose ``args`` may be set) when none is
    active, so instrumentation sites need no guards."""
    state = getattr(_TLS, "state", None)
    if state is None:
        yield Span(name, 0, 0, 0, 0, threading.get_ident(), dict(args))
        return
    trace, stack = state
    hook = _SPAN_HOOK
    sp = Span(name, next(trace._seq), stack[-1], time.perf_counter_ns(), 0,
              threading.get_ident(), dict(args))
    mirror = hook(name) if hook is not None else None
    stack.append(sp.span_id)
    try:
        yield sp
    finally:
        if mirror is not None:
            mirror.__exit__(None, None, None)
        sp.dur_ns = time.perf_counter_ns() - sp.t0_ns
        stack.pop()
        trace._record(sp)


@contextmanager
def maybe_activate(trace: Optional[Trace]) -> Iterator[Optional[Trace]]:
    """``trace.activate()`` when a trace is present, else a no-op — for
    call sites (engine dispatch leaders) where tracing is optional."""
    if trace is None:
        yield None
        return
    with trace.activate():
        yield trace
