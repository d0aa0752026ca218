"""Export sinks: Chrome trace JSON and a periodic JSON-lines metrics
reporter.

``chrome_trace(traces)`` flattens any iterable of ``Trace`` objects into one
``{"traceEvents": [...]}`` document that chrome://tracing and Perfetto open
directly (each request renders as its own process row).

``JsonLinesReporter`` snapshots a ``MetricsRegistry`` every ``interval_s``
seconds onto a file, one JSON object per line — cheap enough to leave on in
serving processes, greppable/stream-parseable offline.  ``close()`` always
writes one final snapshot, so even short-lived runs produce a record.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Iterable, Optional

from repro_torch.obs.trace import Trace


def chrome_trace(traces: Iterable[Optional[Trace]]) -> Dict[str, Any]:
    """Merge traces into one Chrome ``trace_event`` JSON document.  ``None``
    entries (untraced responses) are skipped."""
    events = []
    for tr in traces:
        if tr is not None:
            events.extend(tr.chrome_events())
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, traces: Iterable[Optional[Trace]]) -> int:
    """Write ``chrome_trace(traces)`` to ``path``; returns the event count."""
    doc = chrome_trace(traces)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return len(doc["traceEvents"])


class JsonLinesReporter:
    """Background thread appending registry snapshots to a JSONL file."""

    def __init__(self, registry, path: str, interval_s: float = 10.0) -> None:
        self._registry = registry
        self._path = path
        self._interval_s = max(0.05, float(interval_s))
        self._stop = threading.Event()
        self._fh = open(path, "a")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="obs-metrics-reporter")
        self._thread.start()

    def _write_snapshot(self) -> None:
        line = json.dumps({"ts": time.time(),
                           "metrics": self._registry.snapshot()},
                          default=str)
        self._fh.write(line + "\n")
        self._fh.flush()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval_s):
            self._write_snapshot()

    def close(self) -> None:
        """Stop the thread, write one final snapshot, close the file
        (idempotent)."""
        if self._fh.closed:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._write_snapshot()
        self._fh.close()
