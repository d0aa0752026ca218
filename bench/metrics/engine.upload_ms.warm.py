"""Median over the window's queries of the summed ``engine.upload`` spans of
each query's trace, in ms: the host-to-device copies of each group's send
tables and key-column indices (pageable, so the host waits for them). None
where no query's trace holds such a span (a program without them)."""
import statistics

NAMES = ("engine.upload",)


def read(run):
    per_query, seen = [], False
    for a in run.answers:
        spans = [s for s in a[2].trace.spans() if s.name in NAMES] \
            if a[2].trace is not None else []
        seen = seen or bool(spans)
        per_query.append(sum(s.dur_ns for s in spans) / 1e6)
    return statistics.median(per_query) if seen else None
