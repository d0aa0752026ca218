"""Median of the session's ``timings['dispatch_ms']`` over the window's
queries: host time to enqueue a warm query's device work."""
import statistics


def read(run):
    v = [a[2].timings["dispatch_ms"] for a in run.answers]
    return statistics.median(v) if v else None
