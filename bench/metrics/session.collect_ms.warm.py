"""Median of the session's ``timings['collect_ms']`` over the window's
queries: the wait for the device and the histogram's transfer."""
import statistics


def read(run):
    v = [a[2].timings["collect_ms"] for a in run.answers]
    return statistics.median(v) if v else None
