"""Median over the window's queries of ``timings['device_route_ms']``: the
device time of routing (the send tables' all_to_all, the rows' gathers),
between the CUDA events the program records on the stream around the
stage, summed over the query's groups. None where no answer carries the
key (off CUDA, or a program that records no events)."""
import statistics

KEY = "device_route_ms"


def read(run):
    v = [a[2].timings[KEY] for a in run.answers if KEY in a[2].timings]
    return statistics.median(v) if v else None
