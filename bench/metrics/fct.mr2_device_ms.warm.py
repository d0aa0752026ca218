"""Median over the window's queries of ``timings['device_mr2_ms']``: the
device time of MR² (the ``fct_count`` weighted histograms), between the
CUDA events the program records on the stream around the stage, summed
over the query's groups. None where no answer carries the key (off CUDA,
or a program that records no events)."""
import statistics

KEY = "device_mr2_ms"


def read(run):
    v = [a[2].timings[KEY] for a in run.answers if KEY in a[2].timings]
    return statistics.median(v) if v else None
