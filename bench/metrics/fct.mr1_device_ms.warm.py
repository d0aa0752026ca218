"""Median over the window's queries of ``timings['device_mr1_ms']``: the
device time of MR¹ (num-arrays, probes, volumes: the scatter-adds and
gathers), between the CUDA events the program records on the stream around
the stage, summed over the query's groups. None where no answer carries
the key (off CUDA, or a program that records no events)."""
import statistics

KEY = "device_mr1_ms"


def read(run):
    v = [a[2].timings[KEY] for a in run.answers if KEY in a[2].timings]
    return statistics.median(v) if v else None
