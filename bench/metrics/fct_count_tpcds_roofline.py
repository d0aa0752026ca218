"""Share of its roofline that the ``fct_count`` kernel reaches over the
traced requests of the TPC-DS cell, in %: the least time of their MR²
histograms (``bench/roofline.py``) over the profiled device time of the
kernels whose name holds ``fct_count``.  The least work counts what MR²
must read of the relations that carry text and nothing of one of width 0
(the fact, STORE_SALES): the weights of their tuple-set rows (the TPC-DS
reference's ``text_rows``), the tokens of their weighted rows each at its
own relation's width (``weighted_tokens``, as rows of one token) and one
histogram.  None without a trace, without such kernels, or where the
reference gives no ``text_rows``."""
from bench.roofline import fct_count_least

WEIGHT_BYTES = {"int32": 4, "int64": 8}


def read(run):
    dt = run.device_trace
    if dt is None or not run.traced:
        return None
    kernel_s = sum(s for name, s in dt["kernels"].items()
                   if "fct_count" in name)
    stats = [run.reference[i][1] for i in run.traced]
    if kernel_s <= 0 or any("text_rows" not in s for s in stats):
        return None
    cfg = run.config
    least = sum(fct_count_least({"joined_rows": s["text_rows"],
                                 "weighted_rows": s["weighted_tokens"]},
                                1, cfg["vocab"],
                                WEIGHT_BYTES[cfg["accum_policy"]])["seconds"]
                for s in stats)
    return least / kernel_s * 100.0
