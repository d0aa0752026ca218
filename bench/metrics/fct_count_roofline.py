"""Share of its roofline that the ``fct_count`` kernel reaches over the
traced requests: the least time of their MR² histograms (``bench/
roofline.py``, from the reference's rows) over the profiled device time of
the kernels whose name holds ``fct_count``, in %."""
from bench.roofline import fct_count_least

WEIGHT_BYTES = {"int32": 4, "int64": 8}


def read(run):
    dt = run.device_trace
    if dt is None or not run.traced:
        return None
    kernel_s = sum(s for name, s in dt["kernels"].items()
                   if "fct_count" in name)
    if kernel_s <= 0:
        return None
    cfg = run.config
    least = sum(fct_count_least(run.reference[i][1], cfg["text_len"],
                                cfg["vocab"],
                                WEIGHT_BYTES[cfg["accum_policy"]])["seconds"]
                for i in run.traced)
    return least / kernel_s * 100.0
