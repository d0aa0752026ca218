"""H100 peaks and the least work of the FCT kernels.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit), as
``src/repro_torch/launch/roofline.py`` holds them at commit b56447e.

``fct_count_least`` is the least a weighted histogram of one query's MR²
must move, after ``chip_smoke.py::time_kernel``'s byte bound (commit b56447e)
but counted from the work the query needs and not from the padded shapes of
a call: the weight of every row that a CN joining the fact with a dimension
sends to MR² (its tuple-set rows), the tokens of the rows whose weight is
not 0 (a row that weighs 0 adds nothing), each read once, and the
histogram written once.  One scalar add per token of those rows is its
operation count.  The rows come from the plain reference's own tuple sets,
so the count does not depend on how the program implements MR².
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12       # HBM3
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12        # dense bf16 on the tensor cores

TOKEN_BYTES = 4                 # int32 token ids


def fct_count_least(stats: dict, text_len: int, vocab: int,
                    weight_bytes: int) -> dict:
    """``{"bytes", "ops", "seconds"}`` for one query whose reference
    ``stats`` (``joined_rows``, ``weighted_rows``) are given."""
    nbytes = (stats["joined_rows"] * weight_bytes
              + stats["weighted_rows"] * text_len * TOKEN_BYTES
              + vocab * weight_bytes)
    ops = stats["weighted_rows"] * text_len
    seconds = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_F32_FLOPS)
    return {"bytes": nbytes, "ops": ops, "seconds": seconds}
