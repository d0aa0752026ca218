"""FCT (query-driven frequent co-occurring term extraction) in PyTorch.

A port of the ``repro`` package's FCT engine to PyTorch and CUDA: the host
planner is the same numpy code, the device program runs on one CUDA device
(P MapReduce workers as a leading tensor axis), and the MR² weighted
histogram is a hand-written CUDA kernel (``kernels/fct_count``).  Entry
points run on the card unless the caller passes ``device="cpu"``.
"""
