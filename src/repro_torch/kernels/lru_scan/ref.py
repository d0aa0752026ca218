"""Plain PyTorch version of the diagonal linear recurrence

    h_t = a_t ⊙ h_{t-1} + b_t,        h_{-1} = 0,

over ``a, b [B, S, W]``: a sequential loop over S with a float32 carry, the
definition itself (the numpy loop of the reference's tests), so the CUDA
kernel, which runs the same loop per channel, can be held to it tightly.
Differentiable: autograd through the loop is the plain version of the
kernel's backward (the steps are stacked, not written into a buffer, so the
backward is one pass over S).
The reference's plain version is an associative scan; the two agree to
float32 rounding (``tests/test_torch_lru_scan.py``).  On meta tensors (the
dry-run) the step loop is trip-counted (``launch/op_analysis.py``).
"""
from __future__ import annotations

import torch

from repro_torch.launch.op_analysis import stack_trips, trips


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b [B, S, W] -> h [B, S, W] in the dtype of ``a``."""
    if a.shape != b.shape or a.dim() != 3:
        raise ValueError(f"need a, b [B, S, W] of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    af, bf = a.float(), b.float()
    if a.shape[1] == 0:
        return torch.empty_like(a)
    h = torch.zeros_like(af[:, 0])
    out = []
    for t in trips(a.shape[1], a, "lru_scan"):
        h = torch.addcmul(bf[:, t], af[:, t], h)
        out.append(h)
    return stack_trips(out, a.shape[1], dim=1).to(a.dtype)
