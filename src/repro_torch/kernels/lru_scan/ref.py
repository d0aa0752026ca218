"""Plain PyTorch version of the diagonal linear recurrence

    h_t = a_t ⊙ h_{t-1} + b_t,        h_{-1} = 0,

over ``a, b [B, S, W]``: a sequential loop over S with a float32 carry, the
definition itself (the numpy loop of the reference's tests), so the CUDA
kernel, which runs the same loop per channel, can be held to it tightly.
The reference's plain version is an associative scan; the two agree to
float32 rounding (``tests/test_torch_lru_scan.py``).
"""
from __future__ import annotations

import torch


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b [B, S, W] -> h [B, S, W] in the dtype of ``a``."""
    if a.shape != b.shape or a.dim() != 3:
        raise ValueError(f"need a, b [B, S, W] of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    af, bf = a.float(), b.float()
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    h = torch.zeros_like(af[:, 0])
    for t in range(a.shape[1]):
        h = torch.addcmul(bf[:, t], af[:, t], h)
        out[:, t] = h
    return out.to(a.dtype)
