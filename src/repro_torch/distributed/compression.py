"""Error-feedback int8 gradient compression for the data-parallel
reduction, on the virtual mesh's worker axis.

The port of the reference's ``distributed/compression.py``.  There each
replica runs ``compressed_psum`` inside ``shard_map`` and the collectives
cross devices; here the P workers are a leading axis of every leaf
(``launch/mesh.py``'s virtual mesh), so a ``pmax`` is a max over that axis
and a ``psum`` a sum over it.  Per leaf: one SHARED scale from the max over
workers of |g + e|, so the int8 payloads are commensurable; the int8 values
summed as int32 (exact for <= 2^23 workers); the mean dequantized with the
shared scale; each worker's quantization residual kept for its next step
(error feedback).  ``torch.round`` rounds half to even, as ``jnp.round``
does.  The arithmetic is the reference's as XLA compiles it: the division
of the max by 127 is a multiplication by the float32 reciprocal of 127, and
the residual ``g + e - q * scale`` is one fused multiply-add (rounded once).
So the means and residuals are the reference's bit for bit
(``tests/test_torch_dp.py``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

#: 1/127 rounded to float32: XLA divides by the constant 127 this way
INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()
#: elements a residual is computed over at once (its float64 temporaries)
_CHUNK = 1 << 25


def quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 values and the float32 scale max|g| / 127 of one leaf."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(grads: Dict[str, torch.Tensor]) -> Dict:
    """Zero float32 residuals shaped like ``grads`` (per worker when the
    leaves carry the worker axis, as ``train/dp_trainer.py``'s do)."""
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}


def _fused_residual(gf: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor, out: torch.Tensor) -> None:
    """``out = gf - q * scale`` rounded once to float32, as a fused
    multiply-add rounds it: an int8 times a float32 is exact in float64, and
    so is its difference with a float32 within the scale of it, so one
    float64 subtraction and one cast give the fma's bits.  In chunks, so the
    float64 temporaries stay small at any leaf size."""
    g, qq, o = gf.reshape(-1), q.reshape(-1), out.view(-1)
    s = scale.double()
    for i in range(0, g.numel(), _CHUNK):
        j = slice(i, i + _CHUNK)
        o[j] = (g[j].double() - qq[j].double() * s).float()


def compressed_psum(grads: Dict[str, torch.Tensor],
                    error: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """The mean over workers of int8-quantized ``grads + error``.

    ``grads`` and ``error`` hold ``[P, ...]`` leaves, worker ``w``'s
    gradient and residual at index ``w``.  Returns ``(mean, error)``:
    float32 ``[...]`` means and the ``[P, ...]`` residuals, written into
    ``error``'s tensors in place (the reference returns new ones; at
    recurrentgemma-2b's width a second set would cost a float32 copy of
    every gradient per worker)."""
    mean = {}
    for name, g in grads.items():
        n = g.shape[0]
        gf = g.float() + error[name]
        lo, hi = torch.aminmax(gf)
        shared = torch.clamp(torch.maximum(-lo, hi) * INV_127, min=1e-30)
        q = torch.round(gf / shared).clamp_(-127, 127).to(torch.int8)
        _fused_residual(gf, q, shared, error[name])
        del gf
        qsum = q.sum(dim=0, dtype=torch.int32)
        mean[name] = qsum.float() * shared / n
    return mean, error
