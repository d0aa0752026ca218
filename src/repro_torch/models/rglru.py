"""RecurrentGemma recurrent block: conv1d + RG-LRU (Griffin, arXiv:2402.19427).

RG-LRU:  r_t = σ(W_a x_t + b_a)      (recurrence gate)
         i_t = σ(W_x x_t + b_x)      (input gate)
         log a_t = -c · softplus(Λ) · r_t          (c = 8)
         h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Prefill runs the diagonal recurrence through ``kernels.lru_scan.ops``:
the hand-written CUDA kernel on a CUDA tensor, its plain loop on a CPU
tensor.  Decode is a single fused step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.lru_scan.ops import lru_scan
from repro_torch.models.common import dense_init, normal, param

_C = 8.0


class RGLRU(nn.Module):
    def __init__(self, cfg, generator, device):
        super().__init__()
        d = cfg.d_model
        w = cfg.lru_width or d
        dt = cfg.param_dtype
        self.w_x = dense_init(d, w, generator, device, dt)
        self.w_gate_branch = dense_init(d, w, generator, device, dt)
        self.conv_w = normal((cfg.conv_width, w), generator, device, dt,
                             1.0 / math.sqrt(cfg.conv_width))
        self.conv_b = param(torch.zeros(w, dtype=dt, device=device))
        self.w_a = dense_init(w, w, generator, device, dt)
        self.b_a = param(torch.zeros(w, dtype=dt, device=device))
        self.w_i = dense_init(w, w, generator, device, dt)
        self.b_i = param(torch.zeros(w, dtype=dt, device=device))
        # Λ init so that a ∈ [0.9, 0.999] at r=1 (Griffin appendix)
        a = torch.linspace(0.9, 0.999, w, dtype=torch.float32, device=device)
        self.lam = param(torch.log(torch.expm1(-torch.log(a) / _C)))
        self.w_o = dense_init(w, d, generator, device, dt)


def _causal_conv(x, w, b, state=None):
    """x [B,S,W]; depthwise causal conv of width K.  state [B,K-1,W]."""
    k = w.shape[0]
    pad = torch.zeros_like(x[:, : k - 1]) if state is None else state
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    new_state = xp[:, x.shape[1]:]
    return out + b, new_state


def _gates(xc, p: RGLRU, cfg):
    """(a, gated x), both float32 whatever the compute dtype."""
    cd = cfg.compute_dtype
    r = torch.sigmoid(xc @ p.w_a.to(cd) + p.b_a.to(cd))
    i = torch.sigmoid(xc @ p.w_i.to(cd) + p.b_i.to(cd))
    log_a = (-_C * F.softplus(p.lam)).float() * r.float()
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-12)) * (i * xc).float()
    return a, gated_x


def rglru_forward(x, p: RGLRU, cfg):
    """x [B,S,d] -> (out [B,S,d], (h_last [B,W], conv_state)).

    The recurrence always goes through ``ops.lru_scan``, so the tensors'
    device picks kernel or plain version.  The reference's ``use_kernel``
    switch chose between its TPU kernel and an associative scan; PyTorch has
    no counterpart of that scan, so here the kernel is the scan."""
    cd = cfg.compute_dtype
    gate = F.gelu(x @ p.w_gate_branch.to(cd), approximate="tanh")
    xr = x @ p.w_x.to(cd)
    xc, conv_state = _causal_conv(xr, p.conv_w.to(cd), p.conv_b.to(cd))
    a, gx = _gates(xc, p, cfg)
    h = lru_scan(a, gx).to(cd)
    out = (h * gate) @ p.w_o.to(cd)
    return out, (h[:, -1].float(), conv_state)


def init_rglru_cache(cfg, batch: int, device):
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                            dtype=cfg.compute_dtype, device=device),
    }


def rglru_decode(x, p: RGLRU, cfg, cache):
    """x [B,1,d] -> (out [B,1,d], new_cache).  O(1) per token."""
    cd = cfg.compute_dtype
    gate = F.gelu(x @ p.w_gate_branch.to(cd), approximate="tanh")
    xr = x @ p.w_x.to(cd)
    xc, conv_state = _causal_conv(xr, p.conv_w.to(cd), p.conv_b.to(cd),
                                  state=cache["conv"])
    a, gx = _gates(xc, p, cfg)
    h = a[:, 0] * cache["h"] + gx[:, 0]
    out = (h[:, None].to(cd) * gate) @ p.w_o.to(cd)
    return out, {"h": h, "conv": conv_state}
