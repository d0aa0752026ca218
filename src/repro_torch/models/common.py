"""Shared building blocks of the language models (PyTorch port).

The math lives in plain functions on tensors, as in the reference's
``models/common.py``; parameters live in ``nn.Module``s that keep the
reference's names and layouts (``w_gate [d, d_ff]``, ``table [V, d]``), so a
reference parameter tree converts one to one (``models/convert.py``).
Casts follow the reference's order, so bf16 rounds at the same places.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def param(tensor: torch.Tensor) -> nn.Parameter:
    # inference only: the port has no backward kernels yet (ROADMAP Q9b)
    return nn.Parameter(tensor, requires_grad=False)


def normal(shape, generator: torch.Generator, device, dtype,
           scale: float) -> nn.Parameter:
    """N(0, scale²) drawn in float32 on ``device``, then cast — the
    reference's ``(normal(key, shape, f32) * s).astype(dtype)``."""
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return param((x * scale).to(dtype))


def dense_init(in_dim: int, out_dim: int, generator, device, dtype,
               scale: Optional[float] = None) -> nn.Parameter:
    s = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return normal((in_dim, out_dim), generator, device, dtype, s)


def rmsnorm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if weight is not None:
        x = x * weight.float()
    return x.to(dt)


def layernorm(x, weight=None, bias=None, eps: float = 1e-5):
    """LayerNorm; weight/bias None -> the non-parametric LN of OLMo."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        x = x * weight.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dt)


class Norm(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        if cfg.norm != "nonparam_ln":
            self.scale = param(torch.ones(cfg.d_model, dtype=cfg.param_dtype,
                                          device=device))
        if cfg.norm == "layernorm":
            self.bias = param(torch.zeros(cfg.d_model, dtype=cfg.param_dtype,
                                          device=device))


def apply_norm(x, p: Norm, cfg):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p.scale)
    if cfg.norm == "layernorm":
        return layernorm(x, p.scale, getattr(p, "bias", None))
    if cfg.norm == "nonparam_ln":
        return layernorm(x, None, None)
    raise ValueError(cfg.norm)


# --- rotary embeddings ------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float):
    """x [..., S, H, D]; positions [..., S] (broadcastable)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                        # [D/2]
    ang = positions[..., :, None, None].float() * freqs           # [...,S,1,D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- MLPs --------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg, d_ff: int, generator, device):
        super().__init__()
        d, dt = cfg.d_model, cfg.param_dtype
        if cfg.activation in ("swiglu", "geglu"):
            self.w_gate = dense_init(d, d_ff, generator, device, dt)
        self.w_up = dense_init(d, d_ff, generator, device, dt)
        self.w_down = dense_init(d_ff, d, generator, device, dt)


def apply_mlp(x, p: MLP, cfg):
    if cfg.activation == "swiglu":
        h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    elif cfg.activation == "geglu":
        h = F.gelu(x @ p.w_gate, approximate="tanh") * (x @ p.w_up)
    elif cfg.activation == "gelu":
        h = F.gelu(x @ p.w_up, approximate="tanh")
    else:
        raise ValueError(cfg.activation)
    return h @ p.w_down


# --- embeddings / head -------------------------------------------------------

class Embed(nn.Module):
    def __init__(self, cfg, generator, device):
        super().__init__()
        self.table = normal((cfg.vocab_size, cfg.d_model), generator, device,
                            cfg.param_dtype, 0.02)


def embed_tokens(tokens, p: Embed, cfg):
    x = p.table[tokens].to(cfg.compute_dtype)
    if cfg.embed_scale:
        # sqrt(d_model) rounded to the compute dtype first, as the
        # reference does: in bf16, sqrt(2560) = 50.596 becomes 50.5
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.compute_dtype,
                             device=x.device)
    return x


def lm_logits(x, embed_p: Optional[Embed], head_p, cfg):
    """Logits in float32.  The tied product runs in the compute dtype, then
    the softcap in float32 — in place on the float32 copy, which at the
    published vocab is the largest tensor of a prefill."""
    if cfg.tie_embeddings:
        logits = x @ embed_p.table.to(cfg.compute_dtype).T
    else:
        logits = x @ head_p.w_out
    logits = logits.float()
    if cfg.logit_softcap is not None:
        cap = cfg.logit_softcap
        logits.div_(cap).tanh_().mul_(cap)
    return logits
