"""Multi-head Latent Attention (DeepSeek-V2), with the compressed KV cache.

The port of the reference's ``models/mla.py``.  Train/prefill: the standard
expansion (q through the q-LoRA, k and v expanded from the latent c_kv plus a
shared RoPE key); at ``S >= FLASH_MIN_SEQ`` it runs ``flash_attention`` on
``[q_nope | q_rope]`` against ``[k_nope | k_rope]`` with v of its own head
dim (``Dv != D``: 192 and 128 at the published widths), below that the
dense masked softmax.  Decode is the *absorbed* form: W_uk folds into the
query and W_uv into the output, so attention runs against the cached latent
(c_kv ‖ k_rope), (kv_lora_rank + qk_rope_head_dim) values a token instead
of 2·H·Dh.  Parameters keep the reference's names and layouts.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.attention import FLASH_MIN_SEQ, NEG_INF
from repro_torch.models.common import apply_rope, normal, param, rmsnorm


class MLA(nn.Module):
    def __init__(self, cfg, generator, device):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        dt = cfg.param_dtype

        def w(shape, fan_in):
            return normal(shape, generator, device, dt, 1.0 / math.sqrt(fan_in))

        self.w_dq = w((d, qr), d)
        self.q_norm = param(torch.ones(qr, dtype=dt, device=device))
        self.w_uq = w((qr, h, dn + dr), qr)
        self.w_dkv = w((d, kvr), d)
        self.kv_norm = param(torch.ones(kvr, dtype=dt, device=device))
        self.w_kr = w((d, dr), d)
        self.w_uk = w((kvr, h, dn), kvr)
        self.w_uv = w((kvr, h, dv), kvr)
        self.wo = w((h, dv, d), h * dv)


def _queries(x, p: MLA, cfg, positions):
    """(q_nope, q_rope with RoPE applied), each [B, S, H, .]."""
    cd = cfg.compute_dtype
    dn = cfg.qk_nope_head_dim
    cq = rmsnorm(x @ p.w_dq.to(cd), p.q_norm)
    q = torch.einsum("bsr,rhk->bshk", cq, p.w_uq.to(cd))
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _latent(x, p: MLA, cfg, positions):
    """(c_kv [B, S, kvr], k_rope [B, S, 1, dr] with RoPE applied)."""
    cd = cfg.compute_dtype
    c_kv = rmsnorm(x @ p.w_dkv.to(cd), p.kv_norm)
    k_rope = apply_rope((x @ p.w_kr.to(cd))[:, :, None, :], positions,
                        cfg.rope_theta)
    return c_kv, k_rope


def mla_forward(x, p: MLA, cfg):
    """Training/prefill.  Returns (out, (c_kv, k_rope)) — the compressed
    cache."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cd = cfg.compute_dtype
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _queries(x, p, cfg, positions)
    c_kv, k_rope = _latent(x, p, cfg, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p.w_uk.to(cd))
    v = torch.einsum("bsr,rhk->bshk", c_kv, p.w_uv.to(cd))

    # fold rope/nope into one head dim (scale 1/sqrt(dn + dr))
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    if s >= FLASH_MIN_SEQ:
        out = flash_attention(q_full, k_full, v, causal=True)
    else:
        scale = 1.0 / math.sqrt(dn + dr)
        scores = torch.einsum("bqhd,bkhd->bhqk", q_full, k_full) * scale
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=x.device))[None, None]
        scores = torch.where(mask, scores.float(),
                             torch.tensor(NEG_INF, device=x.device))
        attn = torch.softmax(scores, dim=-1).to(cd)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    out = torch.einsum("bqhd,hdo->bqo", out, p.wo.to(cd))
    return out, (c_kv, k_rope[:, :, 0, :])


def init_mla_cache(cfg, batch: int, length: int, device):
    return {
        "c_kv": torch.zeros((batch, length, cfg.kv_lora_rank),
                            dtype=cfg.compute_dtype, device=device),
        "k_rope": torch.zeros((batch, length, cfg.qk_rope_head_dim),
                              dtype=cfg.compute_dtype, device=device),
    }


def mla_decode(x, p: MLA, cfg, cache, pos: int):
    """Absorbed-matrix decode against the compressed cache.  x [B,1,d];
    pos a Python int.  Returns (out [B,1,d], cache), the cache updated in
    place (one position), as ``attention_decode`` does."""
    b = x.shape[0]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cd = cfg.compute_dtype
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _queries(x, p, cfg, positions)             # [b,1,h,.]
    # absorb W_uk: q_lat[b,1,h,kvr] = q_nope · W_uk^T
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p.w_uk.to(cd))
    c_new, kr_new = _latent(x, p, cfg, positions)
    cache["c_kv"][:, pos] = c_new[:, 0]
    cache["k_rope"][:, pos] = kr_new[:, 0, 0]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]

    scale = 1.0 / math.sqrt(dn + dr)
    scores = (torch.einsum("bshr,btr->bhst", q_lat, c_kv)
              + torch.einsum("bshr,btr->bhst", q_rope, k_rope)) * scale
    valid = torch.arange(c_kv.shape[1], device=x.device) <= pos
    scores = torch.where(valid[None, None, None], scores.float(),
                         torch.tensor(NEG_INF, device=x.device))
    attn = torch.softmax(scores, dim=-1).to(cd)
    o_lat = torch.einsum("bhst,btr->bshr", attn, c_kv)           # [b,1,h,kvr]
    out = torch.einsum("bshr,rhd->bshd", o_lat, p.w_uv.to(cd))
    out = torch.einsum("bqhd,hdo->bqo", out, p.wo.to(cd))
    return out, cache
