"""GQA/MQA attention: full-causal, blocked-local (sub-quadratic) and encoder
modes, with a ring-buffer KV cache for decode.

Weights keep the reference's explicit heads axis (``wq [d, H, Dh]``,
``wo [H, Dh, d]``).  At ``S >= FLASH_MIN_SEQ`` the prefill goes through
``kernels.flash_attention.ops`` (the hand-written CUDA kernel on a CUDA
tensor, its plain blocked version on a CPU tensor); shorter sequences and
decode use plain torch ops, as the reference does.  The reference's
activation-sharding constraints are no-ops on one card and are not ported.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import apply_rope, normal

NEG_INF = -2.0e38
FLASH_MIN_SEQ = 1024  # below this the blocked path buys nothing


class Attention(nn.Module):
    def __init__(self, cfg, generator, device):
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = cfg.param_dtype
        s = 1.0 / math.sqrt(d)
        self.wq = normal((d, h, dh), generator, device, dt, s)
        self.wk = normal((d, hkv, dh), generator, device, dt, s)
        self.wv = normal((d, hkv, dh), generator, device, dt, s)
        self.wo = normal((h, dh, d), generator, device, dt, s)


def _qkv(x, p: Attention, cfg, positions):
    cd = cfg.compute_dtype
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(cd))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg):
    """q [B,Sq,H,D], k/v [B,Sk,Hkv,D], mask broadcastable [B,1,1,Sq,Sk]."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q = q.reshape(b, sq, hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k) / math.sqrt(dh)
    scores = torch.where(mask, scores.float(),
                         torch.tensor(NEG_INF, device=q.device))
    w = torch.softmax(scores, dim=-1).to(cfg.compute_dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(b, sq, h, dh)


def attention_forward(x, p: Attention, cfg, mode: str):
    """Training/prefill forward.  mode: attn | local | enc.

    Returns (out, (k, v)) — the kv tensors double as the prefill cache.
    """
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(x, p, cfg, positions)
    if s >= FLASH_MIN_SEQ:
        out = flash_attention(
            q, k, v, causal=(mode != "enc"),
            window=cfg.local_window if mode == "local" else None)
    elif mode == "local":
        out = _local_attention(q, k, v, cfg)
    else:
        if mode == "enc":
            mask = torch.ones((1, 1, 1, s, s), dtype=torch.bool,
                              device=x.device)
        else:
            mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                         device=x.device))[None, None, None]
        out = _sdpa(q, k, v, mask, cfg)
    out = torch.einsum("bshk,hkd->bsd", out, p.wo.to(cfg.compute_dtype))
    return out, (k, v)


def _local_attention(q, k, v, cfg):
    """Blocked sliding-window attention: chunk W attends to [prev|self] 2W.

    O(S·W) — this is what makes the hybrid archs sub-quadratic at 32k/500k.
    """
    w = cfg.local_window
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    dev = q.device
    if s <= w:  # degenerate: plain causal
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=dev))[None, None, None]
        return _sdpa(q, k, v, mask, cfg)
    if s % w:  # pad tail; causal masking keeps pad keys invisible
        pad = w - s % w
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
        return _local_attention(q, k, v, cfg)[:, :s]
    nc = s // w
    qc = q.reshape(b, nc, w, h, dh)
    kc = k.reshape(b, nc, w, hkv, dh)
    vc = v.reshape(b, nc, w, hkv, dh)
    kprev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    k2 = torch.cat([kprev, kc], dim=2)                 # [b,nc,2w,hkv,dh]
    v2 = torch.cat([vprev, vc], dim=2)
    g = h // hkv
    qc = qc.reshape(b, nc, w, hkv, g, dh)
    scores = torch.einsum("bnqhgd,bnkhd->bnhgqk", qc, k2) / math.sqrt(dh)
    qpos = torch.arange(w, device=dev)[:, None] + w    # within-window absolute
    kpos = torch.arange(2 * w, device=dev)[None, :]
    valid = (kpos <= qpos) & (qpos - kpos < w)
    first = torch.arange(2 * w, device=dev)[None, :] >= w  # chunk 0: no prev
    mask = torch.where(torch.arange(nc, device=dev)[:, None, None] == 0,
                       valid & first, valid)
    scores = torch.where(mask[None, :, None, None], scores.float(),
                         torch.tensor(NEG_INF, device=dev))
    attn = torch.softmax(scores, dim=-1).to(cfg.compute_dtype)
    out = torch.einsum("bnhgqk,bnkhd->bnqhgd", attn, v2)
    return out.reshape(b, s, h, dh)


# --- decode ------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, length: int, mode: str, device):
    """Ring buffer for ``local`` (window-sized), full buffer otherwise."""
    size = min(length, cfg.local_window) if mode == "local" else length
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "pos": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def attention_decode(x, p: Attention, cfg, cache, pos: int, mode: str):
    """x [B,1,d]; pos a Python int.  Returns (out [B,1,d], cache).

    The cache is updated in place (one slot of the ring buffer), where the
    reference returns a new one: it saves a copy of the whole buffer per
    token."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(x, p, cfg, positions)
    size = cache["k"].shape[1]
    slot = pos % size
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos"][slot] = pos
    cpos = cache["pos"]
    valid = (cpos >= 0) & (cpos <= pos)
    if mode == "local":
        valid &= (pos - cpos) < cfg.local_window
    mask = valid[None, None, None, None, :]
    out = _sdpa(q, cache["k"], cache["v"], mask, cfg)
    out = torch.einsum("bshk,hkd->bsd", out, p.wo.to(cfg.compute_dtype))
    return out, cache
