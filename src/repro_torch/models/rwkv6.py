"""RWKV-6 "Finch" (arXiv:2404.05892): data-dependent-decay linear attention.

The port of the reference's ``models/rwkv6.py``.  Time-mix recurrence per
head (state S ∈ R^{dk×dv}):
    out_t = r_t · (S_{t-1} + (u ⊙ k_t) v_tᵀ)
    S_t   = diag(w_t) S_{t-1} + k_t v_tᵀ ,   w_t = exp(-exp(w0 + lora(x_t)))
Token-shift (ddlerp) mixes x_t with x_{t-1} before every projection.

Train/prefill runs the exact recurrence step by step over time in float32
(``_wkv_scan``, the reference's ``lax.scan``); ``perf_options
("rwkv_chunked")`` takes the chunk-parallel form (``_wkv_chunked``).  The
reference has no kernel for either: both stay plain PyTorch.  On meta
tensors (the dry-run) their step and chunk loops are trip-counted
(``launch/op_analysis.py``).  Decode carries (S, x_prev) — O(1) state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import perf_options
from repro_torch.launch.op_analysis import stack_trips, trips
from repro_torch.models.common import dense_init, normal, param

HEAD_SIZE = 64
LORA = 32


def _n_heads(cfg):
    return cfg.d_model // HEAD_SIZE


class RWKVTimeMix(nn.Module):
    def __init__(self, cfg, generator, device):
        super().__init__()
        d, dt = cfg.d_model, cfg.param_dtype

        def dense(i, o):
            return dense_init(i, o, generator, device, dt)

        self.mix_base = param(torch.full((5, d), 0.5, dtype=dt,
                                         device=device))  # r,k,v,w,g lerp
        self.w_r = dense(d, d)
        self.w_k = dense(d, d)
        self.w_v = dense(d, d)
        self.w_g = dense(d, d)
        w0 = normal((d,), generator, device, torch.float32, 0.3)
        self.w0 = param(w0.detach() - 6.0)                 # float32
        self.w_lora_a = dense(d, LORA)
        self.w_lora_b = dense(LORA, d)
        self.u = normal((d,), generator, device, torch.float32, 0.3)
        self.gn_scale = param(torch.ones(d, dtype=dt, device=device))
        self.w_o = dense(d, d)


class RWKVChannelMix(nn.Module):
    def __init__(self, cfg, generator, device):
        super().__init__()
        d, dt = cfg.d_model, cfg.param_dtype
        self.mix_base = param(torch.full((2, d), 0.5, dtype=dt,
                                         device=device))
        self.w_k = dense_init(d, cfg.d_ff, generator, device, dt)
        self.w_v = dense_init(cfg.d_ff, d, generator, device, dt)
        self.w_r = dense_init(d, d, generator, device, dt)


def _shift(x, prev=None):
    """x_{t-1} along seq; ``prev`` [B,1,d] carries across decode steps."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _outer(a, b):
    """[..., K] x [..., V] -> [..., K, V], each element one product."""
    return a[..., :, None] * b[..., None, :]


def _wkv_scan(r, k, v, w, u, s0):
    """Exact recurrence.  r,k,v,w: [B,S,H,D]; u [H,D]; s0 [B,H,D,D].

    Step by step as the reference's scan, with the terms that do not
    depend on the state taken out of the loop: out_t = r_t S_{t-1} +
    (r_t · (u ⊙ k_t)) v_t, and every k_t v_tᵀ formed at once, so each step
    is two launches (a product and a multiply-add).  The steps' slices come
    from ``unbind``, whose backward is one stack, where indexing step by
    step would write a zero-filled [B,S,H,D,D] gradient for each step."""
    kv = _outer(k, v)                                   # [B,S,H,D,D]
    bonus = (r * u[None, None] * k).sum(-1, keepdim=True) * v
    s = s0
    outs = []
    if r.is_meta:   # step slices one trip at a time (unbind makes all S)
        steps = ((r[:, t], kv[:, t], w[:, t])
                 for t in trips(r.shape[1], r, "wkv"))
    else:
        steps = zip(r.unbind(1), kv.unbind(1), w.unbind(1))
    for rt, kvt, wt in steps:
        outs.append((rt[:, :, None, :] @ s)[:, :, 0])
        s = torch.addcmul(kvt, s, wt[..., None])
    return stack_trips(outs, r.shape[1], dim=1) + bonus, s


def _wkv_chunked(r, k, v, w, u, s0, chunk: int = 16):
    """Chunk-parallel WKV: O(S/C) sequential steps of C×C / C×D products
    instead of S outer-product steps.

    Within a chunk (cs = inclusive cumsum of log w):
        A[t,s]   = Σ_d r_t[d] k_s[d] exp(cs_{t-1}[d] - cs_s[d])   (s < t)
        out_t    = (r_t ⊙ exp(cs_{t-1})) @ S_in  +  Σ_{s<t} A[t,s] v_s
                   + (r_t · (u ⊙ k_t)) v_t
        S_out    = diag(exp(cs_C)) S_in + Σ_s (k_s ⊙ exp(cs_C - cs_s)) v_sᵀ
    Every exponent is ≤ 0 (decays ≤ 1), so the chunked form is
    overflow-safe without rescaling tricks.
    """
    b, S, h, d = r.shape
    c = min(chunk, S)
    assert S % c == 0, (S, c)
    nc = S // c

    def blk(t):
        return t.reshape(b, nc, c, h, d).permute(1, 0, 3, 2, 4)  # [nc,b,h,c,d]

    rb, kb, vb, wb = blk(r), blk(k), blk(v), blk(w)
    lw = torch.log(torch.clamp(wb, min=1e-38))
    cs = torch.cumsum(lw, dim=3)                      # inclusive [nc,b,h,c,d]
    cs_prev = cs - lw                                 # exclusive
    cs_end = cs[:, :, :, -1:, :]

    q1 = rb * torch.exp(cs_prev)                      # decay-to-chunk-start q
    k_end = kb * torch.exp(cs_end - cs)               # decay-to-chunk-end k
    # intra-chunk attention matrix, strictly causal
    diff = cs_prev[:, :, :, :, None, :] - cs[:, :, :, None, :, :]  # [.,c,c,d]
    mask = (torch.arange(c, device=r.device)[:, None]
            > torch.arange(c, device=r.device)[None, :])
    a = torch.einsum("nbhtd,nbhsd,nbhtsd->nbhts", rb, kb, torch.exp(
        torch.where(mask[None, None, None, ..., None], diff,
                    torch.tensor(-torch.inf, device=r.device))))
    bonus = torch.einsum("nbhtd,nbhtd->nbht", rb, u[None, None, :, None, :] * kb)

    s_carry = s0
    outs = []
    for i in trips(nc, r, "wkv"):
        inter = torch.einsum("bhtd,bhdv->bhtv", q1[i], s_carry)
        intra = torch.einsum("bhts,bhsv->bhtv", a[i], vb[i])
        outs.append(inter + intra + bonus[i][..., None] * vb[i])
        decay = torch.exp(cs_end[i][:, :, 0, :, None])           # [b,h,d,1]
        s_carry = s_carry * decay \
            + torch.einsum("bhsd,bhsv->bhdv", k_end[i], vb[i])
    out = stack_trips(outs, nc).permute(1, 0, 3, 2, 4).reshape(b, S, h, d)
    return out, s_carry


def rwkv_tmix(x, p: RWKVTimeMix, cfg, state=None):
    """x [B,S,d] -> (out, {"s": S_state [B,H,D,D] fp32, "x_prev": [B,1,d]})."""
    b, s, d = x.shape
    h = _n_heads(cfg)
    cd = cfg.compute_dtype
    xp = _shift(x, None if state is None else state["x_prev"])
    mix = p.mix_base.to(cd)
    xr, xk, xv, xw, xg = [x * mix[i] + xp * (1 - mix[i]) for i in range(5)]

    r = (xr @ p.w_r.to(cd)).reshape(b, s, h, HEAD_SIZE)
    k = (xk @ p.w_k.to(cd)).reshape(b, s, h, HEAD_SIZE)
    v = (xv @ p.w_v.to(cd)).reshape(b, s, h, HEAD_SIZE)
    g = F.silu(xg @ p.w_g.to(cd))
    dd = p.w0 + ((xw @ p.w_lora_a.to(cd)).float() @ p.w_lora_b.float())
    w = torch.exp(-torch.exp(dd)).reshape(b, s, h, HEAD_SIZE)  # decay in (0,1)
    u = p.u.reshape(h, HEAD_SIZE)

    s0 = (torch.zeros((b, h, HEAD_SIZE, HEAD_SIZE), dtype=torch.float32,
                      device=x.device) if state is None else state["s"])
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    if perf_options.enabled("rwkv_chunked") and state is None and s % 16 == 0:
        out, s_last = _wkv_chunked(rf, kf, vf, wf, u, s0)
    else:
        out, s_last = _wkv_scan(rf, kf, vf, wf, u, s0)
    out = out.reshape(b, s, d).to(cd)
    # group-norm per head (RWKV's ln_x), folded to a simple RMS over head dim
    og = out.reshape(b, s, h, HEAD_SIZE).float()
    og = og * torch.rsqrt(torch.mean(og * og, dim=-1, keepdim=True) + 1e-5)
    out = (og.reshape(b, s, d) * p.gn_scale.float()).to(cd)
    out = (out * g) @ p.w_o.to(cd)
    return out, {"s": s_last, "x_prev": x[:, -1:]}


def rwkv_cmix(x, p: RWKVChannelMix, cfg, state=None):
    cd = cfg.compute_dtype
    xp = _shift(x, None if state is None else state["x_prev"])
    mix = p.mix_base.to(cd)
    xk = x * mix[0] + xp * (1 - mix[0])
    xr = x * mix[1] + xp * (1 - mix[1])
    kk = torch.square(torch.relu(xk @ p.w_k.to(cd)))
    out = torch.sigmoid(xr @ p.w_r.to(cd)) * (kk @ p.w_v.to(cd))
    return out, {"x_prev": x[:, -1:]}


def init_rwkv_cache(cfg, batch: int, device):
    h = _n_heads(cfg)
    zeros = {"dtype": cfg.compute_dtype, "device": device}
    return {
        "tmix": {"s": torch.zeros((batch, h, HEAD_SIZE, HEAD_SIZE),
                                  dtype=torch.float32, device=device),
                 "x_prev": torch.zeros((batch, 1, cfg.d_model), **zeros)},
        "cmix": {"x_prev": torch.zeros((batch, 1, cfg.d_model), **zeros)},
    }
