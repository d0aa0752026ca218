"""Plain PyTorch blocked streaming attention (online softmax) — the port's
copy of the reference's ``flash_attention/ref.py`` with its perf options
off: block math in float32, float32 softmax statistics.

Never materializes the [Sq, Skv] score matrix: an outer loop over query
blocks, an inner loop over kv blocks with running (max, denom, acc).
Supports causal / local-window / full (encoder) masks and GQA; like the
reference it visits every kv block (the kernel skips those outside the
band).  ``block_q``/``block_k`` shape only this version.  On meta tensors
(the dry-run) the block-pair loops are trip-counted
(``launch/op_analysis.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.launch.op_analysis import trips

NEG_INF = -2.0e38


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    block_q: int = 512, block_k: int = 512):
    """q [B,Sq,H,D], k [B,Skv,Hkv,D], v [B,Skv,Hkv,Dv] -> [B,Sq,H,Dv].

    ``window``: only attend to keys with 0 <= q_pos - k_pos < window
    (implies causal).  Query/key positions are aligned at 0.
    """
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[3]
    g = h // hkv
    in_dtype = q.dtype
    scale = 1.0 / math.sqrt(d)
    bq = min(block_q, sq)
    bk = min(block_k, skv)
    pad_q = (-sq) % bq
    pad_k = (-skv) % bk
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = q.shape[1] // bq, k.shape[1] // bk
    dev = q.device

    qb = (q.float() * scale).reshape(b, nq, bq, hkv, g, d)
    kb = k.float().reshape(b, nk, bk, hkv, d)
    vb = v.float().reshape(b, nk, bk, hkv, dv)
    out = torch.empty((b, nq, bq, hkv, g, dv), dtype=torch.float32,
                      device=dev)
    for qi in trips(nq, q, "flash_attention"):
        qblk = qb[:, qi]
        m = torch.full((b, bq, hkv, g), NEG_INF, dtype=torch.float32,
                       device=dev)
        lse = torch.zeros((b, bq, hkv, g), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, bq, hkv, g, dv), dtype=torch.float32,
                          device=dev)
        qpos = qi * bq + torch.arange(bq, device=dev)
        for ki in trips(nk, q, "flash_attention"):
            s = torch.einsum("bqhgd,bkhd->bqhgk", qblk, kb[:, ki])
            kpos = ki * bk + torch.arange(bk, device=dev)
            valid = (kpos < skv)[None, :]          # mask key padding
            if causal or window is not None:
                delta = qpos[:, None] - kpos[None, :]
                ok = delta >= 0
                if window is not None:
                    ok &= delta < window
                valid = valid & ok
            s = torch.where(valid[None, :, None, None, :], s,
                            torch.tensor(NEG_INF, device=dev))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lse = lse * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] \
                + torch.einsum("bqhgk,bkhd->bqhgd", p, vb[:, ki])
            m = m_new
        out[:, qi] = acc / torch.clamp(lse[..., None], min=1e-30)
    out = out.reshape(b, nq * bq, h, dv)[:, :sq]
    return out.to(in_dtype)
