"""Mixture-of-Experts layer (DeepSeekMoE style: shared + fine-grained routed).

The port of the reference's ``models/moe.py``.  A float32 router picks each
token's top-k experts (ties to the lowest expert id, as ``jax.lax.top_k``
breaks them; ``torch.topk`` promises no order, so the port sorts stably)
with renormalised gates; the Switch auxiliary loss is returned beside the
output.  Dispatch is capacity-based with sort-derived positions (no [T, E]
one-hot): a stable argsort of the assignments by expert and searchsorted
ranks give each assignment its slot; ranks past the capacity go to a drop
slot (``cap``) that is cut away.  Tokens scatter into an [E, C, d] buffer,
the experts run as one stacked einsum, and results gather back with the
gates.

Two calls on the card give the same bits: every kept slot is written once
(the drop slot alone collects several writes, and is discarded), each
token sums its k contributions in a fixed order, and the auxiliary loss's
expert counts are integer sums (``index_add_`` of ones into int64 bins,
exact in any order; ``bincount`` would do, but it has no meta kernel, and
the dry-run walks the model on the meta device), never float atomics.

``perf_options("moe_shardmap")`` inside ``perf_options.virtual_grid(data,
model)`` takes the reference's expert-parallel path over a virtual
(data x model) grid on one device: each data shard routes its own tokens
with a per-shard capacity, each model rank runs its slice of the experts on
the assignments routed to it, and the combine is a sum over the model
ranks; the aux loss averages the shards' ``me``/``ce`` before the product.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import perf_options
from repro_torch.models.common import normal, param


class SharedExperts(nn.Module):
    def __init__(self, cfg, generator, device):
        super().__init__()
        d, fs, dt = cfg.d_model, cfg.moe_d_ff * cfg.n_shared_experts, \
            cfg.param_dtype
        self.w_gate = normal((d, fs), generator, device, dt, 1 / math.sqrt(d))
        self.w_up = normal((d, fs), generator, device, dt, 1 / math.sqrt(d))
        self.w_down = normal((fs, d), generator, device, dt,
                             1 / math.sqrt(fs))


class MoE(nn.Module):
    def __init__(self, cfg, generator, device):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        dt = cfg.param_dtype
        # drawn in the parameter dtype, then kept in float32 (the reference's
        # ``w(...).astype(float32)``)
        self.router = param(normal((d, e), generator, device, dt,
                                   1 / math.sqrt(d)).detach().float())
        self.w_gate = normal((e, d, f), generator, device, dt,
                             1 / math.sqrt(d))
        self.w_up = normal((e, d, f), generator, device, dt, 1 / math.sqrt(d))
        self.w_down = normal((e, f, d), generator, device, dt,
                             1 / math.sqrt(f))
        self.shared = (SharedExperts(cfg, generator, device)
                       if cfg.n_shared_experts else None)


def route(xt, router, k: int):
    """Float32 router over tokens ``xt`` [T, d]: (probs [T, E], gates
    [T, k] renormalised, expert ids [T, k]) with ties to the lowest id."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :k], idx[:, :k]
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), gate_idx


def load_stats(probs, gate_idx, e: int):
    """The Switch loss's (me, ce): mean router probability per expert, and
    the share of the T*k assignments each expert received (counted as
    integers)."""
    t, k = gate_idx.shape
    idx = gate_idx.reshape(-1)
    counts = torch.zeros(e, dtype=torch.int64, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx))
    return probs.mean(dim=0), counts.float() * (1.0 / (t * k))


def slots(flat_e, cap: int):
    """Each assignment's rank within its expert (assignment order: token,
    then its k choices), whether it is kept (rank < ``cap``) and its slot
    (the rank, or the drop slot ``cap``)."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(n, device=flat_e.device) - start
    keep = rank < cap
    return rank, keep, torch.where(keep, rank, cap)


def _experts(buf, wg, wu, wd, cd):
    h = (F.silu(torch.einsum("ecd,edf->ecf", buf, wg.to(cd)))
         * torch.einsum("ecd,edf->ecf", buf, wu.to(cd)))
    return torch.einsum("ecf,efd->ecd", h, wd.to(cd))


def _combine(gathered, w, t: int, k: int):
    """Each token's k weighted contributions summed left to right."""
    c = (gathered * w[:, None]).view(t, k, -1)
    yt = c[:, 0]
    for j in range(1, k):
        yt = yt + c[:, j]
    return yt


def _routed(xt, gate_vals, gate_idx, cap: int, wg, wu, wd, cd, lo: int = 0):
    """The routed experts' output [T, d] over the experts [lo, lo + E_loc)
    that ``wg``/``wu``/``wd`` hold; assignments to other experts add 0."""
    t, k = gate_idx.shape
    e_loc = wg.shape[0]
    flat_e = gate_idx.reshape(-1)
    _, keep, pos = slots(flat_e, cap)
    mine = (flat_e >= lo) & (flat_e < lo + e_loc)
    keep = keep & mine
    pos = torch.where(keep, pos, cap)
    loc_e = torch.where(mine, flat_e - lo, 0)
    token_of = torch.arange(t, device=xt.device).repeat_interleave(k)
    buf = torch.zeros((e_loc, cap + 1, xt.shape[1]), dtype=cd,
                      device=xt.device)
    buf = buf.index_put((loc_e, pos), xt[token_of].to(cd))[:, :cap]
    y_e = _experts(buf, wg, wu, wd, cd)                        # [E,C,d]
    w = torch.where(keep, gate_vals.reshape(-1), 0.0).to(cd)
    gathered = y_e[loc_e, pos.clamp(max=cap - 1)]              # [T*k,d]
    return _combine(gathered, w, t, k)


def _shared(xt, sp: SharedExperts, cd):
    hs = F.silu(xt @ sp.w_gate.to(cd)) * (xt @ sp.w_up.to(cd))
    return hs @ sp.w_down.to(cd)


def apply_moe(x, p: MoE, cfg):
    """x [B,S,d] -> (y [B,S,d], aux_loss float32 scalar)."""
    grid = perf_options.grid()
    if perf_options.enabled("moe_shardmap") and grid is not None:
        return _apply_moe_grid(x, p, cfg, *grid)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    cd = cfg.compute_dtype
    t = b * s
    xt = x.reshape(t, d)
    probs, gate_vals, gate_idx = route(xt, p.router, k)
    me, ce = load_stats(probs, gate_idx, e)
    aux = e * torch.sum(me * ce)        # Switch: E * sum_e f_e * p_e
    cap = int(math.ceil(t * k / e * cfg.capacity_factor))
    yt = _routed(xt, gate_vals, gate_idx, cap, p.w_gate, p.w_up, p.w_down,
                 cd)
    if p.shared is not None:
        yt = yt + _shared(xt, p.shared, cd)
    return yt.reshape(b, s, d), aux


def _apply_moe_grid(x, p: MoE, cfg, data: int, model: int):
    """The expert-parallel MoE over a virtual (data x model) grid: tokens in
    ``data`` contiguous shards, experts in ``model`` contiguous slices (one
    slice when ``model`` does not divide E, as the reference falls back)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.moe_top_k
    cd = cfg.compute_dtype
    tp = model if e % model == 0 else 1
    e_loc = e // tp
    if t % data:
        raise ValueError(f"{t} tokens do not split into {data} data shards")
    t_loc = t // data
    cap = int(math.ceil(t_loc * k / e * cfg.capacity_factor))
    xt = x.reshape(t, d)
    routed, mes, ces = [], [], []
    for shard in xt.split(t_loc):
        probs, gate_vals, gate_idx = route(shard, p.router, k)
        me, ce = load_stats(probs, gate_idx, e)
        mes.append(me)
        ces.append(ce)
        yt = None
        for r in range(tp):          # the combine: a sum over model ranks
            sl = slice(r * e_loc, (r + 1) * e_loc)
            part = _routed(shard, gate_vals, gate_idx, cap, p.w_gate[sl],
                           p.w_up[sl], p.w_down[sl], cd, lo=r * e_loc)
            yt = part if yt is None else yt + part
        routed.append(yt)
    # average the shards' estimators before the product (the reference's
    # pmean over the data axes)
    me = torch.stack(mes).mean(dim=0)
    ce = torch.stack(ces).mean(dim=0)
    aux = e * torch.sum(me * ce)
    yt = torch.cat(routed)
    if p.shared is not None:
        yt = yt + _shared(xt, p.shared, cd)
    return yt.reshape(b, s, d), aux
