"""Sharding rules as spec trees: the port's counterpart of the reference's
``distributed/sharding.py``, for the dry-run's memory report.

The port runs on one card and shards nothing.  What the dry-run still
reports is how the reference would lay each tensor out on its production
meshes (16x16 ``(data, model)`` and 2x16x16 ``(pod, data, model)``), and so
how many bytes of the parameters, optimizer state, cache and batch one
device of those meshes would hold.  That needs only the reference's rules,
not a mesh:

  * batch -> the dp axes (``("data",)`` or ``("pod", "data")``);
  * heads / d_ff / vocab / experts -> ``"model"`` (TP / EP);
  * weight storage additionally on ``"data"`` (FSDP) when enabled;
  * an axis that does not divide its dimension falls back to replication
    (:func:`sanitize`).

A spec is a plain tuple with one entry per dimension: an axis name, a tuple
of axis names, or ``None`` (the reference's ``PartitionSpec``).
:func:`param_specs` keys the specs by the port's parameter names
(``LM.named_parameters()``), which are the reference's tree paths with the
stacked ``body`` unstacked into layers (``models/convert.py``), so a layer
of the body has the reference's spec without its leading reps axis.
:func:`cache_specs` mirrors ``models.model.init_cache``'s list of layers.
:func:`bytes_per_device` applies a spec tree to a tree of tensors on a mesh
given as a dict of axis sizes.

No counterparts: ``to_shardings`` (there are no ``NamedSharding``\\ s
without JAX), the reference's ``launch/mesh.py::make_production_mesh`` (a
mesh of 256 or 512 TPU devices; one card has none), and
``distributed/act_sharding.py`` (its ``constrain`` is the identity outside
a mesh, and the port's models never call it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import ATTN_MIXERS

Spec = Tuple

#: the reference's production meshes, as axis sizes, with their batch axes
MESHES = {"16x16": ({"data": 16, "model": 16}, ("data",)),
          "2x16x16": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data"))}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    tp: Optional[str] = "model"
    fsdp: Optional[str] = "data"           # None = pure DP replication
    dp: Tuple[str, ...] = ("data",)        # batch axes (pod prepended if multi)
    shard_experts: bool = True


# --- logical spec templates (trailing dims) --------------------------------

def _attn_specs(r: ShardingRules):
    return {"wq": (r.fsdp, r.tp, None), "wk": (r.fsdp, r.tp, None),
            "wv": (r.fsdp, r.tp, None), "wo": (r.tp, None, r.fsdp)}


def _mla_specs(r: ShardingRules):
    return {"w_dq": (r.fsdp, None), "q_norm": (None,),
            "w_uq": (None, r.tp, None),
            "w_dkv": (r.fsdp, None), "kv_norm": (None,),
            "w_kr": (r.fsdp, None),
            "w_uk": (None, r.tp, None), "w_uv": (None, r.tp, None),
            "wo": (r.tp, None, r.fsdp)}


def _mlp_specs(r: ShardingRules, act: str):
    if act in ("swiglu", "geglu"):
        return {"w_gate": (r.fsdp, r.tp), "w_up": (r.fsdp, r.tp),
                "w_down": (r.tp, r.fsdp)}
    return {"w_up": (r.fsdp, r.tp), "w_down": (r.tp, r.fsdp)}


def _moe_specs(r: ShardingRules, cfg: ArchConfig):
    ep = r.tp if r.shard_experts else None
    inner = None if ep else r.tp
    p = {"router": (None, None), "w_gate": (ep, r.fsdp, inner),
         "w_up": (ep, r.fsdp, inner), "w_down": (ep, inner, r.fsdp)}
    if cfg.n_shared_experts:
        p["shared"] = _mlp_specs(r, "swiglu")
    return p


def _rglru_specs(r: ShardingRules):
    return {"w_x": (r.fsdp, r.tp), "w_gate_branch": (r.fsdp, r.tp),
            "conv_w": (None, r.tp), "conv_b": (r.tp,),
            "w_a": (None, r.tp), "b_a": (r.tp,),
            "w_i": (None, r.tp), "b_i": (r.tp,),
            "lam": (r.tp,), "w_o": (r.tp, r.fsdp)}


def _rwkv_tmix_specs(r: ShardingRules):
    return {"mix_base": (None, None),
            "w_r": (r.fsdp, r.tp), "w_k": (r.fsdp, r.tp),
            "w_v": (r.fsdp, r.tp), "w_g": (r.fsdp, r.tp),
            "w0": (r.tp,), "w_lora_a": (r.fsdp, None),
            "w_lora_b": (None, r.tp), "u": (r.tp,),
            "gn_scale": (r.tp,), "w_o": (r.tp, r.fsdp)}


def _rwkv_cmix_specs(r: ShardingRules):
    return {"mix_base": (None, None), "w_k": (r.fsdp, r.tp),
            "w_v": (r.tp, r.fsdp), "w_r": (r.fsdp, r.tp)}


def _norm_specs(cfg: ArchConfig):
    if cfg.norm == "nonparam_ln":
        return {}
    p = {"scale": (None,)}
    if cfg.norm == "layernorm":
        p["bias"] = (None,)
    return p


def _block_specs(cfg: ArchConfig, block, r: ShardingRules):
    mixer, ffn = block
    if mixer in ATTN_MIXERS:
        mx = _attn_specs(r)
    elif mixer == "mla":
        mx = _mla_specs(r)
    elif mixer == "rglru":
        mx = _rglru_specs(r)
    else:
        mx = _rwkv_tmix_specs(r)
    if ffn == "mlp":
        fn = _mlp_specs(r, cfg.activation)
    elif ffn == "moe":
        fn = _moe_specs(r, cfg)
    else:
        fn = _rwkv_cmix_specs(r)
    return {"norm1": _norm_specs(cfg), "mixer": mx,
            "norm2": _norm_specs(cfg), "ffn": fn}


def _flatten(tree: Dict, prefix: str, out: Dict[str, Spec]) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = v


def param_specs(cfg: ArchConfig, r: ShardingRules) -> Dict[str, Spec]:
    """One spec per parameter, keyed like ``LM.named_parameters()``."""
    tree = {}
    if cfg.frontend is None or cfg.frontend == "patch":
        tree["embed"] = {"table": (r.tp, r.fsdp)}
    if cfg.frontend is not None:
        tree["frontend_proj"] = {"w": (None, r.fsdp)}
        if cfg.frontend == "frame":
            tree["pos_embed"] = (None, r.fsdp)
    tree["blocks"] = {str(i): _block_specs(cfg, b, r)
                      for i, b in enumerate(cfg.blocks())}
    tree["out_norm"] = _norm_specs(cfg)
    if not cfg.tie_embeddings:
        tree["head"] = {"w_out": (r.fsdp, r.tp)}
    out: Dict[str, Spec] = {}
    _flatten(tree, "", out)
    return out


def _dp(r: ShardingRules):
    """The batch axes as one spec entry (one axis is named alone, as a
    ``PartitionSpec`` normalizes it)."""
    return r.dp[0] if len(r.dp) == 1 else tuple(r.dp)


def cache_specs(cfg: ArchConfig, r: ShardingRules):
    """Spec tree mirroring ``models.model.init_cache`` (a list of layers)."""
    dpax = _dp(r)

    def block_cache(block):
        mixer, ffn = block
        if mixer in ATTN_MIXERS:
            c = {"kv": {"k": (dpax, None, r.tp, None),
                        "v": (dpax, None, r.tp, None), "pos": (None,)}}
        elif mixer == "mla":
            c = {"kv": {"c_kv": (dpax, None, None),
                        "k_rope": (dpax, None, None)}}
        elif mixer == "rglru":
            c = {"rec": {"h": (dpax, r.tp), "conv": (dpax, None, r.tp)}}
        else:
            c = {"tmix": {"s": (dpax, r.tp, None, None),
                          "x_prev": (dpax, None, None)}}
        if ffn == "cmix":
            c["cmix"] = {"x_prev": (dpax, None, None)}
        return c

    return [block_cache(b) for b in cfg.blocks()]


def batch_specs(cfg: ArchConfig, r: ShardingRules) -> Dict[str, Spec]:
    dpax = _dp(r)
    if cfg.frontend == "frame":
        return {"frames": (dpax, None, None), "labels": (dpax, None)}
    if cfg.frontend == "patch":
        return {"patches": (dpax, None, None), "tokens": (dpax, None),
                "labels": (dpax, None)}
    return {"tokens": (dpax, None), "labels": (dpax, None)}


def opt_specs(pspecs: Dict[str, Spec]) -> Dict:
    """AdamW's state (``train/optimizer.py``): moments as the parameters,
    the step count replicated."""
    return {"m": pspecs, "v": pspecs, "count": ()}


def sanitize(spec: Spec, shape, mesh: Dict[str, int]) -> Spec:
    """Drop mesh axes that don't divide the dim; dedupe repeated axes."""
    used = set()
    out = []
    ndim = len(shape)
    spec_t = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    for d, ax in enumerate(spec_t[:ndim]):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        keep = [a for a in axes if a not in used and a in mesh]
        if keep and shape[d] % math.prod(mesh[a] for a in keep) == 0:
            used.update(keep)
            out.append(tuple(keep) if len(keep) > 1 else keep[0])
        else:
            out.append(None)
    return tuple(out)


def _leaves(specs, tensors, where=""):
    if isinstance(tensors, dict):
        if set(specs) != set(tensors):
            raise KeyError(f"{where}: specs {sorted(specs)} vs tensors "
                           f"{sorted(tensors)}")
        for k in tensors:
            yield from _leaves(specs[k], tensors[k], f"{where}.{k}")
    elif isinstance(tensors, (list, tuple)):
        if len(specs) != len(tensors):
            raise ValueError(f"{where}: {len(specs)} specs for "
                             f"{len(tensors)} tensors")
        for i, (s, t) in enumerate(zip(specs, tensors)):
            yield from _leaves(s, t, f"{where}[{i}]")
    else:
        yield specs, tensors


def bytes_per_device(specs, tensors, mesh: Dict[str, int]) -> int:
    """The bytes one device of ``mesh`` holds of ``tensors`` laid out by
    ``specs`` (two trees of one structure; each tensor's sanitized axes
    divide it evenly).  Computed from the specs, not compiled."""
    total = 0
    for spec, t in _leaves(specs, tensors):
        split = math.prod(mesh[a] for ax in sanitize(spec, t.shape, mesh)
                          if ax is not None
                          for a in (ax if isinstance(ax, tuple) else (ax,)))
        total += t.numel() * t.element_size() // split
    return total
