"""Carry the reference's parameters across: its ``init_params`` pytree, as
numpy arrays, becomes the port's ``LM``.

The reference stacks the parameters of its repeated unit of blocks along a
leading reps axis (``params["body"]``); the port keeps one ``LayerBlock``
per layer, so ``body`` is unstacked: unit block ``i`` of rep ``r`` is layer
``len(prefix) + r * len(unit) + i``.  Names and layouts are the same on both
sides, down to the nested trees (an MoE layer's ``shared`` experts, RWKV's
time- and channel-mix) and the frontends' ``frontend_proj`` and
``pos_embed``.  The tests use this so that both packages compute one
function.

Any tree of the parameters' structure (the reference's gradients, its AdamW
moments) maps the same way onto the port's parameter names
(:func:`named_from_reference`); :func:`opt_state_from_reference` builds the
port's optimizer state from the reference's, so a test can continue a JAX
run in the port.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import LM, decompose, init_params


def _layer_trees(np_params: Dict, cfg: ArchConfig) -> List[Dict]:
    layout = decompose(cfg.blocks())
    trees = [np_params["prefix"][str(i)] for i in range(len(layout.prefix))]
    body = np_params["body"]
    for r in range(layout.reps):
        for i in range(len(layout.unit)):
            trees.append(_index(body[str(i)], r))
    trees += [np_params["suffix"][str(i)] for i in range(len(layout.suffix))]
    return trees


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def _load(module: torch.nn.Module, tree: Dict, where: str,
          skip=()) -> None:
    """Copy ``tree``'s arrays into ``module``'s parameters of the same
    names, and its sub-trees into the submodules of the same names, each
    parameter in its own dtype; raise on a missing, extra or misshapen
    entry.  Children named in ``skip`` are left out."""
    params = dict(module.named_parameters(recurse=False))
    children = {n: c for n, c in module.named_children() if n not in skip}
    if set(params) | set(children) != set(tree):
        raise KeyError(f"{where}: the port has "
                       f"{sorted(set(params) | set(children))}, the "
                       f"reference {sorted(tree)}")
    for name, p in params.items():
        arr = np.array(tree[name], dtype=np.float32)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{where}.{name}: shape {arr.shape} vs the "
                             f"port's {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(arr))
    for name, child in children.items():
        _load(child, tree[name], f"{where}.{name}")


def named_from_reference(np_tree: Dict, cfg: ArchConfig,
                         model: LM) -> Dict[str, np.ndarray]:
    """The leaves of a tree shaped like the reference's parameters (its
    parameters, gradients or moments; numpy leaves), keyed by the port's
    parameter names (``LM.named_parameters()``) as float32 arrays."""
    trees = _layer_trees(np_tree, cfg)
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            leaf, parts = trees[int(parts[1])], parts[2:]
        else:
            leaf = np_tree
        for part in parts:
            leaf = leaf[part]
        arr = np.array(leaf, dtype=np.float32)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} vs the port's "
                             f"{tuple(p.shape)}")
        out[name] = arr
    return out


def opt_state_from_reference(np_opt: Dict, cfg: ArchConfig,
                             model: LM) -> Dict:
    """The port's AdamW state (``train/optimizer.py``) holding the
    reference's ``{"m", "v", "count"}`` (numpy leaves), on ``model``'s
    device."""
    dev = model.device
    return {
        moment: {n: torch.from_numpy(a).to(dev) for n, a in
                 named_from_reference(np_opt[moment], cfg, model).items()}
        for moment in ("m", "v")} | {
        "count": torch.tensor(int(np.asarray(np_opt["count"])),
                              dtype=torch.int32, device=dev)}


@torch.no_grad()
def params_from_reference(np_params: Dict, cfg: ArchConfig,
                          device=None) -> LM:
    """The port's parameters holding the reference pytree's values
    (``np_params``: the reference's ``init_params`` output with every leaf
    a numpy array; bfloat16 leaves may be ml_dtypes arrays)."""
    model = init_params(cfg, device)
    _load(model, {k: v for k, v in np_params.items()
                  if k not in ("prefix", "body", "suffix")}, "params",
          skip=("blocks",))
    trees = _layer_trees(np_params, cfg)
    if len(trees) != len(model.blocks):
        raise ValueError(f"{len(trees)} reference layers for "
                         f"{len(model.blocks)} port layers")
    for li, (block, tree) in enumerate(zip(model.blocks, trees)):
        _load(block, tree, f"layer {li}")
    return model
