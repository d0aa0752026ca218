"""train_step / serve_step factories — the units the launchers run.

``make_train_step`` is the reference's: ``loss_fn``'s gradient, then one
AdamW update, returning the reference's metrics (``loss``, ``aux``,
``total``, ``grad_norm``).  JAX differentiates a pure function; here the
gradient comes from ``backward()`` into the parameters' ``.grad`` (the
model's forward under ``cfg.remat``; on the card both LM kernels run their
backward kernels), read into a dict keyed like ``LM.named_parameters()``
and freed after the update.  Parameters and moments are updated in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as model_lib
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state


def param_grads(params: model_lib.LM) -> Dict[str, torch.Tensor]:
    """The gradient of every parameter after a backward, by name (zeros
    for one that received none)."""
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in params.named_parameters()}


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig = AdamWConfig()):
    def train_step(params: model_lib.LM, opt_state: Dict, batch: Dict
                   ) -> Tuple[model_lib.LM, Dict, Dict]:
        """One step on ``batch`` (``tokens``, ``labels`` [B, S]).  Returns
        ``(params, opt_state, metrics)``, the metrics float32 scalars on the
        parameters' device."""
        params.requires_grad_(True)
        params.zero_grad(set_to_none=True)
        total, metrics = model_lib.loss_fn(params, batch, cfg)
        total.backward()
        grads = param_grads(params)
        _, opt_state, gnorm = adamw_update(
            grads, opt_state, dict(params.named_parameters()), opt_cfg)
        del grads
        params.zero_grad(set_to_none=True)
        metrics = {"loss": metrics["loss"].detach(),
                   "aux": metrics["aux"].detach(), "total": total.detach(),
                   "grad_norm": gnorm}
        return params, opt_state, metrics
    return train_step


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, cache, tokens, pos: int):
        """Greedy next token [B] (int64, where the reference returns int32)
        and the updated cache."""
        logits, cache = model_lib.decode_step(params, cache, tokens, pos, cfg)
        return logits[:, -1].argmax(dim=-1), cache
    return serve_step


def init_train_state(cfg: ArchConfig, device=None, seed: int = 0
                     ) -> Tuple[model_lib.LM, Dict]:
    """Random parameters from ``seed`` on ``device`` (``None`` = CUDA),
    with gradients on, and a fresh optimizer state."""
    params = model_lib.init_params(cfg, device, seed=seed)
    params.requires_grad_(True)
    return params, init_opt_state(dict(params.named_parameters()))
