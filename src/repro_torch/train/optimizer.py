"""AdamW, hand-rolled over the parameter tree: float32 moments over bf16
parameters, the reference's ``train/optimizer.py`` formula exactly.

The tree is a dict keyed like ``LM.named_parameters()`` (``"embed.table"``,
``"blocks.0.mixer.w_x"``, ...).  The optimizer state is
``{"m": {name: float32}, "v": {name: float32}, "count": int32 scalar}``, a
plain dict tree that ``distributed/checkpoint.py`` saves as it is.  Per
leaf, in float32: the gradient scaled by the global-norm clip, the moments,
bias correction with ``b ** count``, weight decay inside the step, and the
new parameter cast back to its dtype (no float32 master copy).  Not
``torch.optim.AdamW``, which keeps bf16 moments for bf16 parameters and
decays before the step.  Unlike the reference's pure function, the update
writes the parameters and moments in place, which saves a copy of each
(23 GB of moments at recurrentgemma-2b's full size).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params: Dict[str, torch.Tensor]) -> Dict:
    """Zero float32 moments shaped like ``params``, on their devices, and a
    zero int32 step count."""
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    device = next(iter(params.values())).device
    return {"m": zeros,
            "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g²), each leaf in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], opt_state: Dict,
                 params: Dict[str, torch.Tensor], cfg: AdamWConfig
                 ) -> Tuple[Dict[str, torch.Tensor], Dict, torch.Tensor]:
    """One step.  Returns ``(params, opt_state, grad_norm)``: the same
    parameter and moment tensors, updated in place, the new count, and the
    float32 global norm of ``grads`` before clipping."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    c = count.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=c.device), c)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=c.device), c)
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = opt_state["m"][name], opt_state["v"][name]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        pf = p.float()
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * pf
        p.copy_(pf - cfg.lr * step)
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "count": count}, gnorm
