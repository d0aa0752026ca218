"""Training loop with checkpoint/restart, straggler accounting and an
optional failure injector (used by the fault-tolerance tests and examples).

The port of the reference's ``train/loop.py``.  Resume is automatic: if the
checkpoint directory holds a step, training continues from it, with the
data stream fast-forwarded so the data order is the same across restarts.
Checkpoints go through ``distributed/checkpoint.py`` (step directories,
atomic rename, the newest 3 kept) as ``{"params": {name: tensor}, "opt":
optimizer state}``; a restore copies each leaf into the live parameters and
moments on their device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.checkpoint import (latest_step,
                                                restore_checkpoint,
                                                save_checkpoint)
from repro_torch.launch.mesh import resolve_device
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 20
    log_every: int = 10
    fail_at_step: Optional[int] = None   # failure injection (tests)
    straggler_warn_s: float = 0.0        # count a step slower than this


def data_stream(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                device=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Learnable synthetic stream: cyclic token sequences with a random
    phase per row (a model that trains at all drives the loss well below
    ln V), the reference's stream.  The phases are drawn from one explicit
    CPU ``torch.Generator`` seeded with ``seed``, so its numbers differ from
    the reference's ``jax.random`` ones (the tests feed both packages the
    reference's batches); tokens and labels are int64 on ``device``
    (``None`` = CUDA)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    period = min(cfg.vocab_size - 1, 97)
    while True:
        start = torch.randint(0, period, (batch, 1), generator=gen)
        toks = ((start + torch.arange(seq)[None, :]) % period + 1).to(dev)
        yield {"tokens": toks, "labels": toks}


def _state(params, opt_state) -> Dict:
    return {"params": dict(params.named_parameters()), "opt": opt_state}


@torch.no_grad()
def restore_into(ckpt_dir: str, params, opt_state) -> int:
    """Copy the newest checkpoint under ``ckpt_dir`` into ``params`` and
    ``opt_state`` in place; returns its step."""
    live = _state(params, opt_state)
    step, state = restore_checkpoint(ckpt_dir, live)
    for name, t in live["params"].items():
        t.copy_(state["params"][name])
    for moment in ("m", "v"):
        for name, t in live["opt"][moment].items():
            t.copy_(state["opt"][moment][name])
    live["opt"]["count"].copy_(state["opt"]["count"])
    return step


def train(cfg: ArchConfig, loop: LoopConfig, batch: int = 4, seq: int = 64,
          opt_cfg: AdamWConfig = AdamWConfig(),
          on_step: Optional[Callable] = None, device=None,
          seed: int = 0) -> Dict:
    """Train ``cfg`` from parameters drawn from ``seed`` (``device``: ``None``
    = CUDA) on ``data_stream(cfg, batch, seq, seed)`` for ``loop.steps``
    steps, resuming from ``loop.ckpt_dir`` when it holds a step.  A step's
    time runs to its loss on the host, so it includes the device's work."""
    dev = resolve_device(device)
    params, opt_state = init_train_state(cfg, dev, seed=seed)
    start = 0
    if loop.ckpt_dir and latest_step(loop.ckpt_dir) is not None:
        start = restore_into(loop.ckpt_dir, params, opt_state)
        print(f"[loop] resumed from step {start}")
    step_fn = make_train_step(cfg, opt_cfg)
    stream = data_stream(cfg, batch, seq, seed, dev)
    # fast-forward the stream so data order is identical across restarts
    for _ in range(start):
        next(stream)
    losses = []
    slow_steps = 0
    for step in range(start, loop.steps):
        if loop.fail_at_step is not None and step == loop.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, next(stream))
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if loop.straggler_warn_s and dt > loop.straggler_warn_s:
            slow_steps += 1
        losses.append(loss)
        if loop.log_every and step % loop.log_every == 0:
            print(f"[loop] step={step} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        if on_step:
            on_step(step, params, metrics)
        if (loop.ckpt_dir and loop.ckpt_every
                and (step + 1) % loop.ckpt_every == 0):
            save_checkpoint(loop.ckpt_dir, step + 1,
                            _state(params, opt_state))
    return {"final_loss": losses[-1] if losses else float("nan"),
            "losses": losses, "params": params, "opt_state": opt_state,
            "slow_steps": slow_steps}
