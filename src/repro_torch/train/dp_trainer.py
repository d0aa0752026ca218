"""Explicit data-parallel trainer with int8 error-feedback gradient
compression, on the virtual mesh.

The port of the reference's ``train/dp_trainer.py``.  There each replica of
a ``shard_map`` takes its shard of the batch, computes its gradient, and the
replicas reduce them with ``compressed_psum`` (or an exact ``pmean``).
Here the P workers of ``mesh`` (``launch/mesh.py::VirtualMesh``) are taken
in turn on one device: the batch splits into P equal shards, each shard's
gradient is computed by one backward, the P gradients are stacked on a
leading worker axis and reduced by ``distributed/compression.py``'s
``compressed_psum`` (or their exact mean when ``compress=False``), and one
AdamW update follows.  The error state is ``[P, ...]`` per leaf, one
residual per worker, as the reference keeps one per replica, updated in
place.  Metrics:
``loss``, ``aux`` and ``total`` are means over the workers (the reference
returns worker 0's ``loss`` and the mean ``total``), ``grad_norm`` the
reduced gradient's.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.compression import (compressed_psum,
                                                 init_error_state)
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.models import model as model_lib
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.train.step import param_grads


def make_compressed_dp_step(cfg: ArchConfig, mesh: VirtualMesh,
                            opt_cfg: AdamWConfig = AdamWConfig(),
                            compress: bool = True):
    """Returns step(params, opt_state, err_state, batch) ->
    (params, opt_state, err_state, metrics)."""
    n = mesh.n_workers

    def step(params: model_lib.LM, opt_state: Dict, err: Dict, batch: Dict):
        rows = batch["tokens"].shape[0]
        if rows % n:
            raise ValueError(f"batch of {rows} does not split into {n} "
                             f"equal worker shards")
        per = rows // n
        params.requires_grad_(True)
        stacked = {name: torch.empty((n, *p.shape), dtype=p.dtype,
                                     device=p.device)
                   for name, p in params.named_parameters()}
        totals, losses, auxes = [], [], []
        for w in range(n):
            shard = {k: v[w * per:(w + 1) * per] for k, v in batch.items()}
            params.zero_grad(set_to_none=True)
            total, metrics = model_lib.loss_fn(params, shard, cfg)
            total.backward()
            for name, g in param_grads(params).items():
                stacked[name][w].copy_(g)
            totals.append(total.detach())
            losses.append(metrics["loss"].detach())
            auxes.append(metrics["aux"].detach())
        params.zero_grad(set_to_none=True)
        if compress:
            grads, err = compressed_psum(stacked, err)
        else:
            grads = {name: g.sum(dim=0) / n for name, g in stacked.items()}
        del stacked
        _, opt_state, gnorm = adamw_update(
            grads, opt_state, dict(params.named_parameters()), opt_cfg)
        metrics = {"loss": torch.stack(losses).mean(),
                   "aux": torch.stack(auxes).mean(),
                   "total": torch.stack(totals).mean(), "grad_norm": gnorm}
        return params, opt_state, err, metrics

    return step


def init_error(params: model_lib.LM, mesh: VirtualMesh) -> Dict:
    """Zero residuals, ``[P, ...]`` float32 per parameter."""
    return init_error_state({
        name: p.detach().expand(mesh.n_workers, *p.shape)
        for name, p in params.named_parameters()})
