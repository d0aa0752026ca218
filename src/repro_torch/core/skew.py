"""Skew-aware reduce-task scheduling (paper §4.2–§4.3).

Cost model (paper):  c_task = |R_task| + Σ_i |D_i_task| + |R ⋈ D_1 ⋈ ... |_est,
estimated from a Simple Random Sample of the fact relation; dimension bucket
sizes are exact (they are just bincounts of hashed keys).  Tasks that receive
no fact tuples are pruned outright (§4.3.3).  Scheduling is greedy
longest-processing-time (LPT) onto the least-loaded worker — the paper's
Fig. 2 heuristic.  The schedule materializes as a static task -> worker
table baked into the routing plan; it also serves as the
framework's straggler-mitigation layer for the FCT engine (hot devices are
impossible by construction, up to estimation error).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.hypercube import TaskGrid


@dataclasses.dataclass
class Schedule:
    task_to_device: np.ndarray   # int32 [n_tasks]; -1 = pruned (no fact rows)
    device_cost: np.ndarray      # float64 [n_devices] estimated cost
    task_cost: np.ndarray        # float64 [n_tasks]

    @property
    def imbalance(self) -> float:
        """max/mean device cost — 1.0 is perfect balance."""
        mean = self.device_cost.mean()
        return float(self.device_cost.max() / max(mean, 1e-12))


def estimate_task_costs(grid: TaskGrid,
                        fact_tasks: np.ndarray,
                        fact_probe_nums: Sequence[np.ndarray],
                        dim_buckets: Sequence[np.ndarray],
                        sample_frac: float = 1.0,
                        seed: int = 0) -> np.ndarray:
    """Per-task cost  c = |R_t| + Σ|D_i,t| + |join|_est  from a fact sample.

    fact_tasks       — task id per fact row (full column; we sample from it)
    fact_probe_nums  — per dim, num_i(key_i(t)) per fact row (match counts)
    dim_buckets      — per dim, bucket id per dim row
    """
    T = grid.n_tasks
    n = fact_tasks.shape[0]
    rng = np.random.default_rng(seed)
    if sample_frac >= 1.0:
        idx = np.arange(n)
        scale = 1.0
    else:
        take = max(1, int(n * sample_frac))
        idx = rng.choice(n, size=take, replace=False)
        scale = n / take
    t = fact_tasks[idx]
    fact_count = np.bincount(t, minlength=T) * scale
    join_rows = np.ones(len(idx), np.float64)
    for probe in fact_probe_nums:
        join_rows *= probe[idx]
    join_est = np.bincount(t, weights=join_rows, minlength=T) * scale

    dim_count = np.zeros(T, np.float64)
    for axis, buckets in enumerate(dim_buckets):
        per_bucket = np.bincount(buckets, minlength=grid.shares[axis])
        for b in range(grid.shares[axis]):
            dim_count[grid.tasks_with_coord(axis, b)] += per_bucket[b]
    return fact_count + dim_count + join_est


def choose_rho(fact_rows: int, n_devices: int, *,
               target_tasks_per_device: int = 8,
               min_rows_per_task: int = 8,
               max_rho: int = 64) -> int:
    """Per-query over-decomposition factor from OBSERVED tuple-set sizes.

    The fixed ``rho=4`` config point treats every CN alike; the balance pass
    instead doubles the task grid until either (a) LPT has
    ``target_tasks_per_device`` tasks per worker to pack with — enough
    freedom that one hot hash bucket no longer pins a whole device — or
    (b) tasks would drop below ``min_rows_per_task`` expected fact rows,
    where further splitting only buys scheduling overhead and extra
    dimension replication (the Afrati–Ullman communication cost grows with
    the task count).  Power of two by construction; 1 on a single device
    (nothing to balance) and for tiny tuple sets.
    """
    if n_devices <= 1:
        return 1
    rho = 1
    while (rho < target_tasks_per_device and rho * 2 <= max_rho
           and fact_rows >= min_rows_per_task * n_devices * rho * 2):
        rho *= 2
    return rho


def device_row_counts(task_to_device: np.ndarray, fact_tasks: np.ndarray,
                      n_devices: int) -> np.ndarray:
    """Fact rows landing on each device under a schedule — the *achieved*
    balance (row imbalance = max/mean of this), as opposed to the estimated
    cost balance LPT optimized.  Rows of pruned tasks (-1) are dropped."""
    dst = task_to_device[fact_tasks]
    return np.bincount(dst[dst >= 0], minlength=n_devices).astype(np.int64)


def row_imbalance(device_rows: np.ndarray) -> float:
    """max/mean rows per device; 1.0 is perfect balance, ``n_devices``
    means one device carries everything."""
    mean = device_rows.mean()
    return float(device_rows.max() / max(mean, 1e-12))


def lpt_schedule(task_cost: np.ndarray, n_devices: int,
                 prune_empty: np.ndarray | None = None) -> Schedule:
    """Greedy LPT packing of tasks onto devices (paper Fig. 2)."""
    T = task_cost.shape[0]
    task_to_device = np.full(T, -1, np.int32)
    load = np.zeros(n_devices, np.float64)
    order = np.argsort(-task_cost, kind="stable")
    for t in order:
        if prune_empty is not None and prune_empty[t]:
            continue  # §4.3.3: reduce tasks with no fact tuples are useless
        d = int(np.argmin(load))
        task_to_device[t] = d
        load[d] += float(task_cost[t])
    return Schedule(task_to_device=task_to_device, device_cost=load,
                    task_cost=task_cost)


def round_robin_schedule(task_cost: np.ndarray, n_devices: int) -> Schedule:
    """The paper's strawman (§4.3.3): blind round-robin task placement."""
    T = task_cost.shape[0]
    task_to_device = (np.arange(T) % n_devices).astype(np.int32)
    load = np.zeros(n_devices, np.float64)
    for t in range(T):
        load[task_to_device[t]] += float(task_cost[t])
    return Schedule(task_to_device=task_to_device, device_cost=load,
                    task_cost=task_cost)
