"""Afrati–Ullman share optimization for the star multiway join (paper §2.2/§4.1).

For a star join  F(A_1..A_m) ⋈ D_1(A_1) ⋈ ... ⋈ D_m(A_m)  executed on
``k`` reduce tasks arranged as an m-dimensional hypercube with shares
(a_1, ..., a_m), Π a_i = k, the map→reduce communication is

    cost(a) = f  +  Σ_i  d_i · k / a_i

(every fact tuple goes to exactly one task; every D_i tuple is replicated to
the k/a_i tasks spanning the orthogonal axes).  The Lagrangean solution is

    a_i  ∝  d_i   (shares proportional to dimension sizes),
    a_i  =  (k · d_i^m / Π_j d_j)^(1/m)        [paper: a=∛(ks²/tp), ...]

Real meshes need integer shares whose product is exactly k, so on top of the
closed form we run an exact search over the divisor lattice of k (beyond-paper
but tiny: k ≤ 4096 has < 10^3 ordered factorizations for m ≤ 4).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SharePlan:
    shares: Tuple[int, ...]        # integer shares, prod == k
    k: int
    cost: float                    # replicated tuples (comm model, rows)
    fractional: Tuple[float, ...]  # the closed-form Lagrangean solution
    fractional_cost: float


def closed_form_shares(dim_sizes: Sequence[float], k: int) -> Tuple[float, ...]:
    """The paper's Lagrangean solution: a_i = (k d_i^m / Π d_j)^(1/m)."""
    m = len(dim_sizes)
    logprod = sum(math.log(max(d, 1e-12)) for d in dim_sizes)
    out = []
    for d in dim_sizes:
        loga = (math.log(k) + m * math.log(max(d, 1e-12)) - logprod) / m
        out.append(math.exp(loga))
    return tuple(out)


def replication_cost(dim_sizes: Sequence[float], shares: Sequence[float],
                     fact_size: float = 0.0) -> float:
    k = math.prod(shares)
    return fact_size + sum(d * k / a for d, a in zip(dim_sizes, shares))


def _divisors(k: int):
    return [d for d in range(1, k + 1) if k % d == 0]


def _factorizations(k: int, m: int):
    """All ordered m-tuples of positive ints with product k."""
    if m == 1:
        yield (k,)
        return
    for d in _divisors(k):
        for rest in _factorizations(k // d, m - 1):
            yield (d,) + rest


def optimize_shares(dim_sizes: Sequence[float], k: int,
                    fact_size: float = 0.0,
                    max_enumeration: int = 200_000) -> SharePlan:
    """Integer share vector minimizing the replication cost, prod == k.

    Uses exact divisor-lattice enumeration when cheap; otherwise rounds the
    closed form to nearby divisors (guaranteed feasible).
    """
    m = len(dim_sizes)
    frac = closed_form_shares(dim_sizes, k)
    fcost = replication_cost(dim_sizes, frac, fact_size)

    n_div = len(_divisors(k))
    best: Tuple[int, ...] | None = None
    best_cost = float("inf")
    if n_div ** (m - 1) <= max_enumeration:
        for cand in _factorizations(k, m):
            c = replication_cost(dim_sizes, cand, fact_size)
            if c < best_cost:
                best, best_cost = cand, c
    else:  # round each fractional share to nearby divisors, fix up the last
        divs = _divisors(k)
        def near(x):
            return sorted(divs, key=lambda d: abs(math.log(d / max(x, 1e-9))))[:3]
        for cand in itertools.product(*[near(x) for x in frac[:-1]]):
            prod = math.prod(cand)
            if k % prod == 0:
                full = cand + (k // prod,)
                c = replication_cost(dim_sizes, full, fact_size)
                if c < best_cost:
                    best, best_cost = full, c
        if best is None:
            best = (k,) + (1,) * (m - 1)
            best_cost = replication_cost(dim_sizes, best, fact_size)
    assert best is not None and math.prod(best) == k
    return SharePlan(shares=best, k=k, cost=best_cost,
                     fractional=frac, fractional_cost=fcost)



def mesh_shares_for_training(batch_comm: float, model_comm: float,
                             k: int) -> SharePlan:
    """Reuse of the paper's optimizer for mesh-axis selection.

    Treat DP-replicated bytes (per model-shard) and TP-replicated bytes (per
    data-shard) as two 'dimension sizes'; the optimizer returns the
    (data, model) axis split of k chips minimizing summed collective bytes
    (the port's ``perf_options.virtual_grid`` takes such a split).
    """
    return optimize_shares([batch_comm, model_comm], k)
