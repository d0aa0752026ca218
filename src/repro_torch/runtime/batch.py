"""Shape bucketing for the FCT runtime.

A ``CNPlan``'s device arrays have data-dependent dims: per-worker rows ``S``
(tuple-set size / P), send-table capacity ``C`` (max rows any worker ships to
any other) and text width ``L``.  Bucketing rounds each of those dims up to a
power of two (``BUCKET_MIN`` floor), so the infinite family of exact shapes
collapses onto a small lattice of *signatures* — the unit of program caching
and of multi-CN batching.  The pow-2 padding also fixes the shapes (and hence
``shuffle_bytes``-level accounting) to the reference engine's.
``bucket=False`` keeps the exact dims (the equivalence baseline).

Padding is semantics-free by construction:
  * extra ``S`` rows are never named by any send-table entry,
  * extra ``C`` slots hold -1, which the device program masks out,
  * extra ``L`` columns hold PAD_ID, which the histogram never counts
    (a relation of width 0, one that carries no text, stays at 0),
  * a larger key ``domain`` only grows the num-arrays' zero tail.

``pad_plan_arrays`` pads one plan's host arrays to its signature, in the
reference's dtypes, for the two-job path (``core/fct.py``); the engine's
groups read store-resident columns padded the same way (``store.py``).

Beside the shape lattice, a signature carries the query's
:class:`~repro_torch.core.accum.AccumPolicy` — the device accumulation width
and overflow behavior.  Two plans with equal shapes but different policies
run different programs (int32 vs int64 accumulators), so the policy is part
of the signature for the program cache and batching to stay sound.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.accum import INT32_CHECKED, AccumPolicy
from repro_torch.core.plan import CNPlan, RelationRoute
from repro_torch.data.schema import PAD_ID

BUCKET_MIN = 8


def bucket_pow2(n: int, minimum: int = BUCKET_MIN) -> int:
    """Smallest power of two >= max(n, minimum)."""
    n = max(int(n), minimum, 1)
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class RelationSig:
    """Padded dims of one routed relation: [P, rows, text_len] text,
    [P, P, cap] send table, key domain (0 for the fact side).

    ``key_width`` is the fact relation's FULL key-column count (0 for dims):
    the store-path device program takes the full-width stored key matrix
    [P, rows, key_width] plus a per-CN column-index gather, so its shapes —
    and hence the program-cache key — depend on it."""

    rows: int
    cap: int
    text_len: int
    domain: int = 0
    key_width: int = 0


@dataclasses.dataclass(frozen=True)
class PlanSignature:
    """Shape-bucket signature of a CNPlan — the program-cache key's
    structural part.  Two plans with equal signatures run the same built
    program and may be stacked into one batched dispatch.

    ``accum`` is the device accumulation policy (int32-checked vs
    int64-exact): it changes the dtype of every volume/histogram in the
    program body, so it is as much a part of the program's identity as the
    shapes are.

    ``k_bucket`` identifies the top-k finalize family (``fct_topk``): the
    pow-2-bucketed candidate count each worker keeps, 0 for histogram
    programs.  Bucketing k the same way as shapes means nearby ``top_k``
    requests (k=10 and k=12, say) reuse one program."""

    n_devices: int
    vocab: int
    fact: RelationSig
    dims: Tuple[RelationSig, ...]
    accum: AccumPolicy = INT32_CHECKED
    k_bucket: int = 0

    @property
    def m(self) -> int:
        return len(self.dims)


def _route_sig(route: RelationRoute, domain: int, bucket: bool,
               key_width: int = 0) -> RelationSig:
    # descriptor metadata only — computing a signature must not materialize
    # the (lazy) column arrays
    S, L = route.ref.shard_rows, route.ref.text_len
    C = route.send.shape[-1]
    if bucket:
        # a relation without text (width 0) keeps width 0: MR² reads nothing
        # of it, so there is no column to pad
        S, C, L = bucket_pow2(S), bucket_pow2(C), bucket_pow2(L) if L else 0
        domain = bucket_pow2(domain) if domain else 0
    return RelationSig(rows=S, cap=C, text_len=L, domain=domain,
                       key_width=key_width)


def plan_signature(plan: CNPlan, bucket: bool = True,
                   accum: Optional[AccumPolicy] = None) -> PlanSignature:
    """``accum=None`` means int32-checked, the default policy; sessions
    pass their resolved policy."""
    if accum is None:
        accum = INT32_CHECKED
    dims = tuple(_route_sig(plan.dims[i], plan.key_domains[i], bucket)
                 for i in plan.included)
    fact = _route_sig(plan.fact, 0, bucket,
                      key_width=plan.fact.ref.key_width)
    return PlanSignature(n_devices=plan.n_devices, vocab=plan.vocab_size,
                         fact=fact, dims=dims, accum=accum)


def _pad_route(route: RelationRoute, sig: RelationSig) -> Dict[str, np.ndarray]:
    rtext, rkeys = route.text, route.keys   # materialize the lazy columns once
    P, S, L = rtext.shape
    text = np.pad(rtext, ((0, 0), (0, sig.rows - S), (0, sig.text_len - L)),
                  constant_values=PAD_ID)
    key_pad = ((0, 0), (0, sig.rows - S)) + ((0, 0),) * (rkeys.ndim - 2)
    keys = np.pad(rkeys, key_pad, constant_values=0)
    send = np.pad(route.send,
                  ((0, 0), (0, 0), (0, sig.cap - route.send.shape[-1])),
                  constant_values=-1)
    return {"text": text, "keys": keys, "send": send}


def pad_plan_arrays(plan: CNPlan, sig: PlanSignature):
    """(fact, [dims]) numpy dicts padded to ``sig``: text ``[P, rows,
    text_len]``, keys ``[P, rows]`` (dim) or ``[P, rows, m]`` (fact, the
    CN's own columns), send ``[P, P, cap]``."""
    fact = _pad_route(plan.fact, sig.fact)
    dims = [_pad_route(plan.dims[i], rsig)
            for i, rsig in zip(plan.included, sig.dims)]
    return fact, dims


def group_plan_indices(plans: Sequence[CNPlan], bucket: bool = True,
                       accum: Optional[AccumPolicy] = None
                       ) -> List[Tuple[PlanSignature, List[int]]]:
    """Group plan *indices* by signature (insertion order preserved): one
    batched device program per group."""
    groups: Dict[PlanSignature, List[int]] = {}
    for i, plan in enumerate(plans):
        groups.setdefault(plan_signature(plan, bucket, accum), []).append(i)
    return list(groups.items())


def group_plans(plans: Sequence[CNPlan], bucket: bool = True,
                accum: Optional[AccumPolicy] = None
                ) -> List[Tuple[PlanSignature, List[CNPlan]]]:
    """As ``group_plan_indices``, materialized to the plans themselves."""
    return [(sig, [plans[i] for i in idxs])
            for sig, idxs in group_plan_indices(plans, bucket, accum)]
