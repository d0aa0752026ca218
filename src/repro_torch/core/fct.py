"""The two MapReduce jobs as one fused device program on a virtual mesh
(paper §4.3–§4.4).

MR¹ (statistics): route tuple-set rows' keys per the static plan (gather
→ all_to_all → mask), build dense ``num``-arrays per dimension and worker,
probe them per fact row to produce fact volumes and per-dimension ``vol``
contributions (on the card three hand-written kernels,
``kernels/mr1_volumes``).

MR² (term frequency): weighted token histogram of every routed payload with
its volume, summed over workers — the "aggregation equal transformation" of
Theorem 1 — then a host-side top-k with the Def. 6 exclusions.  MR² reads
the payloads by reference: a routed slot's tokens are read through the send
table from the tuple set's own text (the routed ``fct_count`` kernel on
CUDA, its plain version on the CPU), so routing moves keys and masks only
and no routed copy of the text is made.

Layout.  The reference runs one worker per device under ``shard_map`` and
``vmap``s the body over the CNs of a group.  Here both are explicit leading
axes on one device (:class:`repro_torch.launch.mesh.VirtualMesh`): a routed
relation is ``[N, P, P*C, ...]`` — CN, destination worker, then the rows it
received from every source worker in source order, exactly the reference's
post-``all_to_all`` buffer.  MR¹ keeps the worker axis (num-arrays are per
worker: a dimension row is replicated to several workers).  MR² flattens it
into the histogram's row axis, so one kernel launch per relation counts all
CNs and all workers at once; the psum over workers is folded into that sum,
which is bit-identical because integer addition is associative modulo the
accumulator width.  The reference routes the text beside the keys; here the
kernel's slot ``(n, dst, src*C + c)`` reads the very row the reference's
buffer holds there, so the counts are the same.

Index semantics follow the reference explicitly, since torch index ops raise
where JAX's clamp or drop: gathers wrap a negative index once and then clamp;
scatter-adds wrap once and drop what is still out of range
(``kernels/mr1_volumes/ref.py``, whose semantics the MR¹ kernels keep).  On
the main path every index is in range.

The engine (``runtime/engine.py``) runs a signature group's program as three
stages: routing (:func:`_route_cn`), MR¹ (:func:`_mr1_volumes`) and MR²
(:func:`_mr2_histograms`, over the group's arguments and the volumes) with
its aggregation; :func:`run_cn_plan` composes the same three for one CN.

The two jobs are also separable (:func:`run_cn_plan_two_jobs`): job 1
returns the vol-array artifact that job 2 consumes, so the MR¹→MR² boundary
can be checkpointed — the paper's "two MapReduce jobs" as two programs.  The
artifact is the spill boundary and holds the routed text itself
(:func:`_routed_text`); job 2 counts it with the plain-layout kernel.  The
fused path is the default.

The reference's ``make_fct_program`` and ``lower_cn_plan`` have no
counterpart: the first builds a jitted program that :func:`run_cn_plan`
calls (here it runs the device code directly, eagerly), the second lowers
it to HLO text, and nothing else in the reference calls either.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.accum import INT32_CHECKED, AccumPolicy
from repro_torch.core.plan import CNPlan
from repro_torch.data.schema import StarSchema
from repro_torch.distributed.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from repro_torch.kernels.fct_count.ops import (routed_histogram,
                                                weighted_histogram)
from repro_torch.kernels.mr1_volumes.ops import mr1_volumes
from repro_torch.kernels.mr1_volumes.ref import clamp_index as _clamp_index
from repro_torch.launch.mesh import VirtualMesh, all_to_all, psum
from repro_torch.obs import span as obs_span
from repro_torch.runtime.batch import (PlanSignature, pad_plan_arrays,
                                       plan_signature)
from repro_torch.runtime.cache import ExecutableCache, default_cache


def _route(keys: Sequence[torch.Tensor], send: torch.Tensor,
           cols: Optional[torch.Tensor] = None):
    """Gather rows' keys into per-destination buffers and all_to_all them,
    for a batch of N CNs.

    ``keys[n]`` is CN n's ``[P, S]`` (dim) or ``[P, S, m_all]`` (fact) keys
    — separate tensors, so CNs over one store-resident tuple set share it
    without a stacked copy.  ``send`` is ``[N, P(src), P(dst), C]`` (local
    row index, -1 pad); ``cols`` ``[N, m]`` selects each CN's fact key
    columns.  Returns the received ``(keys [N, P, P*C(, m)], mask [N, P,
    P*C])``; the text stays where it is, for MR² to read by reference."""
    N, P, _, C = send.shape
    S = keys[0].shape[1]
    send_t = all_to_all(send).long()           # [N, dst, src, C]
    mask = (send_t >= 0).reshape(N, P, P * C)
    flat = _routed_rows(send_t, S)
    k_tail = keys[0].shape[2:] if cols is None else (cols.shape[1],)
    rkeys = torch.empty((N, P * P * C) + tuple(k_tail), dtype=keys[0].dtype,
                        device=send.device)
    for n in range(N):
        k = keys[n].reshape((P * S,) + tuple(keys[n].shape[2:]))
        if cols is None:
            torch.index_select(k, 0, flat[n], out=rkeys[n])
        else:
            rkeys[n] = k.index_select(0, flat[n]).index_select(
                1, _clamp_index(cols[n].long(), k.shape[1]))
    return rkeys.view((N, P, P * C) + tuple(k_tail)), mask


def _routed_rows(send_t: torch.Tensor, S: int) -> torch.Tensor:
    """``[N, P*P*C]`` flat source row ``src*S + local`` of every routed
    slot, from the received ``[N, P(dst), P(src), C]`` send table.  A valid
    plan names rows in ``[0, S)`` only; -1 pads are masked, and the clamp
    keeps every gather in bounds."""
    N, P, _, C = send_t.shape
    local = send_t.clamp(0, S - 1)
    return (torch.arange(P, device=send_t.device).view(1, 1, P, 1) * S
            + local).reshape(N, P * P * C)


def _routed_text(texts: Sequence[torch.Tensor],
                 send: torch.Tensor) -> torch.Tensor:
    """The routed copy of N CNs' ``[P, S, L]`` texts, ``[N, P, P*C, L]``:
    the text the reference's all_to_all delivers, for the two-job path's
    vol-array artifact.  The fused path never makes it."""
    N, P, _, C = send.shape
    S, L = texts[0].shape[1:]
    flat = _routed_rows(all_to_all(send).long(), S)
    rtext = torch.empty((N, P * P * C, L), dtype=texts[0].dtype,
                        device=send.device)
    for n in range(N):
        torch.index_select(texts[n].reshape(P * S, L), 0, flat[n],
                           out=rtext[n])
    return rtext.view(N, P, P * C, L)


def _cn_joined(tables: Optional[List[torch.Tensor]]):
    """A CN batch's ``[1, ...]`` tables (one per CN, as the store and
    :func:`plan_to_tensors` hand them) as one ``[N, ...]`` tensor, joined
    along the CN axis on the device; a list of one as that table."""
    if tables is None:
        return None
    return tables[0] if len(tables) == 1 else torch.cat(tables)


def _route_cn(fact: Dict, dims: Sequence[Dict]):
    """MR¹ shuffle stage: route the keys of every relation of a CN batch
    per its send tables, joined first (:func:`_cn_joined`), -> ``(routed
    fact, [routed dims])``, each ``(keys, mask)``.  ``fact["cols"]``
    (optional) names each CN's columns of the full-width store-resident
    fact key matrix."""
    routed_fact = _route(fact["keys"], _cn_joined(fact["send"]),
                         _cn_joined(fact.get("cols")))
    routed_dims = [_route(d["keys"], _cn_joined(d["send"])) for d in dims]
    return routed_fact, routed_dims


def _mr1_volumes(routed_fact, routed_dims, domains: Tuple[int, ...],
                 accum: AccumPolicy = INT32_CHECKED):
    """MR¹ statistics on routed relations: per-worker num-arrays (combine +
    reduce-side counting), then fact volume and per-dimension vol
    contributions (Algorithm 3 stage 2).  Returns (vol_fact, dim_vols), each
    ``[N, P, rows]`` in the policy dtype; products wrap as the reference's
    do.  On CUDA tensors the hand-written kernels (``kernels/mr1_volumes``),
    on the CPU their plain version."""
    return mr1_volumes(routed_fact, routed_dims, domains, accum.dtype)


def _has_text(rel: Dict) -> bool:
    """Whether a relation carries text for MR² to read, from its ``"text"``
    (a CN batch's list of texts, or one flattened text): a relation of
    width 0 (a fact with no character column, say) adds weight through MR¹
    and no terms, and gets no MR² launch, no address table and no token
    count."""
    text = rel["text"]
    return (text[0] if isinstance(text, list) else text).shape[-1] > 0


def _mr2_histograms(fact: Dict, dims: Sequence[Dict], vol_fact, dim_vols,
                    vocab: int) -> torch.Tensor:
    """MR² by reference on a CN batch's relations and their routed volumes:
    one weighted histogram launch per relation that carries text
    (:func:`routed_histogram`), which reads each routed slot's tokens
    through the relation's send tables, joined, from its texts (``"ptrs"``,
    where given, their resident address table), the workers flattened into
    the row axis, summed -> ``[N, vocab]`` in the volumes' dtype.  A
    relation of width 0 is not read."""
    hists = [routed_histogram(rel["text"], _cn_joined(rel["send"]),
                              w.to(vol_fact.dtype), vocab, rel.get("ptrs"))
             for rel, w in zip((fact, *dims), (vol_fact, *dim_vols))
             if _has_text(rel)]
    return sum(hists[1:], hists[0])


def plan_to_tensors(plan: CNPlan, device) -> Tuple[Dict, List[Dict]]:
    """One plan's materialized host columns as a batch of one CN."""
    def rel(route) -> Dict:
        return {"text": [torch.as_tensor(route.text, device=device)],
                "keys": [torch.as_tensor(route.keys, device=device)],
                "send": [torch.as_tensor(route.send, device=device)[None]]}
    return rel(plan.fact), [rel(plan.dims[i]) for i in plan.included]


def run_cn_plan(plan: CNPlan, mesh: VirtualMesh,
                accum: AccumPolicy = INT32_CHECKED) -> np.ndarray:
    """The per-CN baseline: one plan, host-materialized columns, routing,
    MR¹ and MR² -> freq[vocab] int64 (no wrap check, as in the reference).
    The MR² histograms come back summed over the worker axis, which is the
    reference's per-worker histograms followed by its psum, bit for bit."""
    if mesh.n_workers != plan.n_devices:
        raise ValueError(f"plan built for {plan.n_devices} workers, mesh has "
                         f"{mesh.n_workers}")
    fact, dims = plan_to_tensors(plan, mesh.device)
    vols = _mr1_volumes(*_route_cn(fact, dims),
                        tuple(plan.key_domains[i] for i in plan.included),
                        accum)
    hist = _mr2_histograms(fact, dims, *vols, plan.vocab_size)
    return psum(hist[0].to(accum.dtype)).cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# split two-job execution (the paper's MR1 / MR2 boundary, checkpointable)
# ---------------------------------------------------------------------------

def _device_job1(fact: Dict, dims: Sequence[Dict], *,
                 domains: Tuple[int, ...], accum: AccumPolicy) -> Dict:
    """MR¹ only, for one CN: route + num-arrays + volumes.  Returns the
    vol-array artifact ``{"fact": {"text", "vol"}, "dims": [{"text",
    "vol"}, ...]}`` — the paper's reducer output that MapReduce 2nd
    consumes.  The artifact holds each relation's routed text, gathered
    here (:func:`_routed_text`): it is the boundary the paper spills, so it
    must stand alone.  Each routed ``[1, P(dst), P*C, ...]`` buffer is
    viewed in the reference's global layout ``[P*P*C, ...]``,
    destination-major: the concatenation of the workers' shards."""
    vol_fact, dim_vols = _mr1_volumes(*_route_cn(fact, dims), domains, accum)

    def flat(rel, vol):
        text = _routed_text(rel["text"], _cn_joined(rel["send"]))
        return {"text": text.flatten(0, 2),     # a width-0 text too
                "vol": vol.reshape(-1)}

    return {"fact": flat(fact, vol_fact),
            "dims": [flat(d, w) for d, w in zip(dims, dim_vols)]}


def _device_job2(vol_arrays: Dict, *, vocab: int,
                 accum: AccumPolicy) -> torch.Tensor:
    """MR² only: one weighted histogram per relation of the vol-arrays
    that carries text, summed over workers (the rows of every worker are in
    one axis) -> ``[vocab]`` in the policy dtype."""
    dtype = vol_arrays["fact"]["vol"].dtype
    hists = [weighted_histogram(rel["text"], rel["vol"].to(dtype), vocab)
             for rel in (vol_arrays["fact"], *vol_arrays["dims"])
             if _has_text(rel)]
    return psum(sum(hists[1:], hists[0]).to(accum.dtype))


def _build_job1(sig: PlanSignature, mesh: VirtualMesh):
    """Job 1's program: uploads one plan's padded host arrays
    (``pad_plan_arrays``) as a batch of one CN and runs MR¹."""
    device = mesh.device
    domains = tuple(d.domain for d in sig.dims)

    def upload(rel):
        return {"text": [torch.from_numpy(rel["text"]).to(device)],
                "keys": [torch.from_numpy(rel["keys"]).to(device)],
                "send": [torch.from_numpy(rel["send"]).to(device)[None]]}

    def program(fact, dims):
        with obs_span("fct.job1"):
            return _device_job1(upload(fact), [upload(d) for d in dims],
                                domains=domains, accum=sig.accum)

    return program


def _build_job2(sig: PlanSignature):
    def program(vol_arrays):
        with obs_span("fct.job2"):
            return _device_job2(vol_arrays, vocab=sig.vocab, accum=sig.accum)

    return program


def run_cn_plan_two_jobs(plan: CNPlan, mesh: VirtualMesh,
                         checkpoint_dir: Optional[str] = None,
                         cache: Optional[ExecutableCache] = None,
                         accum: AccumPolicy = INT32_CHECKED) -> np.ndarray:
    """MR¹ -> (optional host checkpoint) -> MR², bit-equal to the fused
    path -> freq[vocab] int64 (no wrap check, as in :func:`run_cn_plan`).

    Both jobs' programs live in the runtime's program cache, keyed by the
    plan's bucketed signature (``("fct_job1", sig, mesh)`` and
    ``("fct_job2", sig, mesh)``), so repeated shapes build nothing.  With
    ``checkpoint_dir`` the vol-array artifact is saved there as step 1 (the
    boundary the paper spills to the DFS) and job 2 runs on what is
    restored from it (spans ``fct.checkpoint_save`` / ``_restore``).  The
    jobs run inside spans ``fct.job1`` / ``fct.job2``, which a recording
    torch profiler sees as ranges of the same names."""
    if mesh.n_workers != plan.n_devices:
        raise ValueError(f"plan built for {plan.n_devices} workers, mesh has "
                         f"{mesh.n_workers}")
    if cache is None:
        cache = default_cache()
    sig = plan_signature(plan, accum=accum)
    fact, dims = pad_plan_arrays(plan, sig)
    job1 = cache.get_or_build(("fct_job1", sig, mesh),
                              lambda: _build_job1(sig, mesh))
    vol_arrays = job1(fact, dims)
    if checkpoint_dir is not None:
        with obs_span("fct.checkpoint_save"):
            save_checkpoint(checkpoint_dir, 1, vol_arrays)
        with obs_span("fct.checkpoint_restore"):
            _, vol_arrays = restore_checkpoint(checkpoint_dir, vol_arrays)
    job2 = cache.get_or_build(("fct_job2", sig, mesh),
                              lambda: _build_job2(sig))
    return job2(vol_arrays).cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# query runner (deprecated shim — the service API lives in repro_torch/api)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FCTResult:
    term_ids: np.ndarray
    freqs: np.ndarray
    all_freqs: np.ndarray
    n_cns: int
    n_joined_cns: int
    shuffle_rows: int
    shuffle_bytes: int
    imbalance: float


def run_fct_query(schema: StarSchema, keywords: Sequence[int], *,
                  r_max: int = 4, k_terms: int = 10,
                  mode: str = "uniform", rho: int = 4,
                  sample_frac: float = 1.0, salt: int = 0,
                  device=None, n_workers: int = 1,
                  stop_mask: Optional[np.ndarray] = None,
                  engine=None) -> FCTResult:
    """End-to-end FCT query (Def. 6) on ``n_workers`` virtual workers on
    ``device`` (``None`` = CUDA).

    .. deprecated::
        Thin shim over :class:`repro_torch.api.FCTSession` — each call
        builds a throwaway session, so tuple sets are re-derived every time.
        Callers issuing more than one query should hold an ``FCTSession``
        (which also offers ``query_batch`` and pipelined ``submit``).
    """
    from repro_torch.api import FCTRequest, FCTSession
    warnings.warn(
        "run_fct_query is deprecated; use repro_torch.api.FCTSession "
        "(query/query_batch/submit)", DeprecationWarning, stacklevel=2)
    with FCTSession(schema, device=device, n_workers=n_workers,
                    engine=engine, stop_mask=stop_mask) as session:
        resp = session.query(FCTRequest(
            keywords=tuple(int(k) for k in keywords), top_k=k_terms,
            r_max=r_max, mode=mode, rho=rho, sample_frac=sample_frac,
            salt=salt))
    return FCTResult(term_ids=resp.term_ids, freqs=resp.freqs,
                     all_freqs=resp.all_freqs, n_cns=resp.n_cns,
                     n_joined_cns=resp.n_joined_cns,
                     shuffle_rows=resp.shuffle_rows,
                     shuffle_bytes=resp.shuffle_bytes,
                     imbalance=resp.imbalance)
