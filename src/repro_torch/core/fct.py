"""The two MapReduce jobs as one fused device program on a virtual mesh
(paper §4.3–§4.4).

MR¹ (statistics): route tuple-set rows per the static plan (gather →
all_to_all → mask), build dense ``num``-arrays per dimension and worker,
probe them per fact row to produce fact volumes and per-dimension ``vol``
contributions.

MR² (term frequency): weighted token histogram of every routed payload with
its volume (the ``fct_count`` kernel on CUDA, its plain version on the CPU),
summed over workers — the "aggregation equal transformation" of Theorem 1 —
then a host-side top-k with the Def. 6 exclusions.

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
accumulator width.

Index semantics follow the reference explicitly, since torch index ops raise
where JAX's clamp or drop: gathers wrap a negative index once and then clamp
(:func:`_clamp_index`); scatter-adds wrap once and drop what is still out of
range (:func:`_scatter_add_drop`).  On the main path every index is in range.

The two jobs are also separable (:func:`run_cn_plan_two_jobs`): job 1
returns the vol-array artifact that job 2 consumes, so the MR¹→MR² boundary
can be checkpointed — the paper's "two MapReduce jobs" as two programs.  The
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
from repro_torch.kernels.fct_count.ops import weighted_histogram
from repro_torch.launch.mesh import VirtualMesh, all_to_all, psum
from repro_torch.obs import span as obs_span
from repro_torch.runtime.batch import (PlanSignature, pad_plan_arrays,
                                       plan_signature)
from repro_torch.runtime.cache import ExecutableCache, default_cache


def _clamp_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Gather index under JAX semantics: negative counts from the end
    (once), then out-of-range clamps to the edge."""
    idx = torch.where(idx < 0, idx + size, idx)
    return idx.clamp(0, size - 1)


def _scatter_add_drop(target: torch.Tensor, dim: int, idx: torch.Tensor,
                      src: torch.Tensor) -> None:
    """In-place ``target.scatter_add_`` under ``.at[].add(mode="drop")``
    semantics: negative counts from the end (once); indices still outside
    ``[0, size)`` add nothing."""
    size = target.shape[dim]
    idx = torch.where(idx < 0, idx + size, idx)
    ok = (idx >= 0) & (idx < size)
    # fct-lint: waive[R2] -- every caller allocates target with an explicit dtype (num, contrib in _mr1_volumes)
    target.scatter_add_(dim, torch.where(ok, idx, 0),
                        torch.where(ok, src, torch.zeros_like(src)))


def _route(texts: Sequence[torch.Tensor], keys: Sequence[torch.Tensor],
           send: torch.Tensor, cols: Optional[torch.Tensor] = None):
    """Gather rows into per-destination buffers and all_to_all them, for a
    batch of N CNs.

    ``texts[n]`` is CN n's ``[P, S, L]`` text, ``keys[n]`` its ``[P, S]``
    (dim) or ``[P, S, m_all]`` (fact) keys — separate tensors, so CNs over
    one store-resident tuple set share it without a stacked copy.  ``send``
    is ``[N, P(src), P(dst), C]`` (local row index, -1 pad); ``cols``
    ``[N, m]`` selects each CN's fact key columns.  Returns the received
    ``(text [N, P, P*C, L], keys [N, P, P*C(, m)], mask [N, P, P*C])``.
    """
    N, P, _, C = send.shape
    S, L = texts[0].shape[1:]
    dev = send.device
    send_t = all_to_all(send).long()           # [N, dst, src, C]
    mask = (send_t >= 0).reshape(N, P, P * C)
    # a valid plan names rows in [0, S) only; -1 pads are masked, and the
    # clamp keeps every gather in bounds
    local = send_t.clamp(0, S - 1)
    flat = (torch.arange(P, device=dev).view(1, 1, P, 1) * S
            + local).reshape(N, P * P * C)
    rtext = torch.empty((N, P * P * C, L), dtype=texts[0].dtype, device=dev)
    k_tail = keys[0].shape[2:] if cols is None else (cols.shape[1],)
    rkeys = torch.empty((N, P * P * C) + tuple(k_tail), dtype=keys[0].dtype,
                        device=dev)
    for n in range(N):
        torch.index_select(texts[n].reshape(P * S, L), 0, flat[n],
                           out=rtext[n])
        k = keys[n].reshape((P * S,) + tuple(keys[n].shape[2:]))
        if cols is None:
            torch.index_select(k, 0, flat[n], out=rkeys[n])
        else:
            rkeys[n] = k.index_select(0, flat[n]).index_select(
                1, _clamp_index(cols[n].long(), k.shape[1]))
    return (rtext.view(N, P, P * C, L),
            rkeys.view((N, P, P * C) + tuple(k_tail)), mask)


def _cn_joined(tables):
    """A CN batch's tables as one ``[N, ...]`` tensor: a stacked tensor as
    it is, a list of ``[1, ...]`` tables (the store path's per-plan resident
    ones) joined along the CN axis on the device, a list of one as that
    table."""
    if isinstance(tables, torch.Tensor) or tables is None:
        return tables
    return tables[0] if len(tables) == 1 else torch.cat(tables)


def _cn_extent(send) -> Tuple[int, int]:
    """(CNs, routed row slots ``N * P * P * C``) of a batch's send tables,
    stacked or as a list."""
    tables = [send] if isinstance(send, torch.Tensor) else send
    return (sum(t.shape[0] for t in tables), sum(t.numel() for t in tables))


def _route_cn(fact: Dict, dims: Sequence[Dict]):
    """MR¹ shuffle stage: route every relation of a CN batch per its send
    tables, joined first if they come as a list (:func:`_cn_joined`).
    ``fact["cols"]`` (optional) names each CN's columns of the full-width
    store-resident fact key matrix."""
    routed_fact = _route(fact["text"], fact["keys"], _cn_joined(fact["send"]),
                         _cn_joined(fact.get("cols")))
    routed_dims = [_route(d["text"], d["keys"], _cn_joined(d["send"]))
                   for d in dims]
    return routed_fact, routed_dims


def _mr1_volumes(routed_fact, routed_dims, domains: Tuple[int, ...],
                 accum: AccumPolicy = INT32_CHECKED):
    """MR¹ statistics on routed relations: per-worker num-arrays (combine +
    reduce-side counting), then fact volume and per-dimension vol
    contributions (Algorithm 3 stage 2).  Returns (vol_fact, dim_vols), each
    ``[N, P, rows]`` in the policy dtype; products wrap as the reference's
    do."""
    acc = accum.dtype
    _, fkeys, fmask = routed_fact
    N, P = fmask.shape[:2]
    dev = fmask.device
    m = len(routed_dims)
    nums = []
    for (_, dkeys, dmask), dom in zip(routed_dims, domains):
        num = torch.zeros((N, P, dom), dtype=torch.int32, device=dev)
        _scatter_add_drop(num, 2, dkeys.long(), dmask.to(torch.int32))
        nums.append(num)
    fk = [fkeys[..., i].long() for i in range(m)]
    probes = [nums[i].gather(2, _clamp_index(fk[i], domains[i])).to(acc)
              for i in range(m)]
    fvalid = fmask.to(acc)
    vol_fact = fvalid
    for pr in probes:
        vol_fact = vol_fact * pr
    dim_vols = []
    for i in range(m):
        others = fvalid
        for j in range(m):
            if j != i:
                others = others * probes[j]
        contrib = torch.zeros((N, P, domains[i]), dtype=acc, device=dev)
        _scatter_add_drop(contrib, 2, fk[i], others)
        _, dkeys, dmask = routed_dims[i]
        dim_vols.append(
            contrib.gather(2, _clamp_index(dkeys.long(), domains[i]))
            * dmask.to(acc))
    return vol_fact, dim_vols


def _mark(marks) -> None:
    """Record the next stage boundary on the device stream, if asked."""
    if marks is not None:
        marks.record()


def _mr2_histograms(routed_fact, routed_dims, vol_fact, dim_vols,
                    vocab: int) -> torch.Tensor:
    """MR² on routed relations and their volumes: one weighted histogram
    launch per relation, the workers flattened into the row axis, summed
    -> ``[N, vocab]``."""
    ftext = routed_fact[0]
    N, L = ftext.shape[0], ftext.shape[-1]
    hist = weighted_histogram(ftext.reshape(N, -1, L),
                              vol_fact.reshape(N, -1), vocab)
    for (dtext, _, _), w in zip(routed_dims, dim_vols):
        hist = hist + weighted_histogram(
            dtext.reshape(N, -1, dtext.shape[-1]),
            w.to(hist.dtype).reshape(N, -1), vocab)
    return hist


def _device_fct_local(fact: Dict, dims: Sequence[Dict], *,
                      domains: Tuple[int, ...], vocab: int,
                      accum: AccumPolicy = INT32_CHECKED,
                      marks=None) -> torch.Tensor:
    """MR¹+MR² for a batch of N CNs -> ``[N, vocab]`` histograms in the
    policy dtype, summed over the worker axis (the reference's per-worker
    histograms followed by its psum, bit for bit).

    Each stage runs inside an obs span on the active trace — ``fct.route``,
    ``fct.mr1``, ``fct.mr2``, args ``n_cns`` and ``rows`` (the fact's routed
    row slots, ``N * P * P * C``) — which times the host's enqueueing of
    it; the kernels themselves run later on the device.  ``marks`` (the
    engine's, on CUDA) gets ``record()`` at the end of each stage, which
    puts a timing event on the current stream: the device time of each
    stage is the distance between two such events."""
    n_cns, rows = _cn_extent(fact["send"])
    with obs_span("fct.route", n_cns=n_cns, rows=rows):
        routed_fact, routed_dims = _route_cn(fact, dims)
        _mark(marks)
    with obs_span("fct.mr1", n_cns=n_cns, rows=rows):
        vol_fact, dim_vols = _mr1_volumes(routed_fact, routed_dims, domains,
                                          accum)
        _mark(marks)
    with obs_span("fct.mr2", n_cns=n_cns, rows=rows):
        hist = _mr2_histograms(routed_fact, routed_dims, vol_fact, dim_vols,
                               vocab)
        _mark(marks)
    return hist


def plan_to_tensors(plan: CNPlan, device) -> Tuple[Dict, List[Dict]]:
    """One plan's materialized host columns as a batch of one CN."""
    def rel(route) -> Dict:
        return {"text": [torch.as_tensor(route.text, device=device)],
                "keys": [torch.as_tensor(route.keys, device=device)],
                "send": torch.as_tensor(route.send, device=device)[None]}
    return rel(plan.fact), [rel(plan.dims[i]) for i in plan.included]


def run_cn_plan(plan: CNPlan, mesh: VirtualMesh,
                accum: AccumPolicy = INT32_CHECKED) -> np.ndarray:
    """The per-CN baseline: one plan, host-materialized columns, one
    program -> freq[vocab] int64 (no wrap check, as in the reference)."""
    if mesh.n_workers != plan.n_devices:
        raise ValueError(f"plan built for {plan.n_devices} workers, mesh has "
                         f"{mesh.n_workers}")
    fact, dims = plan_to_tensors(plan, mesh.device)
    hist = _device_fct_local(
        fact, dims, domains=tuple(plan.key_domains[i] for i in plan.included),
        vocab=plan.vocab_size, accum=accum)
    return psum(hist[0].to(accum.dtype)).cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# split two-job execution (the paper's MR1 / MR2 boundary, checkpointable)
# ---------------------------------------------------------------------------

def _device_job1(fact: Dict, dims: Sequence[Dict], *,
                 domains: Tuple[int, ...], accum: AccumPolicy) -> Dict:
    """MR¹ only, for one CN: route + num-arrays + volumes.  Returns the
    vol-array artifact ``{"fact": {"text", "vol"}, "dims": [{"text",
    "vol"}, ...]}`` — the paper's reducer output that MapReduce 2nd
    consumes.  Each routed ``[1, P(dst), P*C, ...]`` buffer is viewed in the
    reference's global layout ``[P*P*C, ...]``, destination-major: the
    concatenation of the workers' shards."""
    routed_fact, routed_dims = _route_cn(fact, dims)
    vol_fact, dim_vols = _mr1_volumes(routed_fact, routed_dims, domains,
                                      accum)

    def flat(text, vol):
        return {"text": text.reshape((-1,) + tuple(text.shape[3:])),
                "vol": vol.reshape(-1)}

    return {"fact": flat(routed_fact[0], vol_fact),
            "dims": [flat(dtext, w)
                     for (dtext, _, _), w in zip(routed_dims, dim_vols)]}


def _device_job2(vol_arrays: Dict, *, vocab: int,
                 accum: AccumPolicy) -> torch.Tensor:
    """MR² only: one weighted histogram per relation of the vol-arrays,
    summed over workers (the rows of every worker are in one axis) ->
    ``[vocab]`` in the policy dtype."""
    fact = vol_arrays["fact"]
    hist = weighted_histogram(fact["text"], fact["vol"], vocab)
    for d in vol_arrays["dims"]:
        hist = hist + weighted_histogram(d["text"], d["vol"].to(hist.dtype),
                                         vocab)
    return psum(hist.to(accum.dtype))


def _build_job1(sig: PlanSignature, mesh: VirtualMesh):
    """Job 1's program: uploads one plan's padded host arrays
    (``pad_plan_arrays``) as a batch of one CN and runs MR¹."""
    device = mesh.device
    domains = tuple(d.domain for d in sig.dims)

    def upload(rel):
        return {"text": [torch.from_numpy(rel["text"]).to(device)],
                "keys": [torch.from_numpy(rel["keys"]).to(device)],
                "send": torch.from_numpy(rel["send"]).to(device)[None]}

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
