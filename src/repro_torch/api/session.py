"""FCTSession: the long-lived service object of the FCT engine.

The paper's workload is *online* keyword refinement — many small queries
against one loaded dataset.  A session binds everything that is per-dataset
(schema, tokenizer/stop list, device and virtual worker mesh, runtime engine
with its program cache) and memoizes everything that repeats across queries:

  * tuple sets per keyword set (one host data pass each),
  * CN enumerations per (n_keywords, r_max),
  * routing plans per request shape,
  * built programs, via the engine's shape-bucketed LRU cache,
  * device-resident tuple-set columns, via the session's RelationStore: the
    big ``text``/``keys`` arrays are uploaded to the device once per tuple
    set (``store_uploads``/``store_hits`` counters; ``invalidate()`` drops
    the store and the derived host caches after a data mutation),
  * each cached plan's routing tables on the device, uploaded at its first
    dispatch and dropped with the plan, so warm dispatches ship nothing
    (``send_uploads``/``send_hits`` counters).

Three execution paths:

  ``query(req)``          sync: plan + dispatch + top-k, one request.
  ``query_batch(reqs)``   same-signature plans from *different* requests are
                          stacked through one device dispatch (the engine's
                          per-CN output axis attributes results back).
  ``submit(req)``         returns a Future; a plan/dispatch/finalize pipeline
                          overlaps host-side planning of query k+1 with
                          device execution of query k (FIFO completion).

``append(relation, rows)`` grows one relation by a chunk and keeps the
session warm; ``delta_freq`` is the exact histogram of the new chunk, which
the serving gateway adds to its memoized results.

Spans (``repro_torch.obs``) on each request's trace: ``plan`` with children
``plan.tuple_sets`` (a tuple-set miss), ``plan.cns`` (CN enumeration and
pruning), one ``plan.cn_plan`` per ``build_cn_plan`` and one
``plan.map_only`` per single-relation CN — none on a plan-cache hit — then
``dispatch`` (the engine's ``engine.dispatch_group`` spans beside it on the
batch leader's trace), ``collect`` and ``finalize``.  An append records
``session.append`` (and each ``delta_freq`` a ``session.delta_freq``) on the
caller's active trace, or on a trace of its own.

The session runs on the card unless the caller asks for the CPU:
``device=None`` means CUDA, and asking for CUDA where there is none raises.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.pipeline import QueryPipeline
from repro_torch.api.request import AppendResult, FCTRequest, FCTResponse
from repro_torch.core.accum import AccumPolicy
from repro_torch.core.candidate_network import (StarCN, TupleSets,
                                                enumerate_star_cns,
                                                prune_empty_cns)
from repro_torch.core.plan import CNPlan, build_cn_plan
from repro_torch.core.star import topk_terms
from repro_torch.data.schema import (PAD_ID, StarSchema, keyword_mask,
                                     tokens_histogram)
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.obs import (Trace, current_trace, default_registry,
                             maybe_activate)
from repro_torch.obs import span as obs_span
from repro_torch.runtime.cache import ExecutableCache, LruDict
from repro_torch.runtime.engine import FCTEngine, default_engine
from repro_torch.runtime.store import RelationStore

_ENGINE_COUNTERS = ("hits", "misses", "traces", "evictions",
                    "batches_run", "cns_run", "bytes_shipped",
                    "store_uploads", "store_hits",
                    "store_upload_bytes", "store_chunk_assembles",
                    "device_to_host_bytes", "groups_pruned", "pruned_rows",
                    "fct_count_tokens", "send_uploads", "send_hits",
                    "route_slots", "route_rows", "graph_eager",
                    "graph_captures", "graph_replays")


def _cn_includes(cn: StarCN, role: str, dim_index: int) -> bool:
    """Does the CN's join tree contain the mutated relation?  A CN that
    doesn't is untouched by an append — its delta is exactly zero, so the
    delta dispatch skips it (running it would wrongly re-count its FULL
    histogram, since its tuple sets carry no append boundary)."""
    if role == "fact":
        return cn.single_dim < 0
    return cn.single_dim == dim_index or (
        cn.single_dim < 0 and cn.dim_masks[dim_index] is not None)


def _delta_tuple_sets(ts: TupleSets, role: str, dim_index: int,
                      base_rows: int) -> TupleSets:
    """Tuple sets restricted to the rows appended after ``base_rows``.

    The mutated relation's first ``base_rows`` keyword masks are set to a
    ``-1`` sentinel that matches no CN label (labels are exact-subset masks
    ``>= 0``), so every row lookup sees only the new chunk while the OTHER
    relations keep their full tuple sets — exactly the join terms of
    freq(base + chunk) - freq(base), which is what makes histogram patch-up
    by integer addition exact."""
    if role == "fact":
        fk = ts.fact_kw.copy()
        fk[:base_rows] = -1
        return TupleSets(fact_kw=fk, dim_kw=ts.dim_kw, full=ts.full)
    dk = list(ts.dim_kw)
    arr = dk[dim_index].copy()
    arr[:base_rows] = -1
    dk[dim_index] = arr
    return TupleSets(fact_kw=ts.fact_kw, dim_kw=dk, full=ts.full)


def _traced_cn_plan(schema: StarSchema, ts: TupleSets, cn: StarCN,
                    n_devices: int, **knobs) -> Optional[CNPlan]:
    """``build_cn_plan`` inside a ``plan.cn_plan`` span.  Args: ``n_rel``,
    ``fact_rows``, ``shuffle_rows``, and the shuffle's shape: ``rho``,
    ``tasks``, ``row_imbalance`` (achieved max/mean fact rows a worker),
    ``dim_rows`` (the dimensions' tuple-set rows) and ``dim_sent`` (the
    dimension rows sent, replicas included).  A single-relation CN has no
    plan and records only ``n_rel`` and 0 rows."""
    with obs_span("plan.cn_plan", n_rel=cn.n_relations()) as sp:
        plan = build_cn_plan(schema, ts, cn, n_devices, **knobs)
        if plan is None:
            sp.args.update(fact_rows=0, shuffle_rows=0)
        else:
            dims = [plan.dims[i] for i in plan.included]
            sp.args.update(
                fact_rows=plan.fact.ref.n_rows,
                shuffle_rows=plan.shuffle_rows, rho=plan.rho,
                tasks=len(plan.schedule.task_to_device),
                row_imbalance=plan.row_imbalance,
                dim_rows=sum(d.ref.n_rows for d in dims),
                dim_sent=sum(d.sent_rows for d in dims))
    return plan


def _map_only_freq(schema: StarSchema, ts: TupleSets,
                   cn: StarCN) -> np.ndarray:
    """Word count of a single-relation CN's tuple-set rows (no shuffle),
    inside a ``plan.map_only`` span."""
    with obs_span("plan.map_only") as sp:
        fact_idx, dim_idx = ts.cn_rows(cn)
        if fact_idx is not None:
            text = schema.fact.text[fact_idx]
        else:
            (i, rows), = dim_idx.items()
            text = schema.dims[i].text[rows]
        sp.args["rows"] = int(text.shape[0])
        return tokens_histogram(text, np.ones(text.shape[0], np.int64),
                                schema.vocab_size)


@dataclasses.dataclass
class SessionConfig:
    """Per-session knobs (everything requests should not have to carry)."""

    adaptive_rho: bool = False          # balance pass: plan default
                                        # ("uniform") requests with
                                        # mode="adaptive" (multi-worker
                                        # meshes; a no-op on 1 worker)
    accum_policy: str = "auto"          # "auto"/"int32" (int32-checked) or
                                        # "int64" (int64-exact); resolved at
                                        # session init and advertised on
                                        # every FCTResponse
    cache_max_entries: Optional[int] = None  # LRU cap for a session-owned engine
    plan_cache_size: int = 32           # LRU cap on cached routing plans per
                                        # request shape (0 disables)
    tuple_set_cache_size: int = 16      # LRU cap on cached tuple sets per
                                        # keyword set
    pipeline_queue_depth: int = 64      # bound on in-flight submit() requests
    store_max_bytes: Optional[int] = None  # byte budget for the session's
                                        # device-resident relation store
                                        # (None = unbounded)
    device_topk: bool = False           # finalize single-query dispatches
                                        # with the fct_topk program: the
                                        # histogram stays device-resident and
                                        # only O(k) candidates transfer.
                                        # Responses carry all_freqs=None
                                        # (finalize="device_topk"); requests
                                        # needing the histogram set
                                        # need_histogram=True.  Multi-query
                                        # stacked batches keep the host path
    topk_prune: str = "zero"            # cross-CN-group pruning on the topk
                                        # path: "off", "zero" (bit-exact,
                                        # skip provably-empty groups) or
                                        # "threshold" (set-exact counts-
                                        # lower-bound suffix cut; opt-in) —
                                        # see FCTEngine.dispatch_topk


@dataclasses.dataclass
class _PlannedQuery:
    """Host-side planning artifact: everything but the device dispatch."""

    request: FCTRequest
    keywords: Tuple[int, ...]
    plans: List[CNPlan]
    host_freq: np.ndarray               # map-only (single-relation) CNs
    n_cns: int
    shuffle_rows: int
    shuffle_bytes: int
    imbalance: float
    row_imbalance: float
    plan_ms: float
    trace: Optional[Trace] = None       # per-request span tree; None while
    #                                     the artifact sits in the plan cache
    #                                     (each hit re-binds its own trace)
    #: session data epoch the plan's tuple sets / schema snapshot belong to;
    #: stamped onto the response so callers can fence against appends
    data_epoch: int = 0


@dataclasses.dataclass
class _InFlight:
    """Queries whose device work is enqueued but not yet transferred.

    ``pending`` is the engine's async handle (None if every CN was map-only);
    ``individual`` marks the per-CN-output program family (shared dispatches
    across several queries) vs the summed single-query family.
    """

    planned: List[_PlannedQuery]
    owners: np.ndarray                  # plan index -> owning query index
    pending: Optional[list]
    individual: bool
    n_plans: int
    #: engine/store counter snapshot taken before dispatch; the per-response
    #: delta is computed after collection, so transfer-side counters
    #: (device_to_host_bytes) are attributed to the query too
    engine_before: Dict[str, int]
    dispatch_ms: float
    topk: Optional[object] = None       # TopkPending on the device-topk path
    #: the dispatched groups' device-stage events (CUDA only), resolved by
    #: ``FCTEngine.device_stage_ms`` after the collection's wait
    stages: list = dataclasses.field(default_factory=list)


class FCTSession:
    """Serving front door for FCT queries over one star schema.

    ``device`` (``None`` = CUDA) and ``n_workers`` (P, default 1) define the
    virtual worker mesh.  ``engine=None`` uses the process-wide engine
    (shared program cache) unless ``config.cache_max_entries`` is set, in
    which case the session owns a fresh engine with an LRU-capped cache.
    ``stop_mask`` defaults to the tokenizer's stop list (plus PAD) when a
    tokenizer is given.
    """

    def __init__(self, schema: StarSchema, *, device=None, n_workers: int = 1,
                 tokenizer=None, engine=None,
                 config: Optional[SessionConfig] = None,
                 stop_mask: Optional[np.ndarray] = None,
                 metrics=None) -> None:
        self.schema = schema
        self.tokenizer = tokenizer
        self.config = config if config is not None else SessionConfig()
        # the metrics registry (or a labeled per-tenant facade from the
        # gateway) every session-owned component registers into
        self.metrics = metrics if metrics is not None else default_registry()
        # resolved once: every dispatch of this session accumulates under
        # one policy, so the response-level precision advertisement is stable
        self.accum_policy = AccumPolicy.resolve(self.config.accum_policy)
        self.mesh = make_worker_mesh(n_workers, device)
        self.device = self.mesh.device
        self._n_dev = self.mesh.size
        if engine is None:
            if self.config.cache_max_entries is not None:
                engine = FCTEngine(cache=ExecutableCache(
                    max_entries=self.config.cache_max_entries,
                    metrics=self.metrics), metrics=self.metrics)
            else:
                engine = default_engine()
        elif self.config.cache_max_entries is not None:
            raise ValueError(
                "pass either an explicit engine or "
                "config.cache_max_entries, not both — the cap only applies "
                "to a session-owned engine's cache")
        self.engine = engine
        # device-resident tuple-set columns: uploaded once per (session,
        # tuple set), referenced by every dispatch; dropped by invalidate()
        self.store = RelationStore(self.mesh,
                                   max_bytes=self.config.store_max_bytes,
                                   metrics=self.metrics)
        if stop_mask is None and tokenizer is not None:
            stop_mask = tokenizer.stop_mask()
        self.stop_mask = stop_mask
        self._tuple_sets: LruDict = LruDict(self.config.tuple_set_cache_size)
        # bumped by invalidate()/append() under _plan_lock: tuple sets /
        # plans built from pre-mutation data must not re-enter the caches
        # afterwards (same fence as RelationStore.epoch /
        # ResultCache.generation)
        self._data_epoch = 0
        self._cn_lists: Dict[Tuple[int, int], List[StarCN]] = {}
        self._plan_cache: LruDict = LruDict(
            self.config.plan_cache_size if self.config.plan_cache_size > 0
            else None)  # unreachable when 0: _plan short-circuits
        if self.config.topk_prune not in ("off", "zero", "threshold"):
            raise ValueError(
                "topk_prune must be 'off', 'zero' or 'threshold', got "
                f"{self.config.topk_prune!r}")
        # device-topk path state: the stop/PAD exclusion vector is uploaded
        # once per session; map-only (single-relation CN) histograms are
        # uploaded once per plan-cache key and dropped by invalidate()
        self._excl_dev = None
        self._hf_dev: LruDict = LruDict(
            self.config.plan_cache_size if self.config.plan_cache_size > 0
            else 8)
        self._plan_lock = threading.Lock()    # planner thread vs sync query()
        self._engine_lock = threading.Lock()  # sync query() vs pipeline
        self._pipeline_lock = threading.Lock()  # lazy init vs close()
        self._pipeline: Optional[QueryPipeline] = None
        self._c_queries = self.metrics.counter("session.queries_served")
        self._c_ts_hits = self.metrics.counter("session.tuple_set_hits")
        self._c_ts_misses = self.metrics.counter("session.tuple_set_misses")
        self._c_plan_hits = self.metrics.counter("session.plan_hits")
        self._c_plan_misses = self.metrics.counter("session.plan_misses")
        self._c_appends = self.metrics.counter("session.appends")
        self._c_delta_rows = self.metrics.counter("session.delta_rows")

    # -- keyword / cache plumbing -------------------------------------------

    def resolve_keywords(self, keywords: Sequence) -> Tuple[int, ...]:
        """Strings -> term ids through the tokenizer; ints pass through."""
        out = []
        for kw in keywords:
            if isinstance(kw, str):
                if self.tokenizer is None:
                    raise ValueError(
                        f"string keyword {kw!r} needs a session tokenizer")
                ids = self.tokenizer.encode(kw, 1)
                out.append(int(ids[0]))
            else:
                out.append(int(kw))
        return tuple(out)

    def _get_tuple_sets(
            self, keywords: Tuple[int, ...]
    ) -> Tuple[TupleSets, StarSchema, int]:
        """(tuple sets, schema, data epoch) — one CONSISTENT triple.

        All three are read (or installed) under ``_plan_lock``, the same
        critical section ``append``/``invalidate`` mutate them in, so the
        caller plans one epoch's snapshot end to end even while mutations
        land concurrently: the returned schema is exactly the one the tuple
        sets were built over.  Schema objects are immutable (``append``
        REPLACES ``self.schema``; old row arrays are never resized), so a
        pre-append snapshot stays valid after the session moves on — it is
        served, its caching is fenced by the epoch."""
        with self._plan_lock:
            ts = self._tuple_sets.hit(keywords)
            if ts is not None:
                self._c_ts_hits.inc()
                return ts, self.schema, self._data_epoch
            epoch, schema = self._data_epoch, self.schema
        with obs_span("plan.tuple_sets", n_keywords=len(keywords)):
            ts = TupleSets.build(schema, keywords)  # outside the lock
        self._c_ts_misses.inc()
        with self._plan_lock:
            if self._data_epoch != epoch:  # mutated mid-build: serve the
                return ts, schema, epoch   # old snapshot, cache nothing
            return self._tuple_sets.put(keywords, ts), schema, epoch

    def _get_cns(self, n_keywords: int, r_max: int) -> List[StarCN]:
        key = (n_keywords, r_max)
        with self._plan_lock:
            cns = self._cn_lists.get(key)
        if cns is None:
            cns = enumerate_star_cns(n_keywords, self.schema.m, r_max)
            with self._plan_lock:
                cns = self._cn_lists.setdefault(key, cns)
        return cns

    # -- planning / execution stages ----------------------------------------

    def _plan(self, req: FCTRequest,
              trace: Optional[Trace] = None) -> _PlannedQuery:
        """Host side of one query: tuple sets, CN pruning, routing plans and
        the map-only histogram of single-relation CNs.

        Every request gets its obs :class:`Trace` here (unless the caller —
        the gateway — started one at its edge and passed it in); the
        ``plan`` span covers this whole stage and the finished trace rides
        the response.

        Planned queries are memoized per (keywords, planning knobs) — the
        serving workload repeats requests, and replanning is pure recompute.
        ``top_k`` is excluded from the key (it only affects the final
        selection), so a cache hit is re-bound to the incoming request (and
        to its own trace: artifacts are cached trace-less).
        """
        if trace is None:
            trace = Trace()
        t0 = time.perf_counter()
        with trace.activate(), obs_span(
                "plan", n_keywords=len(req.keywords)) as sp:
            kws = self.resolve_keywords(req.keywords)
            if self.config.plan_cache_size <= 0:
                sp.args["plan_cached"] = False
                return dataclasses.replace(
                    self._plan_resolved(req, kws, t0), trace=trace)
            key = (kws, req.r_max, req.mode, req.rho, req.sample_frac,
                   req.salt)
            with self._plan_lock:
                cached = self._plan_cache.hit(key)
                if cached is None:
                    epoch = self._data_epoch
            sp.args["plan_cached"] = cached is not None
            if cached is not None:
                self._c_plan_hits.inc()
                return dataclasses.replace(
                    cached, request=req, trace=trace,
                    plan_ms=(time.perf_counter() - t0) * 1e3)
            self._c_plan_misses.inc()
            planned = self._plan_resolved(req, kws, t0)
            with self._plan_lock:
                if self._data_epoch == epoch:  # else invalidated mid-planning
                    self._plan_cache.put(key, planned)
            return dataclasses.replace(planned, trace=trace)

    def _plan_resolved(self, req: FCTRequest, kws: Tuple[int, ...],
                       t0: float) -> _PlannedQuery:
        # plan against the tuple sets' OWN schema snapshot, not self.schema:
        # an append landing mid-plan must not mix pre-append tuple sets with
        # post-append row arrays (torn read) — the snapshot pins one epoch
        ts, schema, epoch = self._get_tuple_sets(kws)
        with obs_span("plan.cns") as sp:
            cns = prune_empty_cns(self._get_cns(len(kws), req.r_max), ts)
            sp.args["n_cns"] = len(cns)
        host_freq = np.zeros((schema.vocab_size,), np.int64)
        plans: List[CNPlan] = []
        shuffle_rows = shuffle_bytes = 0
        imbalance, row_imb, dominant_cost = 1.0, 1.0, -1.0
        # the session-level balance pass upgrades default requests: per-CN
        # adaptive rho + LPT instead of the uniform hash grid (explicit
        # skew/round_robin/adaptive requests are forwarded untouched)
        mode = req.mode
        if mode == "uniform" and self.config.adaptive_rho:
            mode = "adaptive"
        for cn in cns:
            plan = _traced_cn_plan(schema, ts, cn, self._n_dev,
                                   mode=mode, rho=req.rho,
                                   sample_frac=req.sample_frac,
                                   salt=req.salt)
            if plan is None:
                # single-relation CN: a map-only word-count (no shuffle)
                host_freq += _map_only_freq(schema, ts, cn)
                continue
            plans.append(plan)
            shuffle_rows += plan.shuffle_rows
            shuffle_bytes += plan.shuffle_bytes
            # report balance of the dominant (most expensive) CN
            total = float(plan.schedule.device_cost.sum())
            if total > dominant_cost:
                dominant_cost, imbalance = total, plan.schedule.imbalance
                row_imb = plan.row_imbalance
        plan_ms = (time.perf_counter() - t0) * 1e3
        return _PlannedQuery(request=req, keywords=kws, plans=plans,
                             host_freq=host_freq, n_cns=len(cns),
                             shuffle_rows=shuffle_rows,
                             shuffle_bytes=shuffle_bytes,
                             imbalance=imbalance, row_imbalance=row_imb,
                             plan_ms=plan_ms, data_epoch=epoch)

    def _host_freq_device(self, planned: _PlannedQuery):
        """Device-resident copy of a planned query's map-only histogram, or
        None when it is all zeros.  Uploaded once per plan-cache key in the
        engine's aggregation layout and accumulation dtype (the device-topk
        path adds it to the group total on the device), reused across warm
        repeats and epoch-fenced like every data-derived cache."""
        hf = planned.host_freq
        if not hf.any():
            return None
        req = planned.request
        # the key carries the plan's data epoch: a query planned before an
        # append and dispatched after it must neither read nor install the
        # other epoch's map-only histogram
        key = (planned.keywords, req.r_max, req.mode, req.rho,
               req.sample_frac, req.salt, self.accum_policy.name,
               planned.data_epoch)
        with self._plan_lock:
            arr = self._hf_dev.hit(key)
        if arr is not None:
            return arr
        acc = np.int64 if self.accum_policy.bits == 64 else np.int32
        cast = hf.astype(acc)
        # wrap check at upload time: a map-only total past the policy width
        # would poison the device sum silently (same best-effort negative
        # check as host collection)
        self.accum_policy.check_totals(cast)
        arr = self.engine.vocab_device_vector(cast, self.mesh, acc)
        with self._plan_lock:
            if self._data_epoch == planned.data_epoch:  # else stale: serve
                self._hf_dev.put(key, arr)              # once, cache nothing
        return arr

    def _engine_snapshot(self) -> Dict[str, int]:
        st = dict(self.engine.stats())
        st.update(self.store.stats())
        return {k: st.get(k, 0) for k in _ENGINE_COUNTERS}

    def _engine_delta(self, before: Dict[str, int]) -> Dict[str, int]:
        after = self._engine_snapshot()
        return {k: after[k] - before[k] for k in _ENGINE_COUNTERS}

    def decode_terms(self, ids: np.ndarray) -> List[str]:
        """The terms of ``ids``: the tokenizer's words, else ``<id>``."""
        if self.tokenizer is not None:
            return [self.tokenizer.decode(t) for t in ids]
        return [f"<{int(t)}>" for t in ids]

    def _respond(self, planned: _PlannedQuery, *, terms, ids, f, all_freqs,
                 finalize: str, engine_stats: Dict[str, int],
                 plan_ms: float, dispatch_ms: float, collect_ms: float,
                 t0: float, t0_ns: int,
                 device_ms: Optional[Dict[str, float]] = None) -> FCTResponse:
        """Shared response assembly of both finalize paths; ``device_ms``
        (the device-stage times, on the batch leader only) joins the
        timings."""
        req = planned.request
        # responses are built on finalizer, flush-pool and sync-caller
        # threads concurrently — the registry-owned counter never loses
        # updates
        self._c_queries.inc()
        finalize_ms = (time.perf_counter() - t0) * 1e3
        if planned.trace is not None:
            planned.trace.add_span("finalize", t0_ns,
                                   time.perf_counter_ns() - t0_ns,
                                   top_k=req.top_k, finalize=finalize)
        execute_ms = dispatch_ms + collect_ms + finalize_ms
        return FCTResponse(
            terms=terms, term_ids=ids, freqs=f, all_freqs=all_freqs,
            n_cns=planned.n_cns, n_joined_cns=len(planned.plans),
            shuffle_rows=planned.shuffle_rows,
            shuffle_bytes=planned.shuffle_bytes,
            imbalance=planned.imbalance,
            row_imbalance=planned.row_imbalance,
            timings={"plan_ms": round(plan_ms, 3),
                     "dispatch_ms": round(dispatch_ms, 3),
                     "collect_ms": round(collect_ms, 3),
                     "finalize_ms": round(finalize_ms, 3),
                     "execute_ms": round(execute_ms, 3),
                     "total_ms": round(plan_ms + execute_ms, 3),
                     **(device_ms or {})},
            engine_stats=engine_stats,
            cold=engine_stats.get("traces", 0) > 0,
            accum_policy=self.accum_policy.name,
            finalize=finalize, data_epoch=planned.data_epoch,
            request=req, trace=planned.trace)

    def _finish(self, planned: _PlannedQuery, freq: np.ndarray,
                engine_stats: Dict[str, int], plan_ms: float,
                dispatch_ms: float, collect_ms: float,
                device_ms: Optional[Dict[str, float]] = None) -> FCTResponse:
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        req = planned.request
        freq[PAD_ID] = 0
        ids, f = topk_terms(freq, planned.keywords, req.top_k, self.stop_mask)
        return self._respond(planned, terms=self.decode_terms(ids), ids=ids,
                             f=f, all_freqs=freq, finalize="host",
                             engine_stats=engine_stats, plan_ms=plan_ms,
                             dispatch_ms=dispatch_ms, collect_ms=collect_ms,
                             t0=t0, t0_ns=t0_ns, device_ms=device_ms)

    def _finish_topk(self, planned: _PlannedQuery, ids: np.ndarray,
                     counts: np.ndarray, engine_stats: Dict[str, int],
                     plan_ms: float, dispatch_ms: float,
                     collect_ms: float,
                     device_ms: Optional[Dict[str, float]] = None
                     ) -> FCTResponse:
        """Device-topk finalize: the engine already excluded PAD/stop/
        keyword bins and tie-broke by term id on device — slice the O(k)
        candidates to the requested k and decode.  ``all_freqs`` is None:
        the histogram never reached the host."""
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        k_out = min(planned.request.top_k, self.schema.vocab_size)
        ids, f = ids[:k_out], counts[:k_out]
        return self._respond(planned, terms=self.decode_terms(ids), ids=ids,
                             f=f, all_freqs=None, finalize="device_topk",
                             engine_stats=engine_stats, plan_ms=plan_ms,
                             dispatch_ms=dispatch_ms, collect_ms=collect_ms,
                             t0=t0, t0_ns=t0_ns, device_ms=device_ms)

    def _dispatch_planned(self, planned: Sequence[_PlannedQuery]) -> _InFlight:
        """Enqueue the device work of one or more planned queries (async).

        For a single query the summed-output program family is used (shared
        with ``query()``); for several, joined-CN plans from ALL queries are
        grouped by shape signature so same-signature CNs of different
        queries ride one stacked dispatch, and the per-CN output axis
        attributes results back.  Returns once the work is enqueued on the
        device's current stream, without waiting on it.
        """
        planned = list(planned)
        individual = len(planned) > 1
        # single-query dispatches on a device_topk session finalize on
        # device: O(k) candidates transfer instead of the histogram.
        # Multi-query stacked batches keep the host path (per-CN outputs
        # must be attributed across queries), as do requests that need the
        # full histogram (gateway result-cache fills) and plan-less
        # (map-only) queries
        use_topk = (self.config.device_topk and not individual
                    and bool(planned[0].plans)
                    and not planned[0].request.need_histogram)
        owners: List[int] = []
        all_plans: List[CNPlan] = []
        for qi, p in enumerate(planned):
            owners.extend([qi] * len(p.plans))
            all_plans.extend(p.plans)
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        stages: list = []
        with self._engine_lock:
            before = self._engine_snapshot()
            pending = topk = None
            if use_topk:
                p0 = planned[0]
                if self._excl_dev is None:
                    mask = np.zeros((self.schema.vocab_size,), np.int8)
                    mask[PAD_ID] = 1
                    if self.stop_mask is not None:
                        mask[self.stop_mask] = 1
                    self._excl_dev = self.engine.vocab_device_vector(
                        mask, self.mesh, np.int8)
                with maybe_activate(p0.trace):
                    topk = self.engine.dispatch_topk(
                        p0.plans, self.mesh, p0.request.top_k,
                        keywords=p0.keywords, excl=self._excl_dev,
                        host_extra=self._host_freq_device(p0),
                        store=self.store, accum=self.accum_policy,
                        prune=self.config.topk_prune, stages=stages)
            elif all_plans:
                # relation columns come from the session's device-resident
                # store: the first dispatch over a tuple set uploads its
                # columns, every later one — warm repeats, pipelined
                # submits, multi-query batches of ANY composition — reuses
                # them, and a plan's send tables and key-column indices go
                # up at its first dispatch only.  Engine / store
                # spans (dispatch_group, store.upload) land on the batch
                # leader's trace.
                with maybe_activate(planned[0].trace):
                    pending = self.engine.dispatch_plans(
                        all_plans, self.mesh, individual=individual,
                        store=self.store, accum=self.accum_policy,
                        stages=stages)
        dispatch_ms = (time.perf_counter() - t0) * 1e3
        dur_ns = time.perf_counter_ns() - t0_ns
        n_groups = len(pending) if pending is not None else (
            topk.groups_run if topk is not None else 0)
        for p in planned:
            if p.trace is not None:
                p.trace.add_span("dispatch", t0_ns, dur_ns,
                                 n_groups=n_groups, shared=individual)
        return _InFlight(planned=planned, owners=np.asarray(owners, np.int64),
                         pending=pending, individual=individual,
                         n_plans=len(all_plans), engine_before=before,
                         dispatch_ms=dispatch_ms, topk=topk, stages=stages)

    def _finalize(self, flight: _InFlight) -> List[FCTResponse]:
        """Block on the device results and build the responses."""
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        vocab = self.schema.vocab_size
        per_plan = total = topk_ids = topk_counts = None
        if flight.topk is not None:
            topk_ids, topk_counts = self.engine.collect_topk(flight.topk)
        elif flight.pending is not None:
            if flight.individual:
                per_plan = self.engine.collect_individual(
                    flight.pending, flight.n_plans, vocab)
            else:
                total = self.engine.collect_total(flight.pending, vocab)
        # the counter delta is taken after collection so the transfer-side
        # counters (device_to_host_bytes) land in this query's stats; the
        # stage events are complete once the results are on the host
        delta = self._engine_delta(flight.engine_before)
        device_ms = self.engine.device_stage_ms(flight.stages)
        collect_ms = (time.perf_counter() - t0) * 1e3
        dur_ns = time.perf_counter_ns() - t0_ns
        for p in flight.planned:
            if p.trace is not None:
                p.trace.add_span("collect", t0_ns, dur_ns,
                                 shared=flight.individual)
        if flight.topk is not None:
            p = flight.planned[0]
            return [self._finish_topk(p, topk_ids, topk_counts, delta,
                                      p.plan_ms, flight.dispatch_ms,
                                      collect_ms, device_ms)]
        out = []
        for qi, p in enumerate(flight.planned):
            if p.plans:
                if flight.individual:
                    freq = p.host_freq + per_plan[flight.owners == qi].sum(axis=0)
                else:
                    freq = p.host_freq + total
            else:  # copy: host_freq may be shared via the plan cache
                freq = p.host_freq.copy()
            # shared groups' device time goes to the batch leader, as the
            # engine's spans do
            out.append(self._finish(p, freq, delta,
                                    p.plan_ms, flight.dispatch_ms,
                                    collect_ms, device_ms if qi == 0 else None))
        return out

    # -- public execution paths ---------------------------------------------

    def query(self, req: FCTRequest) -> FCTResponse:
        """Synchronous single-query path."""
        return self._finalize(self._dispatch_planned([self._plan(req)]))[0]

    def query_batch(self, reqs: Sequence[FCTRequest],
                    traces: Optional[Sequence[Optional[Trace]]] = None
                    ) -> List[FCTResponse]:
        """Answer several requests through shared device dispatches.

        With mixed workloads this issues strictly fewer device dispatches
        than N ``query()`` calls whenever any two requests share a plan
        shape signature.  ``traces`` (same length as ``reqs``) lets a caller
        that already opened a per-request trace — the batcher records queue
        wait on it — continue it through the session stages; ``None``
        entries get a fresh trace as usual.
        """
        if not reqs:
            return []
        if traces is None:
            traces = [None] * len(reqs)
        return self._finalize(self._dispatch_planned(
            [self._plan(r, trace=t) for r, t in zip(reqs, traces)]))

    def submit(self, req: FCTRequest) -> Future:
        """Asynchronous path: enqueue on the planning/dispatch pipeline.

        Host-side planning of later queries overlaps device execution of
        earlier ones (dispatch is async, so a burst keeps several queries in
        flight on the device), through the same deterministic summed-output
        programs as ``query()``.  Futures resolve in submission order;
        exceptions (bad keywords, overflow, ...) land on the offending
        request's future only.  For cross-query stacked dispatches, use
        ``query_batch`` — there the caller controls the batch composition.
        """
        while True:
            with self._pipeline_lock:
                if self._pipeline is None:
                    self._pipeline = QueryPipeline(
                        self, queue_depth=self.config.pipeline_queue_depth)
                pipeline = self._pipeline
            try:
                return pipeline.submit(req)
            except RuntimeError:  # raced close(): restart a fresh pipeline
                with self._pipeline_lock:
                    if self._pipeline is pipeline:
                        self._pipeline = None

    # -- incremental ingest --------------------------------------------------

    def _encode_rows(self, relation: str, rows: Sequence[Mapping]
                     ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Validate + tokenize append rows into key columns and a text
        matrix.  Each row mapping needs every key column of the relation
        plus ``"text"`` (a string through the session tokenizer, or a
        pre-tokenized id sequence padded/truncated to the relation's
        ``text_len``).  Pure host work — runs outside every session lock."""
        role, i = self.schema.relation_role(relation)
        rel = self.schema.fact if role == "fact" else self.schema.dims[i]
        text_len, vocab = rel.text_len, self.schema.vocab_size
        keys: Dict[str, list] = {c: [] for c in rel.keys}
        texts: List[np.ndarray] = []
        for r, row in enumerate(rows):
            row = dict(row)
            text = row.pop("text", None)
            if text is None:
                raise ValueError(f"append row {r} has no 'text' field")
            if isinstance(text, str):
                if self.tokenizer is None:
                    raise ValueError(
                        f"append row {r}: string text needs a session "
                        "tokenizer")
                ids = np.asarray(self.tokenizer.encode(text, text_len),
                                 np.int32)
            else:
                ids = np.asarray(text, np.int64).reshape(-1)[:text_len]
                if ids.size and ((ids < 0).any() or (ids >= vocab).any()):
                    raise ValueError(
                        f"append row {r}: token ids outside [0, {vocab})")
                ids = np.pad(ids, (0, text_len - ids.size),
                             constant_values=PAD_ID).astype(np.int32)
            texts.append(ids)
            for c in keys:
                if c not in row:
                    raise ValueError(
                        f"append row {r} missing key column {c!r} of "
                        f"relation {relation!r}")
                keys[c].append(int(row[c]))
        if not texts:
            return ({c: np.zeros((0,), np.int32) for c in keys},
                    np.zeros((0, text_len), np.int32))
        return ({c: np.asarray(v, np.int32) for c, v in keys.items()},
                np.stack(texts))

    def append(self, relation: str,
               rows: Sequence[Mapping]) -> AppendResult:
        """Append rows to one relation — the DATA-ONLY mutation path.

        Runs inside a ``session.append`` span on the caller's active trace
        (the gateway's), or on a trace of its own; either is returned as
        ``AppendResult.trace``.

        Unlike ``invalidate()`` (the arbitrary-mutation hook, which drops
        everything data-derived), an append is pure growth, and almost all
        session state survives it:

          * the schema is REPLACED by one whose mutated relation carries an
            extra chunk (old column arrays are shared, never resized, so
            snapshots held by in-flight queries stay valid),
          * cached tuple sets are patched in place — one ``keyword_mask``
            pass over just the new rows each,
          * the device-resident store keeps every pre-append column upload:
            the chunked ``RelationRef`` layer re-aggregates them per chunk,
          * CN enumerations and built programs are untouched,
          * only routing plans (+ their device map-only histograms) drop —
            row routing genuinely changes.

        Everything mutates under ``_plan_lock``, the same critical section
        queries snapshot under, and ``_data_epoch`` is bumped so in-flight
        builds against the old data cannot re-enter the caches: a query
        racing this append sees the pre- or post-append snapshot bit-
        exactly, never a mix.  Concurrent ``append`` calls must be
        serialized by the caller when cached results are patched from the
        returned delta (the gateway's per-lane append lock does).
        """
        trace = current_trace()
        own = Trace() if trace is None else None
        with maybe_activate(own), obs_span("session.append",
                                           relation=relation) as sp:
            result = self._append(relation, rows)
            sp.args["rows"] = result.rows_appended
        return dataclasses.replace(result, trace=own or trace)

    def _append(self, relation: str,
                rows: Sequence[Mapping]) -> AppendResult:
        keys, text = self._encode_rows(relation, rows)
        role, dim_index = self.schema.relation_role(relation)
        with self._plan_lock:
            old = (self.schema.fact if role == "fact"
                   else self.schema.dims[dim_index])
            base_rows = old.rows
            if text.shape[0] == 0:  # no-op: nothing to fence
                return AppendResult(relation=relation, role=role,
                                    dim_index=dim_index, base_rows=base_rows,
                                    rows_appended=0,
                                    data_epoch=self._data_epoch)
            self.schema = self.schema.with_appended(relation, keys, text)
            self._data_epoch += 1
            epoch = self._data_epoch
            patched = 0
            for kws in list(self._tuple_sets.keys()):
                ts = self._tuple_sets.hit(kws)
                mask = keyword_mask(text, kws)
                if role == "fact":
                    new_ts = TupleSets(
                        fact_kw=np.concatenate([ts.fact_kw, mask]),
                        dim_kw=ts.dim_kw, full=ts.full)
                else:
                    dk = list(ts.dim_kw)
                    dk[dim_index] = np.concatenate([dk[dim_index], mask])
                    new_ts = TupleSets(fact_kw=ts.fact_kw, dim_kw=dk,
                                       full=ts.full)
                assert self._data_epoch == epoch  # patched sets belong to
                #                                   exactly this epoch
                self._tuple_sets[kws] = new_ts
                patched += 1
            plans_dropped = len(self._plan_cache)
            self._plan_cache.clear()
            self._hf_dev.clear()  # map-only histograms are per-plan data
        self._c_appends.inc()
        self._c_delta_rows.inc(int(text.shape[0]))
        return AppendResult(relation=relation, role=role,
                            dim_index=dim_index, base_rows=base_rows,
                            rows_appended=int(text.shape[0]),
                            data_epoch=epoch, tuple_sets_patched=patched,
                            plans_dropped=plans_dropped)

    def delta_freq(self, result: AppendResult, keywords: Sequence,
                   r_max: int) -> np.ndarray:
        """Exact histogram contribution of ``result``'s appended chunk.

        ``freq(base + chunk) == freq(base) + delta`` in exact integer
        arithmetic, so a cached full histogram for (keywords, r_max) is
        patched by plain addition — the gateway's append hook does exactly
        that.  The delta dispatch runs only CNs whose join tree contains
        the mutated relation, against tuple sets restricted to the new
        chunk (the other relations keep their full sets); it reuses the
        session's engine, store and program families.  The delta
        is independent of mode/rho/sample_frac/salt — those are routing
        knobs, totals are invariant — so one delta serves every cached
        entry sharing (keywords, r_max).

        Must run against the epoch ``result`` produced (raises
        ``RuntimeError`` if another mutation overtook it): callers patching
        caches serialize append → delta → patch, as the gateway does.

        Runs inside a ``session.delta_freq`` span on the active trace, with
        the planner's ``plan.cn_plan`` / ``plan.map_only`` spans and the
        engine's spans beneath it.
        """
        with obs_span("session.delta_freq", n_keywords=len(keywords),
                      r_max=r_max):
            return self._delta_freq(result, keywords, r_max)

    def _delta_freq(self, result: AppendResult, keywords: Sequence,
                    r_max: int) -> np.ndarray:
        if result.rows_appended == 0:
            return np.zeros((self.schema.vocab_size,), np.int64)
        kws = self.resolve_keywords(keywords)
        ts, schema, epoch = self._get_tuple_sets(kws)
        if epoch != result.data_epoch:
            raise RuntimeError(
                f"delta_freq for data epoch {result.data_epoch} but the "
                f"session is at {epoch}: serialize appends with their "
                "patch-up")
        dts = _delta_tuple_sets(ts, result.role, result.dim_index,
                                result.base_rows)
        cns = [cn for cn in self._get_cns(len(kws), r_max)
               if _cn_includes(cn, result.role, result.dim_index)]
        cns = prune_empty_cns(cns, dts)
        delta = np.zeros((schema.vocab_size,), np.int64)
        plans: List[CNPlan] = []
        for cn in cns:
            # totals are mode-invariant: plan the delta uniformly
            plan = _traced_cn_plan(schema, dts, cn, self._n_dev,
                                   mode="uniform")
            if plan is None:  # single-relation CN: map-only over new rows
                delta += _map_only_freq(schema, dts, cn)
                continue
            plans.append(plan)
        if plans:
            with self._engine_lock:
                delta += self.engine.run_plans(
                    plans, self.mesh, store=self.store,
                    accum=self.accum_policy)
        delta[PAD_ID] = 0  # parity with _finish: PAD never counts
        return delta

    # -- lifecycle / introspection ------------------------------------------

    def invalidate(self) -> Dict[str, int]:
        """Drop every cache derived from the relation DATA: tuple sets,
        routing plans and the device-resident relation store.  The hook a
        data-mutation path must call (the serving gateway's ``invalidate``
        does, alongside its result cache) — the engine cannot know the
        underlying relations changed.  Built programs survive: they depend
        only on shapes.  Returns the drop counts."""
        with self._plan_lock:
            dropped = {"tuple_sets": len(self._tuple_sets),
                       "plans": len(self._plan_cache),
                       "host_freq_dev": len(self._hf_dev)}
            self._tuple_sets.clear()
            self._plan_cache.clear()
            self._hf_dev.clear()  # device map-only histograms are data too
            self._data_epoch += 1   # fence in-flight builds (see _plan /
            #                         _get_tuple_sets): their puts are dropped
            # drop the device store INSIDE the same lock: a replan against
            # the mutated data (RelationRef uids fingerprint row indices,
            # which a mutation need not change) must never find
            # pre-mutation device columns still resident
            dropped["store_entries"] = self.store.clear()
        return dropped

    def close(self) -> None:
        """Drain and stop the pipeline (if started).  The session remains
        usable for sync queries; a later submit() restarts the pipeline."""
        with self._pipeline_lock:
            pipeline, self._pipeline = self._pipeline, None
        if pipeline is not None:
            pipeline.close()

    def __enter__(self) -> "FCTSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> Dict[str, int]:
        """Engine + store counters plus session-level cache/serving
        counters."""
        out = dict(self.engine.stats())
        out.update(self.store.stats())
        served, ts_hits, ts_misses, plan_hits, plan_misses, appends, \
            delta_rows = self.metrics.values(
                self._c_queries, self._c_ts_hits, self._c_ts_misses,
                self._c_plan_hits, self._c_plan_misses, self._c_appends,
                self._c_delta_rows)
        out.update(queries_served=served,
                   appends=appends,
                   delta_rows=delta_rows,
                   tuple_set_entries=len(self._tuple_sets),
                   tuple_set_hits=ts_hits,
                   tuple_set_misses=ts_misses,
                   plan_entries=len(self._plan_cache),
                   plan_hits=plan_hits,
                   plan_misses=plan_misses,
                   accum_policy=self.accum_policy.name,
                   n_devices=self._n_dev,
                   device=str(self.device),
                   adaptive_rho=self.config.adaptive_rho)
        return out
