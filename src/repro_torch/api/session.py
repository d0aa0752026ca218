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
    set, so warm dispatches ship only kilobyte-sized routing tables
    (``store_uploads``/``store_hits`` counters; ``invalidate()`` drops the
    store and the derived host caches after a data mutation).

Two execution paths:

  ``query(req)``          plan + dispatch + top-k, one request.
  ``query_batch(reqs)``   same-signature plans from *different* requests are
                          stacked through one device dispatch (the engine's
                          per-CN output axis attributes results back).

The session runs on the card unless the caller asks for the CPU:
``device=None`` means CUDA, and asking for CUDA where there is none raises.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.request import FCTRequest, FCTResponse
from repro_torch.core.accum import AccumPolicy
from repro_torch.core.candidate_network import (StarCN, TupleSets,
                                                enumerate_star_cns,
                                                prune_empty_cns)
from repro_torch.core.plan import CNPlan, build_cn_plan
from repro_torch.core.star import topk_terms
from repro_torch.data.schema import PAD_ID, StarSchema, tokens_histogram
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.obs import Trace, default_registry, maybe_activate
from repro_torch.obs import span as obs_span
from repro_torch.runtime.cache import ExecutableCache, LruDict
from repro_torch.runtime.engine import FCTEngine, default_engine
from repro_torch.runtime.store import RelationStore

_ENGINE_COUNTERS = ("hits", "misses", "traces", "evictions",
                    "batches_run", "cns_run", "bytes_shipped",
                    "store_uploads", "store_hits", "store_upload_bytes",
                    "device_to_host_bytes")


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
    store_max_bytes: Optional[int] = None  # byte budget for the session's
                                        # device-resident relation store
                                        # (None = unbounded)


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


@dataclasses.dataclass
class _InFlight:
    """Queries whose device work is enqueued but not yet transferred."""

    planned: List[_PlannedQuery]
    owners: np.ndarray                  # plan index -> owning query index
    pending: Optional[list]             # engine handle; None if all map-only
    individual: bool                    # per-CN family (shared dispatches)
    n_plans: int
    engine_before: Dict[str, int]       # counter snapshot before dispatch
    dispatch_ms: float


class FCTSession:
    """Front door for FCT queries over one star schema.

    ``device`` (``None`` = CUDA) and ``n_workers`` (P, default 1) define the
    virtual worker mesh.  The session uses the process-wide engine (shared
    program cache) unless ``config.cache_max_entries`` is set, in which case
    it owns a fresh engine with an LRU-capped cache.  A tokenizer's stop
    list (plus PAD) is excluded from the top-k.
    """

    def __init__(self, schema: StarSchema, *, device=None, n_workers: int = 1,
                 tokenizer=None, config: Optional[SessionConfig] = None,
                 metrics=None) -> None:
        self.schema = schema
        self.tokenizer = tokenizer
        self.config = config if config is not None else SessionConfig()
        self.metrics = metrics if metrics is not None else default_registry()
        self.accum_policy = AccumPolicy.resolve(self.config.accum_policy)
        self.mesh = make_worker_mesh(n_workers, device)
        self.device = self.mesh.device
        self._n_dev = self.mesh.size
        if self.config.cache_max_entries is not None:
            self.engine = FCTEngine(cache=ExecutableCache(
                max_entries=self.config.cache_max_entries,
                metrics=self.metrics), metrics=self.metrics)
        else:
            self.engine = default_engine()
        self.store = RelationStore(self.mesh,
                                   max_bytes=self.config.store_max_bytes,
                                   metrics=self.metrics)
        self.stop_mask = (tokenizer.stop_mask() if tokenizer is not None
                          else None)
        self._tuple_sets: LruDict = LruDict(self.config.tuple_set_cache_size)
        # bumped by invalidate() under _plan_lock: tuple sets / plans built
        # from pre-mutation data must not re-enter the caches afterwards
        self._data_epoch = 0
        self._cn_lists: Dict[Tuple[int, int], List[StarCN]] = {}
        self._plan_cache: LruDict = LruDict(
            self.config.plan_cache_size if self.config.plan_cache_size > 0
            else None)  # unreachable when 0: _plan short-circuits
        self._plan_lock = threading.Lock()
        self._engine_lock = threading.Lock()
        self._c_queries = self.metrics.counter("session.queries_served")
        self._c_ts_hits = self.metrics.counter("session.tuple_set_hits")
        self._c_ts_misses = self.metrics.counter("session.tuple_set_misses")
        self._c_plan_hits = self.metrics.counter("session.plan_hits")
        self._c_plan_misses = self.metrics.counter("session.plan_misses")

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

    def _get_tuple_sets(self, keywords: Tuple[int, ...]
                        ) -> Tuple[TupleSets, StarSchema]:
        """(tuple sets, the schema they were built over), read or installed
        under ``_plan_lock`` and fenced by the data epoch."""
        with self._plan_lock:
            ts = self._tuple_sets.hit(keywords)
            if ts is not None:
                self._c_ts_hits.inc()
                return ts, self.schema
            epoch, schema = self._data_epoch, self.schema
        ts = TupleSets.build(schema, keywords)  # outside the lock
        self._c_ts_misses.inc()
        with self._plan_lock:
            if self._data_epoch != epoch:  # invalidated mid-build: serve,
                return ts, schema          # cache nothing
            return self._tuple_sets.put(keywords, ts), schema

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
        the map-only histogram of single-relation CNs.  Memoized per
        (keywords, planning knobs); ``top_k`` is not in the key, so a cache
        hit is re-bound to the incoming request and its own trace."""
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
        ts, schema = self._get_tuple_sets(kws)
        cns = prune_empty_cns(self._get_cns(len(kws), req.r_max), ts)
        host_freq = np.zeros((schema.vocab_size,), np.int64)
        plans: List[CNPlan] = []
        shuffle_rows = shuffle_bytes = 0
        imbalance, row_imb, dominant_cost = 1.0, 1.0, -1.0
        mode = req.mode
        if mode == "uniform" and self.config.adaptive_rho:
            mode = "adaptive"
        for cn in cns:
            plan = build_cn_plan(schema, ts, cn, self._n_dev,
                                 mode=mode, rho=req.rho,
                                 sample_frac=req.sample_frac, salt=req.salt)
            if plan is None:
                # single-relation CN: a map-only word-count (no shuffle)
                fact_idx, dim_idx = ts.cn_rows(cn)
                if fact_idx is not None:
                    text = schema.fact.text[fact_idx]
                else:
                    (i, rows), = dim_idx.items()
                    text = schema.dims[i].text[rows]
                host_freq += tokens_histogram(
                    text, np.ones(text.shape[0], np.int64),
                    schema.vocab_size)
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
                             plan_ms=plan_ms)

    def _engine_snapshot(self) -> Dict[str, int]:
        st = dict(self.engine.stats())
        st.update(self.store.stats())
        return {k: st.get(k, 0) for k in _ENGINE_COUNTERS}

    def _engine_delta(self, before: Dict[str, int]) -> Dict[str, int]:
        after = self._engine_snapshot()
        return {k: after[k] - before[k] for k in _ENGINE_COUNTERS}

    def _decode_terms(self, ids: np.ndarray) -> List[str]:
        if self.tokenizer is not None:
            return [self.tokenizer.decode(t) for t in ids]
        return [f"<{int(t)}>" for t in ids]

    def _finish(self, planned: _PlannedQuery, freq: np.ndarray,
                engine_stats: Dict[str, int], dispatch_ms: float,
                collect_ms: float) -> FCTResponse:
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        req = planned.request
        freq[PAD_ID] = 0
        ids, f = topk_terms(freq, planned.keywords, req.top_k, self.stop_mask)
        self._c_queries.inc()
        finalize_ms = (time.perf_counter() - t0) * 1e3
        if planned.trace is not None:
            planned.trace.add_span("finalize", t0_ns,
                                   time.perf_counter_ns() - t0_ns,
                                   top_k=req.top_k, finalize="host")
        plan_ms = planned.plan_ms
        execute_ms = dispatch_ms + collect_ms + finalize_ms
        return FCTResponse(
            terms=self._decode_terms(ids), term_ids=ids, freqs=f,
            all_freqs=freq, n_cns=planned.n_cns,
            n_joined_cns=len(planned.plans),
            shuffle_rows=planned.shuffle_rows,
            shuffle_bytes=planned.shuffle_bytes,
            imbalance=planned.imbalance,
            row_imbalance=planned.row_imbalance,
            timings={"plan_ms": round(plan_ms, 3),
                     "dispatch_ms": round(dispatch_ms, 3),
                     "collect_ms": round(collect_ms, 3),
                     "finalize_ms": round(finalize_ms, 3),
                     "execute_ms": round(execute_ms, 3),
                     "total_ms": round(plan_ms + execute_ms, 3)},
            engine_stats=engine_stats,
            cold=engine_stats.get("traces", 0) > 0,
            accum_policy=self.accum_policy.name,
            request=req, trace=planned.trace)

    def _dispatch_planned(self, planned: Sequence[_PlannedQuery]) -> _InFlight:
        """Enqueue the device work of one or more planned queries.

        For a single query the summed-output program family is used; for
        several, joined-CN plans from ALL queries are grouped by shape
        signature so same-signature CNs of different queries ride one
        stacked dispatch, and the per-CN output axis attributes results
        back.  Returns without waiting for the device.
        """
        planned = list(planned)
        individual = len(planned) > 1
        owners: List[int] = []
        all_plans: List[CNPlan] = []
        for qi, p in enumerate(planned):
            owners.extend([qi] * len(p.plans))
            all_plans.extend(p.plans)
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        with self._engine_lock:
            before = self._engine_snapshot()
            pending = None
            if all_plans:
                with maybe_activate(planned[0].trace):
                    pending = self.engine.dispatch_plans(
                        all_plans, self.mesh, individual=individual, store=self.store,
                        accum=self.accum_policy)
        dispatch_ms = (time.perf_counter() - t0) * 1e3
        dur_ns = time.perf_counter_ns() - t0_ns
        for p in planned:
            if p.trace is not None:
                p.trace.add_span("dispatch", t0_ns, dur_ns,
                                 n_groups=len(pending or ()),
                                 shared=individual)
        return _InFlight(planned=planned, owners=np.asarray(owners, np.int64),
                         pending=pending, individual=individual,
                         n_plans=len(all_plans), engine_before=before,
                         dispatch_ms=dispatch_ms)

    def _finalize(self, flight: _InFlight) -> List[FCTResponse]:
        """Block on the device results and build the responses."""
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        vocab = self.schema.vocab_size
        per_plan = total = None
        if flight.pending is not None:
            if flight.individual:
                per_plan = self.engine.collect_individual(
                    flight.pending, flight.n_plans, vocab)
            else:
                total = self.engine.collect_total(flight.pending, vocab)
        # the counter delta is taken after collection so the transfer-side
        # counters (device_to_host_bytes) land in this query's stats
        delta = self._engine_delta(flight.engine_before)
        collect_ms = (time.perf_counter() - t0) * 1e3
        dur_ns = time.perf_counter_ns() - t0_ns
        out = []
        for qi, p in enumerate(flight.planned):
            if p.trace is not None:
                p.trace.add_span("collect", t0_ns, dur_ns,
                                 shared=flight.individual)
            if p.plans:
                if flight.individual:
                    freq = p.host_freq + per_plan[flight.owners == qi].sum(
                        axis=0)
                else:
                    freq = p.host_freq + total
            else:  # copy: host_freq may be shared via the plan cache
                freq = p.host_freq.copy()
            out.append(self._finish(p, freq, delta, flight.dispatch_ms,
                                    collect_ms))
        return out

    # -- public execution paths ---------------------------------------------

    def query(self, req: FCTRequest) -> FCTResponse:
        """Single-query path."""
        return self._finalize(self._dispatch_planned([self._plan(req)]))[0]

    def query_batch(self, reqs: Sequence[FCTRequest]) -> List[FCTResponse]:
        """Answer several requests through shared device dispatches: with
        mixed workloads this issues strictly fewer device dispatches than N
        ``query()`` calls whenever any two requests share a plan shape
        signature.  Each response's ``engine_stats`` is the batch-wide
        counter delta."""
        if not reqs:
            return []
        return self._finalize(self._dispatch_planned(
            [self._plan(r) for r in reqs]))

    # -- lifecycle / introspection ------------------------------------------

    def invalidate(self) -> Dict[str, int]:
        """Drop every cache derived from the relation DATA: tuple sets,
        routing plans and the device-resident relation store.  Built
        programs survive: they depend only on shapes.  Returns the drop
        counts."""
        with self._plan_lock:
            dropped = {"tuple_sets": len(self._tuple_sets),
                       "plans": len(self._plan_cache)}
            self._tuple_sets.clear()
            self._plan_cache.clear()
            self._data_epoch += 1   # fence in-flight builds
            dropped["store_entries"] = self.store.clear()
        return dropped

    def stats(self) -> Dict[str, object]:
        """Engine + store counters plus session-level cache counters."""
        out = dict(self.engine.stats())
        out.update(self.store.stats())
        served, ts_hits, ts_misses, plan_hits, plan_misses = \
            self.metrics.values(self._c_queries, self._c_ts_hits,
                                self._c_ts_misses, self._c_plan_hits,
                                self._c_plan_misses)
        out.update(queries_served=served,
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
