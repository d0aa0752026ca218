"""Gateway: the multi-tenant serving front door.

One object ties the serving subsystem together:

    submit("tpch", req) ──► ResultCache (per tenant) ── hit ──► Future
                                 │ miss                        (resolved)
                                 ▼
                            in-flight coalescing (identical query already
                                 │ running? attach to its Future)
                                 ▼
                            DynamicBatcher (per tenant, ~1ms window)
                                 ▼  query_batch: stacked dispatches
                            FCTSession ──► runtime engine + RelationStore

``submit`` resolves the request's keywords through the tenant's session
(string/id spellings and permutations collapse onto one cache key), answers
from the tenant's :class:`ResultCache` when possible — a hit costs zero
engine dispatches and re-slices ``top_k`` from the memoized full histogram —
coalesces onto an identical IN-FLIGHT query when one exists (the repeat
attaches to the leader's Future instead of dispatching again; its response
re-slices the leader's histogram and is marked ``coalesced``), and otherwise
enqueues on the tenant's :class:`DynamicBatcher` so same-window queries
share device dispatches.  Completed responses are inserted back into the
result cache.

Backpressure: at most ``max_inflight`` uncached requests may be unresolved
gateway-wide; ``submit`` blocks (admission control) once the bound is hit,
so a client burst cannot queue unbounded device work.  With
``max_inflight_per_tenant`` set, each tenant additionally gets a private
bound, so one tenant's burst cannot starve the others out of the
gateway-wide budget.  Cache hits and coalesced followers bypass both bounds
— they consume no engine capacity.

``invalidate(schema)`` is the data-mutation hook: it drops the tenant's
memoized results AND its session's data-derived state (tuple sets, routing
plans, the device-resident relation store), so the next query replans and
re-uploads against the mutated relations.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

from repro_torch.api.request import AppendResult, FCTRequest, FCTResponse
from repro_torch.api.session import FCTSession
from repro_torch.core.star import topk_terms
from repro_torch.obs import LATENCY_BUCKETS_MS, Trace, default_registry
from repro_torch.obs import span as obs_span
from repro_torch.serve.batcher import DynamicBatcher, FlushPool
from repro_torch.serve.registry import SchemaRegistry
from repro_torch.serve.result_cache import ResultCache


@dataclasses.dataclass
class GatewayConfig:
    """Gateway-level knobs (per-tenant *cache* budgets live on the
    registry; these govern batching, result caching and admission)."""

    batch_window_ms: float = 1.0        # dynamic-batching window per tenant
    result_cache_ttl_s: Optional[float] = 60.0  # None = no expiry, 0 = off
    result_cache_entries: int = 256     # per-tenant result-cache LRU bound
    max_inflight: int = 64              # gateway-wide uncached in-flight cap
    max_inflight_per_tenant: Optional[int] = None  # per-tenant admission
                                        # bound (None = gateway-wide only)
    flush_workers: int = 4              # shared FlushPool size: windows of
                                        # different tenants flush in parallel
                                        # on these threads
    append_policy: str = "patch"        # what append() does to the tenant's
                                        # memoized results: "patch" adds the
                                        # exact delta histogram to every
                                        # cached entry (post-append hits stay
                                        # warm), "drop" invalidates them
                                        # (cheapest when the cache rarely
                                        # outlives an append)

    def __post_init__(self) -> None:
        # fail at construction, not inside the first submit()'s lazy lane
        # build (where callers would misread it as a per-request rejection)
        if self.max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {self.max_inflight}")
        if (self.max_inflight_per_tenant is not None
                and self.max_inflight_per_tenant < 1):
            raise ValueError(
                f"max_inflight_per_tenant must be >= 1 or None, got "
                f"{self.max_inflight_per_tenant}")
        if self.batch_window_ms < 0:
            raise ValueError(
                f"batch_window_ms must be >= 0, got {self.batch_window_ms}")
        if self.result_cache_ttl_s is not None and self.result_cache_ttl_s < 0:
            raise ValueError(
                f"result_cache_ttl_s must be >= 0 or None, got "
                f"{self.result_cache_ttl_s}")
        if self.result_cache_entries < 1:
            raise ValueError(
                f"result_cache_entries must be >= 1, got "
                f"{self.result_cache_entries}")
        if self.flush_workers < 1:
            raise ValueError(
                f"flush_workers must be >= 1, got {self.flush_workers}")
        if self.append_policy not in ("patch", "drop"):
            raise ValueError(
                f"append_policy must be 'patch' or 'drop', got "
                f"{self.append_policy!r}")


@dataclasses.dataclass
class _InflightEntry:
    """One in-flight leader query: the result-cache generation observed at
    its registration (an ``invalidate`` since then makes it STALE — later
    identical requests must dispatch fresh rather than attach) and the
    followers coalesced onto it.  Mutated only under the gateway lock while
    the entry is registered."""

    generation: int
    #: the leader's ``top_k`` when its response may come back histogram-less
    #: (device-topk lane with the result cache off) — a follower can only
    #: re-slice a PREFIX of the leader's candidates, so requests with a
    #: larger k must not attach.  -1 = leader will carry the full histogram,
    #: any k attaches.
    leader_top_k: int = -1
    # (future, request, resolved keywords, edge trace, submit perf_counter)
    followers: List[Tuple[Future, FCTRequest, tuple, Trace, float]] = \
        dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Lane:
    """Per-tenant serving state, built lazily with the session."""

    session: FCTSession
    batcher: DynamicBatcher
    results: ResultCache
    # canonical request key -> in-flight leader; guarded by the gateway
    # lock.  An entry exists while one identical query is between admission
    # and completion (a stale entry may be replaced by a fresh leader after
    # an invalidate; each leader's relay removes only its OWN entry).
    inflight: Dict[tuple, _InflightEntry] = dataclasses.field(
        default_factory=dict)
    sem: Optional[threading.Semaphore] = None   # per-tenant admission bound
    # per-tenant labeled instruments (schema=<name>): end-to-end gateway
    # latency, engine shuffle bytes attributed at completion, coalesced count
    latency: object = None               # obs.Histogram, gateway.query_latency_ms
    shuffle: object = None               # obs.Counter, gateway.shuffle_bytes
    c_coalesced: object = None           # obs.Counter, gateway.coalesced
    d2h: object = None                   # obs.Counter, gateway.device_to_host_bytes
    c_patched: object = None             # obs.Counter, gateway.histograms_patched
    # appends and their host time, read from each append's own spans:
    # gateway.appends, gateway.append_ns (the gateway.append span) and
    # gateway.delta_plan_ns (plan.cn_plan spans inside session.delta_freq)
    c_appends: object = None
    c_append_ns: object = None
    c_delta_plan_ns: object = None
    # serializes append -> delta -> patch per tenant: delta_freq must run
    # against exactly the epoch its append produced
    append_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock)


class Gateway:
    """submit(schema, request) -> Future over a SchemaRegistry."""

    def __init__(self, registry: SchemaRegistry,
                 config: Optional[GatewayConfig] = None,
                 metrics=None) -> None:
        self.registry = registry
        self.config = config if config is not None else GatewayConfig()
        self._lanes: Dict[str, _Lane] = {}
        self._lock = threading.Lock()
        self._inflight = threading.Semaphore(self.config.max_inflight)
        # defaults to the same process-wide registry the SchemaRegistry's
        # sessions label into, so one snapshot covers the whole stack
        self.metrics = metrics if metrics is not None else default_registry()
        # one flush pool for ALL tenants: windows of different tenants run
        # their query_batch in parallel instead of convoying behind one
        # slow tenant's device transfer
        self._flush_pool = FlushPool(self.config.flush_workers,
                                     metrics=self.metrics)
        self._closed = False
        self._c_submitted = self.metrics.counter("gateway.submitted")
        self._c_rejected = self.metrics.counter("gateway.rejected")

    # -- per-tenant lane management -----------------------------------------

    def _lane(self, schema: str) -> _Lane:
        with self._lock:
            lane = self._lanes.get(schema)
            if lane is not None:
                return lane
        session = self.registry.session(schema)   # KeyError on unknown name
        with self._lock:
            if self._closed:
                raise RuntimeError("gateway is closed")
            lane = self._lanes.get(schema)
            if lane is None:
                per_tenant = self.config.max_inflight_per_tenant
                lm = self.metrics.labeled(schema=schema)
                lane = self._lanes[schema] = _Lane(
                    session=session,
                    batcher=DynamicBatcher(
                        session, window_ms=self.config.batch_window_ms,
                        name=schema, pool=self._flush_pool, metrics=lm),
                    results=ResultCache(
                        max_entries=self.config.result_cache_entries,
                        ttl_s=self.config.result_cache_ttl_s, metrics=lm),
                    sem=(threading.Semaphore(per_tenant)
                         if per_tenant is not None else None),
                    latency=lm.histogram("gateway.query_latency_ms",
                                         buckets=LATENCY_BUCKETS_MS),
                    shuffle=lm.counter("gateway.shuffle_bytes"),
                    c_coalesced=lm.counter("gateway.coalesced"),
                    d2h=lm.counter("gateway.device_to_host_bytes"),
                    c_patched=lm.counter("gateway.histograms_patched"),
                    c_appends=lm.counter("gateway.appends"),
                    c_append_ns=lm.counter("gateway.append_ns"),
                    c_delta_plan_ns=lm.counter("gateway.delta_plan_ns"))
            return lane

    @staticmethod
    def _cache_key(resolved: Tuple[int, ...], req: FCTRequest):
        # everything that changes the histogram; top_k sliced per request
        return (tuple(sorted(resolved)), req.r_max, req.mode, req.rho,
                req.sample_frac, req.salt)

    def _serve_hit(self, lane: _Lane, master: FCTResponse, req: FCTRequest,
                   kws: Tuple[int, ...], coalesced: bool = False,
                   trace: Optional[Trace] = None) -> FCTResponse:
        """Re-bind a memoized (or leader) response to the incoming request:
        slice its ``top_k`` from the full histogram (Def. 6 selection
        against the tenant's stop list), mark it, zero the engine delta.
        The top-k re-slice IS this request's finalize work (nothing was
        planned or dispatched), so that's the one span it records."""
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        if master.all_freqs is None:
            # device-topk leader: there is no histogram to re-slice.  The
            # attach gate guarantees the follower's k <= the leader's, so
            # its top-k is a prefix of the leader's candidate list
            freq = None
            kk = min(req.top_k, len(master.term_ids))
            ids, f = master.term_ids[:kk].copy(), master.freqs[:kk].copy()
        else:
            freq = master.all_freqs.copy()  # callers may mutate their response
            ids, f = topk_terms(freq, kws, req.top_k, lane.session.stop_mask)
        terms = lane.session.decode_terms(ids)
        finalize_ms = (time.perf_counter() - t0) * 1e3
        if trace is not None:
            trace.add_span("finalize", t0_ns, time.perf_counter_ns() - t0_ns,
                           top_k=req.top_k, coalesced=coalesced)
        return dataclasses.replace(
            master, terms=terms, term_ids=ids, freqs=f, all_freqs=freq,
            timings={"plan_ms": 0.0, "dispatch_ms": 0.0, "collect_ms": 0.0,
                     "finalize_ms": round(finalize_ms, 3),
                     "execute_ms": round(finalize_ms, 3),
                     "total_ms": round(finalize_ms, 3)},
            engine_stats={k: 0 for k in master.engine_stats},
            cold=False, cache_hit=not coalesced, coalesced=coalesced,
            request=req, trace=trace)

    # -- request path --------------------------------------------------------

    def submit(self, schema: str, request: FCTRequest) -> "Future":
        """Route one request; returns a Future of its FCTResponse.

        Raises synchronously on an unknown schema (KeyError) or a keyword
        the tenant cannot resolve (ValueError) — admission errors should
        not consume a batching slot.  May block for backpressure.
        """
        if self._closed:
            raise RuntimeError("gateway is closed")
        t_submit = time.perf_counter()
        try:
            lane = self._lane(schema)
            resolved = lane.session.resolve_keywords(request.keywords)
        except BaseException:
            self._c_rejected.inc()
            raise
        # device-topk routing: with the result cache ON, a dispatch doubles
        # as the cache fill — force the full-histogram path so later hits
        # can re-slice any k from the memoized histogram.  With the cache
        # OFF, uncached top_k-only requests ride the session's O(k) device
        # finalize untouched.
        cache_on = self.config.result_cache_ttl_s != 0
        if (cache_on and lane.session.config.device_topk
                and not request.need_histogram):
            request = dataclasses.replace(request, need_histogram=True)
        topk_lane = (lane.session.config.device_topk
                     and not request.need_histogram)
        key = self._cache_key(resolved, request)
        # the edge trace: every admitted request gets one, covering the
        # cache lookup here and — on a miss — the batcher window and the
        # session stages downstream (the same Trace object rides through)
        trace = Trace()
        with trace.activate(), obs_span("cache.lookup", schema=schema):
            cached = lane.results.get(key)
        if cached is not None:
            fut: Future = Future()
            fut.set_result(self._serve_hit(lane, cached, request, resolved,
                                           trace=trace))
            lane.latency.observe((time.perf_counter() - t_submit) * 1e3)
            self._c_submitted.inc()
            return fut
        # coalesce onto an identical in-flight query: the repeat attaches to
        # the leader's completion instead of dispatching again, and bypasses
        # admission (it consumes no engine capacity).  Registering the
        # leader's key BEFORE it blocks on backpressure below means repeats
        # of a wedged query pile onto its future rather than onto the
        # semaphores.  A leader registered before an invalidate() is STALE
        # (generation mismatch): attaching would serve pre-mutation data,
        # so the repeat becomes a fresh leader and replaces the entry (the
        # stale leader still resolves its own followers).
        entry = _InflightEntry(generation=lane.results.generation,
                               leader_top_k=request.top_k if topk_lane
                               else -1)
        with self._lock:
            cur = lane.inflight.get(key)
            if (cur is not None
                    and cur.generation == lane.results.generation
                    and (cur.leader_top_k < 0
                         or request.top_k <= cur.leader_top_k)):
                fut = Future()
                cur.followers.append((fut, request, resolved, trace,
                                      t_submit))
                lane.c_coalesced.inc()
                self._c_submitted.inc()
                return fut
            # no attachable leader (none, stale, or a device-topk leader
            # with a smaller k than ours): become the leader
            lane.inflight[key] = entry
        acquired = []
        try:
            if lane.sem is not None:
                lane.sem.acquire()        # per-tenant admission bound
                acquired.append(lane.sem)
            self._inflight.acquire()      # backpressure: bounded device work
            acquired.append(self._inflight)
            inner = lane.batcher.submit(request, trace=trace)
        except BaseException as exc:      # incl. interrupts while blocked
            for sem in acquired:
                sem.release()
            with self._lock:
                if lane.inflight.get(key) is entry:
                    del lane.inflight[key]
                followers = list(entry.followers)
            for f, _, _, _, _ in followers:  # they attached to a dead leader
                self._resolve(f, exc=exc)
            self._c_rejected.inc()
            raise
        # the caller gets a gateway-owned future resolved AFTER the result
        # is copied into the cache: Future.set_result wakes waiters before
        # running callbacks, so handing out the batcher's future directly
        # would let the miss caller mutate the response while (or before)
        # the trailing callback snapshots it for later hits
        outer: Future = Future()
        inner.add_done_callback(
            lambda f, lane=lane, key=key, entry=entry, outer=outer,
                   t_submit=t_submit:
                self._relay(lane, key, entry, f, outer, t_submit))
        self._c_submitted.inc()
        return outer

    def _release(self, lane: _Lane) -> None:
        self._inflight.release()
        if lane.sem is not None:
            lane.sem.release()

    @staticmethod
    def _resolve(fut: "Future", result=None, exc=None) -> None:
        if fut.cancelled():               # caller-side cancel; tolerated
            return
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except Exception:                 # racing cancel()
            pass

    def _relay(self, lane: _Lane, key, entry: _InflightEntry,
               inner: "Future", outer: "Future", t_submit: float) -> None:
        self._release(lane)
        with self._lock:
            # remove only OUR entry: an invalidate may have let a fresh
            # leader replace a stale one while this query was in flight
            if lane.inflight.get(key) is entry:
                del lane.inflight[key]
            followers = list(entry.followers)  # no attachments after this
        if inner.cancelled():
            outer.cancel()
            for f, _, _, _, _ in followers:
                f.cancel()
            return
        exc = inner.exception()
        if exc is not None:
            self._resolve(outer, exc=exc)
            for f, _, _, _, _ in followers:  # the shared dispatch failed
                self._resolve(f, exc=exc)
            return
        resp = inner.result()
        lane.latency.observe((time.perf_counter() - t_submit) * 1e3)
        lane.shuffle.inc(int(resp.shuffle_bytes))
        lane.d2h.inc(int(resp.engine_stats.get("device_to_host_bytes", 0)))
        # cache a private master FIRST: the caller owns `resp` once the
        # outer future resolves and may mutate its histogram/stats, which
        # must not poison later hits.  `generation` drops the insert when
        # an invalidate() overtook this query in flight.  The master drops
        # the leader's trace — its spans belong to one request, not to the
        # repeats a later hit serves.
        master = dataclasses.replace(
            resp,
            all_freqs=None if resp.all_freqs is None
            else resp.all_freqs.copy(),
            engine_stats=dict(resp.engine_stats), trace=None)
        if master.all_freqs is not None:
            # device-topk masters carry no histogram: they can still serve
            # their coalesced followers (prefix re-slice) but cannot answer
            # future hits at arbitrary k, so they are never memoized
            lane.results.put(key, master, generation=entry.generation)
        # coalesced followers re-slice their own top_k from the leader's
        # histogram — each gets a private copy, like a cache hit
        for f, f_req, f_kws, f_trace, f_t_submit in followers:
            result = self._serve_hit(lane, master, f_req, f_kws,
                                     coalesced=True, trace=f_trace)
            lane.latency.observe((time.perf_counter() - f_t_submit) * 1e3)
            self._resolve(f, result=result)
        self._resolve(outer, result=resp)

    def query(self, schema: str, request: FCTRequest,
              timeout: Optional[float] = None) -> FCTResponse:
        """Synchronous convenience wrapper over ``submit``."""
        return self.submit(schema, request).result(timeout=timeout)

    # -- incremental ingest --------------------------------------------------

    def append(self, schema: str, relation: str, rows) -> AppendResult:
        """Append rows to one tenant relation and keep its caches WARM.

        Routes to the tenant session's :meth:`repro_torch.api.FCTSession.append`
        (chunked store growth, in-place tuple-set patching, epoch bump),
        then reconciles the tenant's memoized results per
        ``config.append_policy``:

        ``"patch"`` (default) — drain the result cache and add each entry's
        exact delta histogram (``session.delta_freq``; deduped by
        (keywords, r_max): the delta is invariant to mode/rho/sample_frac/
        salt), re-finalizing the top-k from the patched histogram.  This
        covers device-topk tenants too: their cached masters always carry
        the full histogram (``submit`` forces ``need_histogram`` on cache
        fills).  Patching is bit-identical to a cold re-query: integer
        histograms are additive, and under an int32 tenant the int32 wrap
        a cold accumulation would hit is emulated on the patched totals —
        a patch that *would* overflow raises the cold path's
        ``OverflowError`` (the affected entries are dropped, not served).

        ``"drop"`` — just invalidate the memoized results.

        The drain doubles as a generation fence: queries dispatched before
        the append insert under the old generation and are discarded, while
        entries that raced in *after* the session append (their
        ``data_epoch`` already covers the new rows) are re-inserted
        unpatched — never double-counted.  Appends to one tenant are
        serialized on a per-lane lock; queries keep flowing concurrently.

        Each call records its own trace (``AppendResult.trace``): a
        ``gateway.append`` root over ``session.append``, the
        ``session.delta_freq`` of each distinct (keywords, r_max) and
        ``gateway.patch`` (arg ``entries``); the lane's counters
        ``gateway.appends``, ``gateway.append_ns`` and
        ``gateway.delta_plan_ns`` add up the same spans' durations.
        """
        if self._closed:
            raise RuntimeError("gateway is closed")
        lane = self._lane(schema)             # KeyError on unknown name
        trace = Trace()
        with lane.append_lock:
            try:
                with trace.activate(), obs_span("gateway.append",
                                                relation=relation):
                    result = self._append(lane, relation, rows)
            finally:
                self._count_append(lane, trace)
        return dataclasses.replace(result, trace=trace)

    @staticmethod
    def _count_append(lane: _Lane, trace: Trace) -> None:
        """Add one append's span durations to the lane's counters."""
        spans = trace.spans()
        deltas = {s.span_id for s in spans if s.name == "session.delta_freq"}
        lane.c_appends.inc()
        lane.c_append_ns.inc(sum(s.dur_ns for s in spans
                                 if s.name == "gateway.append"))
        lane.c_delta_plan_ns.inc(sum(
            s.dur_ns for s in spans
            if s.name == "plan.cn_plan" and s.parent_id in deltas))

    def _append(self, lane: _Lane, relation: str, rows) -> AppendResult:
        """The body of :meth:`append`, under the lane's append lock."""
        result = lane.session.append(relation, rows)
        if result.rows_appended == 0:
            return result
        if self.config.append_policy == "drop":
            lane.results.invalidate()
            return result
        gen, entries = lane.results.drain()
        stale = []
        for key, master in entries:
            if master.data_epoch >= result.data_epoch:
                # already computed over the appended data (the query raced
                # in between session append and drain): patching would
                # double-count the new rows
                lane.results.put(key, master, generation=gen)
            else:
                stale.append((key, master))
        # one delta per (sorted keywords, r_max): it is invariant to
        # mode/rho/sample_frac/salt
        deltas: Dict[tuple, object] = {}
        for key, _ in stale:
            if (key[0], key[1]) not in deltas:
                deltas[key[0], key[1]] = lane.session.delta_freq(
                    result, key[0], key[1])
        policy = lane.session.accum_policy
        with obs_span("gateway.patch", entries=len(stale)):
            for key, master in stale:
                delta = deltas[key[0], key[1]]
                patched = master.all_freqs + delta   # int64: exact
                if policy.check_wrap:
                    # emulate the tenant's int32 device accumulation on the
                    # patched totals (symmetric wrap into int32 range) so a
                    # patch past 2^31 raises exactly what a cold re-query
                    # would; below the limit the wrap is the identity
                    patched = ((patched + (1 << 31)) % (1 << 32)) - (1 << 31)
                policy.check_totals(patched)  # raises OverflowError on wrap
                ids, f = topk_terms(patched, key[0], master.request.top_k,
                                    lane.session.stop_mask)
                terms = lane.session.decode_terms(ids)
                lane.results.put(key, dataclasses.replace(
                    master, terms=terms, term_ids=ids, freqs=f,
                    all_freqs=patched, data_epoch=result.data_epoch),
                    generation=gen)
                lane.c_patched.inc()
        return result

    # -- cache control -------------------------------------------------------

    def invalidate(self, schema: str) -> int:
        """Data-mutation hook for one tenant: drop every memoized result
        AND the session's data-derived caches — tuple sets, routing plans
        and the device-resident relation store — so the next query replans
        and re-uploads against the mutated relations.  Returns the number
        of result-cache entries dropped."""
        with self._lock:
            lane = self._lanes.get(schema)
        if lane is None:
            if schema not in self.registry:
                raise KeyError(f"unknown schema {schema!r}")
            if self.registry.built(schema):  # served elsewhere: still stale
                self.registry.session(schema).invalidate()
            return 0                       # never served here: nothing cached
        # session first, results LAST: the result cache's generation bump
        # must postdate the session-cache clear, so a query racing through
        # still-populated session caches registered an OLD generation and
        # its pre-mutation result is dropped at cache-insert time
        lane.session.invalidate()
        return lane.results.invalidate()

    # -- lifecycle / introspection ------------------------------------------

    def stats(self) -> Dict[str, dict]:
        """Per-tenant result-cache + batch-occupancy + session counters
        (including the tenant's advertised ``accum_policy``), plus
        gateway-wide admission and flush-concurrency counters under
        ``"gateway"``."""
        with self._lock:
            lanes = dict(self._lanes)
        submitted, rejected = self.metrics.values(self._c_submitted,
                                                  self._c_rejected)
        out: Dict[str, dict] = {"gateway": {
            "submitted": submitted, "rejected": rejected,
            "max_inflight": self.config.max_inflight,
            "max_inflight_per_tenant": self.config.max_inflight_per_tenant,
            "tenants": len(lanes)}}
        out["gateway"].update(self._flush_pool.stats())
        for name, lane in lanes.items():
            stats = dict(lane.results.stats())
            stats.update(lane.batcher.stats())
            stats.update(lane.session.stats())   # carries accum_policy
            stats["coalesced"] = lane.c_coalesced.value
            stats["histograms_patched"] = lane.c_patched.value
            out[name] = stats
        return out

    def close(self) -> None:
        """Flush every tenant's pending window and stop serving.  Sessions
        belong to the registry (which may back other gateways) — close it
        separately when the process is done with the datasets."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            lanes = dict(self._lanes)
        for lane in lanes.values():
            lane.batcher.close()
        self._flush_pool.shutdown()

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
