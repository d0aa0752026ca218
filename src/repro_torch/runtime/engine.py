"""Batched, cached FCT query execution engine.

The planner (core/plan.py) stays per-CN; this module owns everything after
planning:

  1. bucket every plan's data-dependent dims to a PlanSignature (batch.py),
  2. group same-signature CNs along a leading CN axis,
  3. run ONE device program per group — routing, MR¹ and MR² over the CN
     axis (core/fct.py), the ``[N, vocab]`` histograms summed on device, and
     cross-worker aggregation in one of the reference's two layouts: a sum
     over the worker axis (psum), or that sum padded to a multiple of P on
     multi-worker meshes (the reduce-scatter layout, ``vocab_padded``), so
     collection slices exactly as the reference's does — so a query costs
     one program run and one device->host transfer per signature, not per
     CN,
  4. memoize the built programs in an ExecutableCache keyed by
     (family, signature, N, mesh, aggregation), so warm queries build
     nothing,
  5. gather the tuple-set ``text``/``keys`` columns from a RelationStore's
     DEVICE-RESIDENT tensors (store.py), and take each plan's send tables
     and fact key-column indices from the device copies its routes keep
     (uploaded at the plan's first dispatch): a memoized plan's dispatch
     ships nothing.  A caller without a store (``store=None``) gets a
     store of its own for the call, so its columns upload with the call
     and die with it,
  6. on CUDA, replay a group whose inputs are the very tensors of an
     earlier dispatch from three CUDA graphs — routing, MR¹, MR² —
     captured at its second dispatch (graphs.py): the same kernels, three
     launches from the host.

A group's program is three stages (:func:`_build_stages`), run in order by
one loop in :meth:`FCTEngine._dispatch_group`, eagerly or as graph
replays.  Two histogram families share them: ``fct_store`` sums the CN
axis (single-query ``query``); ``fct_store_percn`` keeps it, with the CN
axis rounded up to a multiple of ``CN_BUCKET_MIN`` by null CNs when
bucketing, so CNs of different queries can share one dispatch
(``query_batch``).

A third family, ``fct_topk``, finalizes on the device: the aggregated
histogram stays device-resident and only O(k) candidates (counts, term ids,
a wrap flag) reach the host (``dispatch_topk`` / ``collect_topk``).

Dispatch enqueues device work and returns the lazy tensor; collection
(``.cpu()``) is the only point that waits on the device (the opt-in
``threshold`` pruning of ``dispatch_topk`` adds one O(k) probe).  On CUDA,
``dispatch_plans`` also enqueues each group's copy into pinned host memory
right behind the group, with an event (:class:`HostCopy`): collection waits
for that group alone.  A ``.cpu()`` at collection would queue its copy
behind every group enqueued since on the one stream, so with queries in
flight (the submit pipeline) each collection would drain the stream.  Integer
histograms make the batched sum exactly associative, so ``all_freqs`` is
bit-identical to the per-CN path as long as every term's total fits the
policy width.  Under
``INT32_CHECKED`` the host collection raises OverflowError on wrap-around
(negative totals, best-effort); under ``INT64_EXACT`` everything accumulates
in int64.

Tracing.  Each dispatched group is an ``engine.dispatch_group`` obs span on
the active trace (args ``path``, always ``store``, ``family``, ``n_cns``,
``n_devices`` and ``built``, true when the dispatch built its program),
with children ``store.group_args`` (args ``send_bytes``, the bytes its
first-use uploads shipped, and ``send_hits``), ``engine.upload`` (``bytes``
0: it only records the first stage event; ``bench/`` still reads it) and
``fct.route`` / ``fct.mr1`` / ``fct.mr2``, one around each stage, eager or
replayed: host time, all of it.  The group span's ``graph`` arg says how
the group ran: ``eager``, ``capture`` (captured, then replayed) or
``replay``.  Device time per stage comes from four CUDA events a group,
recorded on the current stream before the first stage and after each
stage when the caller passes a ``stages`` list, and resolved after the
collection's wait (:meth:`FCTEngine.device_stage_ms`); the MR² stage ends
after the aggregation.  This module also installs the obs
span hook: while a torch profiler records, every obs span opens a
``record_function`` range of its name, so the profile shows the program's
spans on its own clock beside the kernels they launch.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.accum import AccumPolicy
from repro_torch.core.fct import _mr1_volumes, _mr2_histograms, _route_cn
from repro_torch.core.plan import CNPlan
from repro_torch.launch.mesh import (VirtualMesh, all_gather, psum,
                                     psum_scatter, vocab_padded)
from repro_torch.obs import default_registry, set_span_hook
from repro_torch.obs import span as obs_span
from repro_torch.runtime.batch import (BUCKET_MIN, PlanSignature, RelationSig,
                                       bucket_pow2, group_plan_indices,
                                       plan_signature)
from repro_torch.runtime.cache import ExecutableCache, default_cache
from repro_torch.runtime.graphs import CAPTURE, EAGER, REPLAY, GraphCache
from repro_torch.runtime.store import RelationStore, store_group_args

CN_BUCKET_MIN = 4  # floor for bucketing the per-CN-output programs' N axis
TOPK_BUCKET_MIN = 16  # floor for bucketing the fct_topk family's k axis
KW_BUCKET_MIN = 8  # floor for padding the keyword-exclusion id vector

#: structural filler for the fct_topk family's PlanSignature: the finalize
#: program reads no relations (its input is the already-aggregated
#: histogram), but the signature type is shared with the histogram families,
#: so the relation slot carries one fixed minimal shape.
_TOPK_REL = RelationSig(rows=BUCKET_MIN, cap=BUCKET_MIN, text_len=BUCKET_MIN)

#: the device-stage keys :meth:`FCTEngine.device_stage_ms` fills, in the
#: order of the events that bound them
DEVICE_STAGES = ("device_route_ms", "device_mr1_ms", "device_mr2_ms")
#: the obs spans of a group's stages, opened around each stage's eager run
#: or graph replay
STAGE_SPANS = ("fct.route", "fct.mr1", "fct.mr2")

_PROFILER = torch.autograd.profiler


def _profiler_range(name: str):
    """The obs span hook: a ``record_function`` range of the span's name
    while a torch profiler records, else None (one check)."""
    if not _PROFILER._is_profiler_enabled:
        return None
    rng = _PROFILER.record_function(name)
    rng.__enter__()
    return rng


set_span_hook(_profiler_range)


class _GroupMarks:
    """Timing events of one dispatched group, taken from the engine's pool
    as they are recorded: before routing, after routing, after MR¹, after
    MR²."""

    __slots__ = ("pool", "events")

    def __init__(self, pool: collections.deque) -> None:
        self.pool = pool
        self.events: List[torch.cuda.Event] = []

    def record(self) -> None:
        try:
            ev = self.pool.pop()
        except IndexError:      # the pool grows to the most events in flight
            ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)


def _mark(marks: Optional[_GroupMarks]) -> None:
    """Record the next stage boundary on the device stream, if asked."""
    if marks is not None:
        marks.record()


def _mr2_token_slots(sig: PlanSignature, n_stack: int) -> int:
    """Token slots one group hands to ``weighted_histogram``: every routed
    row slot of every relation, ``n_stack * P * P * cap``, times its padded
    ``text_len`` — padding and null CNs included, as launched."""
    P = sig.n_devices
    return n_stack * P * P * sum(r.cap * r.text_len
                                 for r in (sig.fact,) + tuple(sig.dims))


def _route_slots(sig: PlanSignature, n_stack: int) -> int:
    """Gather slots one group's routing launches: ``n_stack * P * P * cap``
    of every routed relation, the caps as the signature buckets them."""
    P = sig.n_devices
    return n_stack * P * P * sum(r.cap for r in (sig.fact,) + tuple(sig.dims))


def _aggregate(hists: torch.Tensor, sig: PlanSignature, reduce_cns: bool,
               reduce_scatter: bool) -> torch.Tensor:
    """The cross-CN sum and the cross-worker aggregation of a group's ``[N,
    vocab]`` histograms.

    The histograms come back already summed over the virtual mesh's worker
    axis (core.fct folds the psum into the histogram's row axis), so the
    aggregation is one named collective, :func:`psum` or
    :func:`psum_scatter` (``launch/mesh.py``).  The cross-CN sum
    accumulates in the signature's AccumPolicy dtype — explicitly, so
    individually-fine int32 CNs summing past 2^31 wrap (and are caught on
    collection) under INT32_CHECKED and stay exact under INT64_EXACT.
    Under ``reduce_scatter`` the vocab axis is padded to a multiple of P,
    the layout of the reference's ``psum_scatter`` output gathered to the
    host; otherwise it is the reference's psum layout, the whole vocab.
    Integer addition is associative, so both give bit-identical totals."""
    acc = sig.accum.dtype
    out = hists.sum(dim=0, dtype=acc) if reduce_cns else hists.to(acc)
    if reduce_scatter:
        return psum_scatter(out, sig.n_devices)
    return psum(out)


def _build_stages(sig: PlanSignature, reduce_cns: bool,
                  reduce_scatter: bool):
    """The program of one signature group as its three stages, over
    ``store_group_args``' device-resident arguments (``core/fct.py``):

      * ``route(fact, dims)`` -> the routed relations,
      * ``mr1(routed)`` -> their volumes,
      * ``mr2(routed, volumes)`` -> the group's output: the histograms
        with :func:`_aggregate`.

    ``reduce_cns=True``  -> freq[vocab]     (CN axis summed on device)
    ``reduce_cns=False`` -> freq[N, vocab]  (per-CN totals)
    """
    domains = tuple(d.domain for d in sig.dims)

    def mr1(routed):
        return _mr1_volumes(*routed, domains, sig.accum)

    def mr2(routed, vols):
        return _aggregate(_mr2_histograms(*routed, *vols, sig.vocab), sig,
                          reduce_cns, reduce_scatter)

    return _route_cn, mr1, mr2


def _stage_steps(stages, fact, dims):
    """Runs a group's ``(route, mr1, mr2)`` stages in order, one a
    ``next()``: yields the routed relations, their volumes, then the
    group's output."""
    route, mr1, mr2 = stages
    routed = route(fact, dims)
    yield routed
    vols = mr1(routed)
    yield vols
    yield mr2(routed, vols)


def topk_signature(vocab: int, n_devices: int, accum: AccumPolicy,
                   k: int) -> PlanSignature:
    """Signature of the ``fct_topk`` finalize program for a top-``k``
    request.  ``k_bucket`` rounds ``k + 1`` up to a power of two (floor
    ``TOPK_BUCKET_MIN``): the ``+1`` keeps the (k+1)-th count in the
    candidate set — the threshold the pruning loop compares remaining group
    bounds against — and bucketing lets nearby k share one program."""
    return PlanSignature(n_devices=n_devices, vocab=vocab, fact=_TOPK_REL,
                         dims=(), accum=accum,
                         k_bucket=bucket_pow2(k + 1, TOPK_BUCKET_MIN))


def k_effective(sig: PlanSignature) -> int:
    """Candidates the finalize program returns: ``k_bucket`` clamped to the
    vocab (a top-k past the vocab size is just the whole excluded vocab)."""
    return min(sig.k_bucket, sig.vocab)


def keyword_ids_array(keywords: Sequence[int]) -> np.ndarray:
    """Keyword-exclusion ids as int32, ``-1``-padded to a pow-2 width (the
    width rides the program-cache key): ``-1`` never equals a vocab id, so
    pad slots exclude nothing."""
    kw_pad = bucket_pow2(max(len(keywords), 1), KW_BUCKET_MIN)
    out = np.full((kw_pad,), -1, np.int32)
    if len(keywords):
        out[:len(keywords)] = list(keywords)
    return out


def _top(values: torch.Tensor, k: int):
    """(values, positions) of the ``k`` largest along the last axis, equal
    values in ascending position — the order ``lax.top_k`` promises and
    ``torch.topk`` does not: a stable descending sort, sliced."""
    v, pos = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], pos[..., :k]


def _build_topk_fn(sig: PlanSignature, mesh: VirtualMesh,
                   reduce_scatter: bool):
    """Finalize program of the ``fct_topk`` family.

    Input is the device-resident aggregated histogram in the engine's
    aggregation layout (under ``reduce_scatter`` on P > 1 workers, padded
    to a multiple of P, worker w owning bins ``[w*shard, (w+1)*shard)``;
    otherwise the psum layout, the whole vocab as one shard), the host
    keyword ids and an int8 stop/PAD exclusion vector in the histogram's
    layout.  On the virtual mesh, for each shard:

      1. flag wrap-around (any negative bin) BEFORE exclusions — the
         INT32_CHECKED overflow check runs on the device, so the host never
         has to read the O(vocab) histogram to enforce it,
      2. zero the excluded bins (keywords by id equality, stopwords/PAD via
         the mask), matching the host oracle, which zeroes before slicing,
         and set reduce-scatter vocab-pad bins to ``-1`` so they sort
         strictly below every real (nonnegative, post-exclusion) bin,
      3. take the shard's local top-k — O(k) candidates per worker,
      4. concatenate the workers' (count, id) candidates worker-major (the
         reference's tiled ``all_gather`` over the SMALL k axis) and take
         the top ``k_eff`` of the ``P * shard_k`` candidates.

    Ties go to the LOWEST term id, as in the host oracle's stable
    ``argsort(-f)``: each selection keeps equal values in ascending position
    (``_top``), shard-local positions map to ascending global ids, and the
    worker-major concatenation keeps ids ascending within each count.

    One shard (psum, or one worker) skips the gather: it is the whole
    vocab.  Returns ``(counts [k_eff] policy dtype, ids [k_eff] int32,
    wrapped int32 scalar)``, all on the device.
    """
    vocab = sig.vocab
    n_shards = sig.n_devices if reduce_scatter else 1
    vp = vocab_padded(vocab, n_shards)
    shard = vp // n_shards
    k_eff = k_effective(sig)
    shard_k = min(k_eff, shard)
    device = mesh.device

    def program(hist: torch.Tensor, kw: np.ndarray, excl: torch.Tensor):
        # hist [vp] acc · kw [pow-2 width] int32 (-1 pads) · excl [vp] int8
        kw_t = torch.from_numpy(kw).to(device)
        wrapped = (hist < 0).any().to(torch.int32)
        ids = torch.arange(vp, dtype=torch.int32, device=device)
        is_kw = (ids[:, None] == kw_t[None, :]).any(dim=1)
        h = torch.where(is_kw | (excl != 0), 0, hist)
        if vp != vocab:
            h = torch.where(ids >= vocab, -1, h)
        v, local = _top(h.view(n_shards, shard), shard_k)
        cand = ids.view(n_shards, shard).gather(1, local)
        if n_shards == 1:
            return v[0, :k_eff], cand[0, :k_eff], wrapped
        all_v, all_ids = all_gather(v, cand)   # worker-major candidates
        fv, pos = _top(all_v, k_eff)
        return fv, all_ids[pos], wrapped

    return program


class HostCopy(NamedTuple):
    """A group's output copied into pinned host memory on the current
    stream at dispatch, and the event recorded after the copy."""

    host: torch.Tensor
    done: torch.cuda.Event


def _to_host(out: torch.Tensor) -> HostCopy:
    """Enqueues ``out``'s copy to pinned host memory and an event behind
    it; nothing waits here."""
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return HostCopy(host, done)


@dataclasses.dataclass
class TopkPending:
    """Pending handle of :meth:`FCTEngine.dispatch_topk`: lazy O(k) device
    outputs plus the pruning ledger.  Block via
    :meth:`FCTEngine.collect_topk`."""

    counts: torch.Tensor  # lazy [k_eff] device tensor, policy dtype
    ids: torch.Tensor     # lazy [k_eff] int32 global term ids
    wrapped: torch.Tensor  # lazy int32 scalar overflow flag
    k_eff: int
    vocab: int
    groups_run: int
    groups_pruned: int
    pruned_rows: int


class FCTEngine:
    """Query execution runtime: shape-bucketed program cache + batched
    multi-CN dispatch.  The default engine (``default_engine()``) shares
    the process-wide cache.

    ``batch=False`` dispatches one program per CN (still cached/bucketed);
    ``bucket=False`` keys on exact shapes (still cached/batched).

    ``bytes_shipped`` counts host→device argument bytes per dispatch — a
    plan's first-use send tables and key-column indices, counted as
    ``send_uploads`` (tables uploaded) beside ``send_hits`` (tables found
    on the device), and the top-k family's keyword and exclusion vectors;
    column uploads are the RelationStore's (``store.upload_bytes``), a
    storeless call's included; ``device_to_host_bytes`` counts
    collection; ``groups_pruned`` / ``pruned_rows`` count the signature
    groups (and their routed fact rows) the top-k family skipped;
    ``fct_count_tokens`` counts the token slots MR² hands to
    ``weighted_histogram`` (rows × ``text_len``, padding included), from
    the launched shapes; ``route_slots`` the gather slots the routing
    launches (``N·P·P·cap`` of every relation, as bucketed) beside
    ``route_rows``, the rows the group's plans send (``shuffle_rows``).
    ``graph_eager``, ``graph_captures`` and ``graph_replays`` count the
    groups that ran eagerly, were captured as CUDA graphs (and
    replayed once), and were replayed (:attr:`graphs`, graphs.py).

    ``reduce_scatter=True`` (default) returns multi-worker aggregates in the
    reduce-scatter layout (vocab padded to a multiple of P, each worker
    owning ``vocab/P`` bins) and one worker's in the psum layout; ``False``
    uses the psum layout everywhere (the equivalence baseline).  Both give
    bit-identical totals; the choice is part of the program-cache key.
    """

    def __init__(self, cache: Optional[ExecutableCache] = None,
                 batch: bool = True, bucket: bool = True,
                 reduce_scatter: bool = True, metrics=None) -> None:
        self.metrics = metrics if metrics is not None else default_registry()
        self.cache = cache if cache is not None else ExecutableCache(
            metrics=self.metrics)
        self.batch = batch
        self.bucket = bucket
        self.reduce_scatter = reduce_scatter
        self._c_batches = self.metrics.counter("engine.batches_run")
        self._c_cns = self.metrics.counter("engine.cns_run")
        self._c_bytes = self.metrics.counter("engine.bytes_shipped")
        self._c_d2h = self.metrics.counter("engine.device_to_host_bytes")
        self._c_groups_pruned = self.metrics.counter("engine.groups_pruned")
        self._c_pruned_rows = self.metrics.counter("engine.pruned_rows")
        self._c_fct_tokens = self.metrics.counter("engine.fct_count_tokens")
        self._c_route_slots = self.metrics.counter("engine.route_slots")
        self._c_route_rows = self.metrics.counter("engine.route_rows")
        # store path: send tables uploaded at a plan's first dispatch, and
        # those later dispatches found on the device
        self._c_send_uploads = self.metrics.counter("engine.send_uploads")
        self._c_send_hits = self.metrics.counter("engine.send_hits")
        # groups by how they ran (graphs.py)
        self._c_graph = {
            mode: self.metrics.counter(name) for mode, name in (
                (EAGER, "engine.graph_eager"),
                (CAPTURE, "engine.graph_captures"),
                (REPLAY, "engine.graph_replays"))}
        #: the groups' CUDA graphs, by input identity
        self.graphs = GraphCache()
        # recycled CUDA timing events of the device-stage timers
        self._events: collections.deque = collections.deque()

    @property
    def batches_run(self) -> int:
        return self._c_batches.value

    def _reduce_scatters(self, n_devices: int) -> bool:
        """Whether aggregates over ``n_devices`` workers come in the
        reduce-scatter layout: on one worker the two layouts are one."""
        return self.reduce_scatter and n_devices > 1

    def _group(self, plans: Sequence[CNPlan],
               accum: Optional[AccumPolicy] = None
               ) -> List[Tuple[PlanSignature, List[int]]]:
        """Signature groups as plan indices; singletons when unbatched."""
        if not self.batch:
            return [(plan_signature(p, self.bucket, accum), [i])
                    for i, p in enumerate(plans)]
        return group_plan_indices(plans, self.bucket, accum)

    def _dispatch(self, sig: PlanSignature, group: Sequence[CNPlan],
                  mesh: VirtualMesh, reduce_cns: bool, store: RelationStore,
                  stages: Optional[list] = None):
        """Span shell around :meth:`_dispatch_group`: one
        ``engine.dispatch_group`` span per launch on the active trace (a
        recording torch profiler sees it as a range of the same name, via
        the obs span hook this module installs)."""
        family = "sum" if reduce_cns else "percn"
        with obs_span("engine.dispatch_group", n_cns=len(group), path="store",
                      family=family, n_devices=sig.n_devices) as group_span:
            return self._dispatch_group(sig, group, mesh, reduce_cns, store,
                                        stages, group_span)

    def _dispatch_group(self, sig: PlanSignature, group: Sequence[CNPlan],
                        mesh: VirtualMesh, reduce_cns: bool,
                        store: RelationStore, stages: Optional[list] = None,
                        group_span=None):
        """Enqueue one group on the device; returns the LAZY result tensor
        (callers block via ``_collect``).

        When bucketing, the per-CN-output family rounds the CN axis up to a
        multiple of CN_BUCKET_MIN (zero-contribution null-plan padding), so
        batch compositions share programs; the summed family keeps exact N.

        Relation columns, send tables and fact key-column indices are all
        device-resident, and only a plan's first dispatch ships its tables
        (``store_group_args``).  The group's three stages then run in one
        loop, each inside its ``fct.*`` span and followed by its stage
        event: eagerly, or, on a CUDA mesh when the inputs are the very
        tensors of an earlier dispatch, as CUDA graphs captured at the
        second such dispatch and replayed from then on (:attr:`graphs`).

        ``stages`` (a list) asks for the group's device-stage events on
        CUDA: four are recorded and appended to it as one entry.
        ``group_span`` (the group's span) gets ``built`` and ``graph``.
        """
        n_stack = len(group)
        if not reduce_cns and self.bucket:
            n_stack = -(-n_stack // CN_BUCKET_MIN) * CN_BUCKET_MIN
        if store.mesh != mesh:
            raise ValueError("the store is bound to another mesh")
        with obs_span("store.group_args", n_stack=n_stack) as ga:
            args = store_group_args(store, group, sig, n_stack)
            ga.args["send_bytes"] = args.shipped
            ga.args["send_hits"] = args.send_hits
        # the aggregation layout rides the cache key so both program
        # variants can coexist
        rs = self._reduce_scatters(sig.n_devices)
        kind = "fct_store" if reduce_cns else "fct_store_percn"
        key = (kind, sig, n_stack, mesh, "rs" if rs else "psum")
        program, built = self.cache.fetch(
            key, lambda: _build_stages(sig, reduce_cns, rs))
        self._c_bytes.inc(args.shipped)
        self._c_send_uploads.inc(args.send_uploads)
        self._c_send_hits.inc(args.send_hits)
        graph, entry = self.graphs.decide(key, mesh.device, args.inputs)
        self._c_graph[graph].inc()
        if group_span is not None:
            group_span.args["built"] = built
            group_span.args["graph"] = graph
        marks = (_GroupMarks(self._events)
                 if stages is not None and mesh.device.type == "cuda"
                 else None)
        steps = _stage_steps(program, args.fact, args.dims)
        rows = n_stack * sig.n_devices ** 2 * sig.fact.cap
        # a capture and the replays (output copy included) hold the lock
        with (self.graphs.lock if graph != EAGER
              else contextlib.nullcontext()):
            if graph == CAPTURE:
                self.graphs.capture_group(entry, steps, mesh.device)
            with obs_span("engine.upload", bytes=0):
                _mark(marks)
            for i, name in enumerate(STAGE_SPANS):
                with obs_span(name, n_cns=n_stack, rows=rows):
                    out = (next(steps) if graph == EAGER
                           else entry.graphs.replay(i))
                    _mark(marks)
        if marks is not None:
            stages.append(marks.events)
        self._c_batches.inc()
        self._c_cns.inc(len(group))
        self._c_fct_tokens.inc(_mr2_token_slots(sig, n_stack))
        self._c_route_slots.inc(_route_slots(sig, n_stack))
        self._c_route_rows.inc(sum(p.shuffle_rows for p in group))
        return out

    @contextlib.contextmanager
    def _call_store(self, store: Optional[RelationStore], mesh: VirtualMesh):
        """``store``, or for a storeless call a RelationStore of the call's
        own on the engine's metrics (its column uploads count in
        ``store.upload_bytes``), emptied when the call ends: its columns
        live as long as the call."""
        if store is not None:
            yield store
            return
        own = RelationStore(mesh, metrics=self.metrics)
        try:
            yield own
        finally:
            own.clear()

    def device_stage_ms(self, stages: list) -> Dict[str, float]:
        """Device milliseconds of routing, MR¹ and MR² summed over the
        groups whose events ``stages`` holds (``DEVICE_STAGES`` keys; empty
        when it holds none, as off CUDA): the time between consecutive
        events on the stream, kernels and any idle between them.  Call it after the wait on the
        groups' results: the events are complete then, so reading them
        adds no synchronisation.  The events go back to the pool."""
        if not stages:
            return {}
        sums = [0.0] * len(DEVICE_STAGES)
        for events in stages:
            for i in range(len(DEVICE_STAGES)):
                sums[i] += events[i].elapsed_time(events[i + 1])
            self._events.extend(events)
        stages.clear()
        return {k: round(v, 4) for k, v in zip(DEVICE_STAGES, sums)}

    def _collect(self, lazy) -> np.ndarray:
        if isinstance(lazy, HostCopy):
            lazy.done.synchronize()  # the one wait: this group's work
            raw = lazy.host.numpy()
        else:
            raw = lazy.cpu().numpy()     # the one wait on the device
        self._c_d2h.inc(raw.nbytes)
        # the dtype IS the policy on the collection side: int32 results were
        # accumulated under INT32_CHECKED, whose contract is to fail loudly
        # on wrap-around instead of returning silently wrong counts
        AccumPolicy.for_dtype(raw.dtype).check_totals(raw)
        return raw.astype(np.int64)

    def dispatch_plans(self, plans: Sequence[CNPlan], mesh: VirtualMesh,
                       individual: bool = False,
                       store: Optional[RelationStore] = None,
                       accum: Optional[AccumPolicy] = None,
                       stages: Optional[list] = None):
        """Async half of a run: enqueue every signature group and return a
        pending handle ``[(plan_indices, lazy_result), ...]`` (on CUDA each
        result a :class:`HostCopy` already on its way); block with
        ``collect_total`` / ``collect_individual``.  ``individual=True``
        keeps the per-CN output axis so CNs of different queries can share
        a dispatch.  ``store`` (a RelationStore bound to this mesh) holds
        the relation columns; ``None`` uploads them to a store of the
        call's own, dropped when the call ends.  ``accum`` pins the
        AccumPolicy (default int32-checked).  ``stages`` collects the
        groups' device-stage events on CUDA (:meth:`device_stage_ms`)."""
        if not plans:
            raise ValueError("dispatch_plans needs at least one plan")
        pending = []
        with self._call_store(store, mesh) as store:
            for sig, idxs in self._group(plans, accum):
                lazy = self._dispatch(sig, [plans[i] for i in idxs], mesh,
                                      not individual, store, stages)
                if mesh.device.type == "cuda":
                    lazy = _to_host(lazy)
                pending.append((idxs, lazy))
        return pending

    def collect_total(self, pending, vocab: int) -> np.ndarray:
        """Block on an ``individual=False`` handle: total freq[vocab]; the
        (structurally zero) reduce-scatter pad bins are sliced off."""
        total = np.zeros((vocab,), np.int64)
        for _, lazy in pending:
            total += self._collect(lazy)[:vocab]
        return total

    def collect_individual(self, pending, n_plans: int,
                           vocab: int) -> np.ndarray:
        """Block on an ``individual=True`` handle: freq[n_plans, vocab]."""
        out = np.zeros((n_plans, vocab), np.int64)
        for idxs, lazy in pending:
            # drop the CN-axis pad and the reduce-scatter vocab pad
            out[idxs] = self._collect(lazy)[:len(idxs), :vocab]
        return out

    def vocab_device_vector(self, vec: np.ndarray, mesh: VirtualMesh,
                            dtype) -> torch.Tensor:
        """Upload a host ``[vocab]`` vector in the engine's aggregation
        layout — the layout group outputs arrive in: zero-padded to a
        multiple of P under reduce-scatter on multi-worker meshes, as is
        otherwise — so the caller can add it to (or feed it beside)
        device-resident histograms.  Counted as shipped bytes."""
        # fct-lint: waive[R4] -- vec is a host numpy vector: nothing is read from the device
        arr = np.asarray(vec).astype(dtype, copy=True)
        if self._reduce_scatters(mesh.size):
            vp = vocab_padded(len(arr), mesh.size)
            if vp != len(arr):
                arr = np.pad(arr, (0, vp - len(arr)))
        self._c_bytes.inc(arr.nbytes)
        return torch.from_numpy(arr).to(mesh.device)

    @staticmethod
    def _plan_rows(plans: Sequence[CNPlan], idxs: Sequence[int]) -> int:
        """Total routed fact rows of a set of plans (pruning ledger)."""
        return int(sum(int(plans[i].device_rows.sum(dtype=np.int64))
                       for i in idxs if plans[i].device_rows is not None))

    def dispatch_topk(self, plans: Sequence[CNPlan], mesh: VirtualMesh,
                      k: int, *, keywords: Sequence[int] = (), excl=None,
                      host_extra=None, store: Optional[RelationStore] = None,
                      accum: Optional[AccumPolicy] = None,
                      prune: str = "zero",
                      stages: Optional[list] = None) -> TopkPending:
        """Async top-k run: dispatch every signature group, keep the
        aggregated histogram DEVICE-RESIDENT (group outputs are summed on
        the device, never transferred), and finalize with the ``fct_topk``
        program — the pending handle resolves to O(k) candidates, not the
        O(vocab) histogram.

        ``prune`` is the cross-CN-group pruning mode, bounding each group's
        maximum possible contribution by its plans' total volume-weighted
        token mass (``CNPlan.contrib_bound``):

        * ``"off"`` — dispatch every group.
        * ``"zero"`` (default) — skip groups whose summed bound is exactly
          0.0: they provably contribute nothing to any term, so results
          stay bit-identical to the unpruned path.
        * ``"threshold"`` — additionally process groups in descending
          bound order and, after each, probe the running k-th and (k+1)-th
          counts (an O(k) transfer, the one wait inside a dispatch); once
          ``θ_k > θ_{k+1} + Σ remaining bounds``, no remaining group can
          displace any current top-k term and the whole suffix is skipped.
          The top-k SET is exact; the reported counts/order are those of
          the processed prefix (lower bounds), which is why this mode is
          opt-in.

        ``keywords`` and ``excl`` (an int8 stop/PAD mask from
        :meth:`vocab_device_vector`) reproduce the host oracle's exclusions
        on the device; ``host_extra`` is an optional device-resident
        histogram in the same layout added to the group total — sessions
        use it for map-only single-relation CNs, which have no routed plans.
        ``store`` and ``stages`` as for :meth:`dispatch_plans`.
        """
        if not plans:
            raise ValueError("dispatch_topk needs at least one plan")
        if prune not in ("off", "zero", "threshold"):
            raise ValueError(f"unknown prune mode {prune!r}")
        vocab = plans[0].vocab_size
        rs = self._reduce_scatters(mesh.size)
        groups = self._group(plans, accum)
        sig0 = groups[0][0]
        tsig = topk_signature(vocab, sig0.n_devices, sig0.accum, k)
        kw = keyword_ids_array(keywords)
        if excl is None:
            excl = self.vocab_device_vector(np.zeros(vocab, np.int8), mesh,
                                            np.int8)
        agg = "rs" if rs else "psum"
        key = ("fct_topk", tsig, len(kw), mesh, agg)
        topk_fn = self.cache.get_or_build(
            key, lambda: _build_topk_fn(tsig, mesh, rs))
        self._c_bytes.inc(kw.nbytes)

        bounds = [sum(plans[i].contrib_bound for i in idxs)
                  for _, idxs in groups]
        run_list = list(range(len(groups)))
        g_pruned = rows_pruned = 0
        if prune != "off":
            keep = [g for g in run_list if bounds[g] != 0.0]
            zero = [g for g in run_list if bounds[g] == 0.0]
            if not keep and host_extra is None and zero:
                # keep one group so a device histogram exists at all
                keep, zero = zero[:1], zero[1:]
            for g in zero:
                g_pruned += 1
                rows_pruned += self._plan_rows(plans, groups[g][1])
            run_list = keep
        if prune == "threshold":
            run_list.sort(key=lambda g: -bounds[g])

        total = host_extra
        groups_run = 0
        kk = min(k, vocab)
        with self._call_store(store, mesh) as store:
            for pos, g in enumerate(run_list):
                sig, idxs = groups[g]
                lazy = self._dispatch(sig, [plans[i] for i in idxs], mesh,
                                      True, store, stages)
                total = lazy if total is None else total + lazy
                groups_run += 1
                rest = run_list[pos + 1:]
                if prune == "threshold" and rest and kk + 1 <= tsig.k_bucket:
                    # O(k) probe of the running counts: prune the suffix
                    # once even its combined mass cannot displace the k-th
                    # count
                    head = topk_fn(total, kw, excl)[0].cpu().numpy()
                    self._c_d2h.inc(head.nbytes)
                    b_rest = sum(bounds[r] for r in rest)
                    if kk < len(head) and \
                            float(head[kk - 1]) > float(head[kk]) + b_rest:
                        for r in rest:
                            g_pruned += 1
                            rows_pruned += self._plan_rows(plans,
                                                           groups[r][1])
                        break

        with obs_span("engine.topk_finalize", k=k, k_eff=k_effective(tsig),
                      n_groups=len(groups), groups_pruned=g_pruned):
            counts, ids, wrapped = topk_fn(total, kw, excl)
        if g_pruned:
            self._c_groups_pruned.inc(g_pruned)
            self._c_pruned_rows.inc(rows_pruned)
        return TopkPending(counts=counts, ids=ids, wrapped=wrapped,
                           k_eff=k_effective(tsig), vocab=vocab,
                           groups_run=groups_run, groups_pruned=g_pruned,
                           pruned_rows=rows_pruned)

    def collect_topk(self, tp: TopkPending
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Block on a :meth:`dispatch_topk` handle:
        ``(term_ids[k_eff], counts[k_eff])`` int64, exclusion-masked and
        tie-broken by lowest term id — the O(k) transfer this family
        exists for.  Raises OverflowError when the device-side wrap flag
        is set (the INT32_CHECKED contract, checked on the device over the
        full histogram)."""
        counts = tp.counts.cpu().numpy()
        ids = tp.ids.cpu().numpy()
        wrapped = tp.wrapped.cpu().numpy()
        self._c_d2h.inc(counts.nbytes + ids.nbytes + wrapped.nbytes)
        if int(wrapped):
            # same failure contract/message as the host-side wrap check
            AccumPolicy.for_dtype(counts.dtype).check_totals(
                np.full((1,), -1, counts.dtype))
        return ids.astype(np.int64), counts.astype(np.int64)

    def run_plans(self, plans: Sequence[CNPlan], mesh: VirtualMesh,
                  store: Optional[RelationStore] = None,
                  accum: Optional[AccumPolicy] = None) -> np.ndarray:
        """Total freq[vocab] (int64) over all joined-CN plans."""
        pending = self.dispatch_plans(plans, mesh, store=store, accum=accum)
        return self.collect_total(pending, plans[0].vocab_size)

    def run_plans_individual(self, plans: Sequence[CNPlan],
                             mesh: VirtualMesh,
                             store: Optional[RelationStore] = None,
                             accum: Optional[AccumPolicy] = None
                             ) -> np.ndarray:
        """Per-plan freq[len(plans), vocab] (int64): plans from different
        queries may share one dispatch (same signature -> one stacked
        program); the per-CN output axis lets the caller attribute each
        histogram to its owning query."""
        pending = self.dispatch_plans(plans, mesh, individual=True,
                                      store=store, accum=accum)
        return self.collect_individual(pending, len(plans),
                                       plans[0].vocab_size)

    def stats(self) -> dict:
        out = self.cache.stats()
        (batches, cns, shipped, d2h, g_pruned, rows_pruned, tokens,
         send_uploads, send_hits, route_slots, route_rows, g_eager,
         g_captures, g_replays) = self.metrics.values(
            self._c_batches, self._c_cns, self._c_bytes, self._c_d2h,
            self._c_groups_pruned, self._c_pruned_rows, self._c_fct_tokens,
            self._c_send_uploads, self._c_send_hits, self._c_route_slots,
            self._c_route_rows, *self._c_graph.values())
        out.update(batches_run=batches, cns_run=cns, bytes_shipped=shipped,
                   device_to_host_bytes=d2h,
                   groups_pruned=g_pruned, pruned_rows=rows_pruned,
                   fct_count_tokens=tokens, send_uploads=send_uploads,
                   send_hits=send_hits, route_slots=route_slots,
                   route_rows=route_rows, graph_eager=g_eager,
                   graph_captures=g_captures, graph_replays=g_replays)
        return out


_DEFAULT_ENGINE: Optional[FCTEngine] = None


def default_engine() -> FCTEngine:
    """Process-wide engine (shared program cache)."""
    global _DEFAULT_ENGINE
    if _DEFAULT_ENGINE is None:
        _DEFAULT_ENGINE = FCTEngine(cache=default_cache())
    return _DEFAULT_ENGINE
