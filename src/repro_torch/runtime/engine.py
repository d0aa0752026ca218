"""Batched, cached FCT query execution engine.

The planner (core/plan.py) stays per-CN; this module owns everything after
planning:

  1. bucket every plan's data-dependent dims to a PlanSignature (batch.py),
  2. group same-signature CNs along a leading CN axis,
  3. run ONE device program per group — the MR¹+MR² body over the CN axis
     (core/fct.py), the ``[N, vocab]`` histograms summed on device, and
     cross-worker aggregation in the reference's layout: a sum over the
     worker axis, padded to a multiple of P on multi-worker meshes (the
     reduce-scatter layout, ``vocab_padded``) so collection slices exactly
     as the reference's does — so a query costs one program run and one
     device->host transfer per signature, not per CN,
  4. memoize the built programs in an ExecutableCache keyed by
     (family, signature, N, mesh), so warm queries
     build nothing,
  5. gather the tuple-set ``text``/``keys`` columns from the session's
     DEVICE-RESIDENT RelationStore (store.py): a dispatch ships only the
     stacked send tables plus the fact key-column indices.

Two program families share one body (``_vmapped_cns``): ``fct_store`` sums
the CN axis (single-query ``query``) and ``fct_store_percn`` keeps it, with
the CN axis rounded up to a multiple of ``CN_BUCKET_MIN`` by null CNs, so CNs
of different queries can share one dispatch (``query_batch``).

Dispatch enqueues device work and returns the lazy tensor; collection
(``.cpu()``) is the only point that waits on the device.  Integer histograms
make the batched sum exactly associative, so ``all_freqs`` is bit-identical to
the per-CN path as long as every term's total fits the policy width.  Under
``INT32_CHECKED`` the host collection raises OverflowError on wrap-around
(negative totals, best-effort); under ``INT64_EXACT`` everything accumulates
in int64.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.accum import INT32_CHECKED, AccumPolicy
from repro_torch.core.fct import _device_fct_local
from repro_torch.core.plan import CNPlan
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.obs import default_registry
from repro_torch.obs import span as obs_span
from repro_torch.runtime.batch import PlanSignature, group_plan_indices
from repro_torch.runtime.cache import ExecutableCache, default_cache
from repro_torch.runtime.store import RelationStore, store_group_args

CN_BUCKET_MIN = 4  # floor for bucketing the per-CN-output programs' N axis


def vocab_padded(vocab: int, n_devices: int) -> int:
    """Vocab rounded up so each worker owns an equal ``vocab/P`` bin shard
    under reduce-scatter aggregation.  The pad bins are structurally zero
    (the histogram never writes past ``vocab``), so slicing them off on the
    host is exact."""
    return -(-vocab // n_devices) * n_devices


def _vmapped_cns(fact, dims, sig: PlanSignature,
                 reduce_cns: bool) -> torch.Tensor:
    """Body shared by both program families: MR¹+MR² over the leading CN
    axis, then the cross-worker aggregation.

    The histograms come back already summed over the virtual mesh's worker
    axis (core.fct folds the psum into the histogram's row axis).  The
    cross-CN group sum accumulates in the signature's AccumPolicy dtype —
    explicitly, so individually-fine int32 CNs summing past 2^31 wrap (and
    are caught on collection) under INT32_CHECKED and stay exact under
    INT64_EXACT.  The vocab axis is padded to a multiple of P, the layout
    of the reference's ``psum_scatter`` output gathered to the host (no pad
    on one worker, the reference's psum layout)."""
    hists = _device_fct_local(fact, dims,
                              domains=tuple(d.domain for d in sig.dims),
                              vocab=sig.vocab,
                              accum=sig.accum)                 # [N, vocab]
    acc = sig.accum.dtype
    pad = vocab_padded(sig.vocab, sig.n_devices) - sig.vocab
    out = hists.sum(dim=0, dtype=acc) if reduce_cns else hists.to(acc)
    if pad:
        out = torch.nn.functional.pad(out, (0, pad))
    return out


def _build_store_fn(sig: PlanSignature, mesh: VirtualMesh, n_stack: int,
                    reduce_cns: bool = True):
    """Program over STORE-RESIDENT relation columns for one signature.

    Inputs per relation are ``n_stack`` device tensors (one per CN slot,
    each ``[P, S, ...]`` from the session's RelationStore) plus the
    host-shipped stacked send tables, which the program uploads; the fact
    additionally carries per-CN key-column indices that gather each CN's
    columns out of the full-width stored key matrix.
    """
    device = mesh.device

    def upload(rel, *names):
        out = dict(rel)
        for k in names:
            out[k] = torch.from_numpy(rel[k]).to(device)
        return out

    def program(fact, dims):
        with torch.profiler.record_function("fct.group_store"):
            return _vmapped_cns(upload(fact, "send", "cols"),
                                [upload(d, "send") for d in dims], sig,
                                reduce_cns)

    return program


class FCTEngine:
    """Query execution runtime: shape-bucketed program cache + batched
    multi-CN dispatch over the session's device-resident store.  The
    default engine (``default_engine()``) shares the process-wide cache.

    ``bytes_shipped`` counts host→device argument bytes per dispatch (send
    tables and key-column indices; store uploads are accounted by the
    RelationStore itself); ``device_to_host_bytes`` counts collection.

    Multi-worker aggregates come back in the reduce-scatter layout (vocab
    padded to a multiple of P), one worker's in the psum layout; both give
    bit-identical totals.
    """

    def __init__(self, cache: Optional[ExecutableCache] = None,
                 metrics=None) -> None:
        self.metrics = metrics if metrics is not None else default_registry()
        self.cache = cache if cache is not None else ExecutableCache(
            metrics=self.metrics)
        self._c_batches = self.metrics.counter("engine.batches_run")
        self._c_cns = self.metrics.counter("engine.cns_run")
        self._c_bytes = self.metrics.counter("engine.bytes_shipped")
        self._c_d2h = self.metrics.counter("engine.device_to_host_bytes")

    def _dispatch(self, sig: PlanSignature, group: Sequence[CNPlan],
                  mesh: VirtualMesh, reduce_cns: bool,
                  store: RelationStore):
        """Span/profiler shell around :meth:`_dispatch_group`: one
        ``engine.dispatch_group`` span per launch on the active trace, and a
        ``torch.profiler.record_function`` range so device profiles line
        host spans up with kernel activity."""
        family = "sum" if reduce_cns else "percn"
        with obs_span("engine.dispatch_group", n_cns=len(group), path="store",
                      family=family, n_devices=sig.n_devices):
            with torch.profiler.record_function(
                    f"fct.dispatch_group:store.{family}"):
                return self._dispatch_group(sig, group, mesh, reduce_cns,
                                            store)

    def _dispatch_group(self, sig: PlanSignature, group: Sequence[CNPlan],
                        mesh: VirtualMesh, reduce_cns: bool,
                        store: RelationStore):
        """Enqueue one group on the device; returns the LAZY result tensor
        (callers block via ``_collect``).

        The per-CN-output family rounds the CN axis up to a multiple of
        CN_BUCKET_MIN (zero-contribution null-plan padding), so batch
        compositions share programs; the summed family keeps exact N.
        """
        if store.mesh != mesh:
            raise ValueError("the store is bound to another mesh")
        n_stack = len(group)
        if not reduce_cns:
            n_stack = -(-n_stack // CN_BUCKET_MIN) * CN_BUCKET_MIN
        (fact, dims), shipped = store_group_args(store, group, sig, n_stack)
        kind = "fct_store" if reduce_cns else "fct_store_percn"
        key = (kind, sig, n_stack, mesh)
        fn = self.cache.get_or_build(
            key, lambda: _build_store_fn(sig, mesh, n_stack,
                                         reduce_cns=reduce_cns))
        self._c_bytes.inc(shipped)
        out = fn(fact, dims)
        self._c_batches.inc()
        self._c_cns.inc(len(group))
        return out

    def _collect(self, lazy: torch.Tensor) -> np.ndarray:
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
                       accum: Optional[AccumPolicy] = None):
        """Async half of a run: enqueue every signature group and return a
        pending handle ``[(plan_indices, lazy_result), ...]``; block with
        ``collect_total`` / ``collect_individual``.  ``individual=True``
        keeps the per-CN output axis so CNs of different queries can share
        a dispatch.  ``store`` (a RelationStore bound to this mesh) holds
        the relation columns; ``None`` uses a throwaway store.  ``accum``
        pins the AccumPolicy (default int32-checked)."""
        if not plans:
            raise ValueError("dispatch_plans needs at least one plan")
        if store is None:
            store = RelationStore(mesh, metrics=self.metrics)
        accum = accum if accum is not None else INT32_CHECKED
        return [(idxs, self._dispatch(sig, [plans[i] for i in idxs], mesh,
                                      reduce_cns=not individual,
                                      store=store))
                for sig, idxs in group_plan_indices(plans, accum)]

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

    def stats(self) -> dict:
        out = self.cache.stats()
        batches, cns, shipped, d2h = self.metrics.values(
            self._c_batches, self._c_cns, self._c_bytes, self._c_d2h)
        out.update(batches_run=batches, cns_run=cns, bytes_shipped=shipped,
                   device_to_host_bytes=d2h)
        return out


_DEFAULT_ENGINE: Optional[FCTEngine] = None


def default_engine() -> FCTEngine:
    """Process-wide engine (shared program cache)."""
    global _DEFAULT_ENGINE
    if _DEFAULT_ENGINE is None:
        _DEFAULT_ENGINE = FCTEngine(cache=default_cache())
    return _DEFAULT_ENGINE
