"""Device-resident relation store: tuple-set columns live on the device once.

The paper's MapReduce jobs re-ship every CN's tuple-set relations on every
query.  Here only the small routing metadata (send tables, key-column
indices) is shipped per dispatch; the big columns are uploaded ONCE per
(session, tuple set) and stay in device memory.

``RelationStore`` maps a :class:`repro_torch.core.plan.RelationRef`'s content
fingerprint to device tensors laid out ``[P, rows_pad, ...]`` (the virtual
mesh's worker axis first), padded to the engine's pow-2 bucket dims so one
upload serves every program built for that signature.  Fact keys are stored
FULL width (all ``m`` columns); the device program selects each CN's columns
with a gathered index, so CNs with different dimension subsets reuse one
upload.  Entries are LRU with an optional byte budget (``max_bytes``);
eviction just drops the device buffer — a later dispatch re-uploads from the
descriptor (a counted miss).  ``clear()`` bumps an epoch that fences uploads
in flight.

Counters follow the runtime convention: ``store_uploads`` / ``store_hits``
(reuse), ``store_upload_bytes`` (cumulative host→device column traffic),
``store_bytes`` (currently resident), ``store_evictions``.

Refs over relations with several append chunks (``RelationRef.chunk_parts``)
belong to incremental ingest, which is not ported: the store raises on them.
"""
from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.plan import CNPlan, RelationRef
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.obs import default_registry
from repro_torch.obs import span as obs_span
from repro_torch.runtime.batch import PlanSignature, RelationSig
from repro_torch.runtime.cache import LruDict


class StoredColumns(NamedTuple):
    """One tuple-set relation's device-resident padded columns."""

    text: torch.Tensor   # [P, rows_pad, text_pad] int32
    keys: torch.Tensor   # [P, rows_pad(, m_all)] int32
    nbytes: int


class RelationStore:
    """Content-addressed LRU of device-resident tuple-set columns.

    One store serves one (schema, mesh) pair — the session owns it.  Keys
    combine the RelationRef fingerprint and the padded dims (so exact-shape
    and bucketed engines coexist).
    """

    def __init__(self, mesh: VirtualMesh, max_bytes: Optional[int] = None,
                 metrics=None) -> None:
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.mesh = mesh
        self.max_bytes = max_bytes
        self._entries: LruDict = LruDict()   # key -> StoredColumns
        self._lock = threading.Lock()
        self.metrics = metrics if metrics is not None else default_registry()
        self._c_uploads = self.metrics.counter("store.uploads")
        self._c_hits = self.metrics.counter("store.hits")
        self._c_evictions = self.metrics.counter("store.evictions")
        self._c_upload_bytes = self.metrics.counter("store.upload_bytes")
        self._g_resident = self.metrics.gauge("store.resident_bytes")
        # bumped by clear(): an upload that started before an invalidation
        # must not re-insert pre-invalidation columns after it
        self.epoch = 0

    @property
    def resident_bytes(self) -> int:
        return self._g_resident.value

    # -- lookup / upload -----------------------------------------------------

    def columns(self, ref: RelationRef, rows_pad: int,
                text_pad: int) -> StoredColumns:
        """The ref's device columns padded to (rows_pad, text_pad),
        uploading them on first use (or after eviction)."""
        key = (ref.uid, rows_pad, text_pad)
        with self._lock:
            cached = self._entries.hit(key)
            if cached is not None:
                self._c_hits.inc()
                return cached
            epoch = self.epoch
        if ref.chunk_parts() is not None:
            raise NotImplementedError(
                f"relation {ref.name!r} spans several append chunks; "
                "chunked (incremental-ingest) store entries are not ported")
        dev = self.mesh.device
        with obs_span("store.upload", rows_pad=rows_pad,
                      text_pad=text_pad) as sp:     # outside the lock
            text, keys = ref.store_columns(rows_pad, text_pad)
            nbytes = text.nbytes + keys.nbytes
            sp.args["bytes"] = nbytes
            stored = StoredColumns(text=torch.from_numpy(text).to(dev),
                                   keys=torch.from_numpy(keys).to(dev),
                                   nbytes=nbytes)
        with self._lock:
            raced = self._entries.hit(key)
            if raced is not None:      # concurrent uploader won
                self._c_hits.inc()
                return raced
            self._c_uploads.inc()
            self._c_upload_bytes.inc(stored.nbytes)
            if self.epoch != epoch:
                # a clear() (data invalidation) overtook this upload: serve
                # this dispatch, cache nothing
                return stored
            resident = self._g_resident.add(stored.nbytes)
            self._entries.put(key, stored)
            if self.max_bytes is not None:
                while resident > self.max_bytes and len(self._entries) > 1:
                    _, dropped = self._entries.popitem(last=False)
                    resident = self._g_resident.add(-dropped.nbytes)
                    self._c_evictions.inc()
            return stored

    # -- lifecycle / introspection ------------------------------------------

    def clear(self) -> int:
        """Drop every device buffer (data-mutation invalidation hook);
        returns the number of entries dropped."""
        with self._lock:
            dropped = len(self._entries)
            self._entries.clear()
            self._g_resident.set(0)
            self.epoch += 1        # fence in-flight uploads (see columns())
            return dropped

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, int]:
        uploads, hits, evictions, up_bytes, resident = self.metrics.values(
            self._c_uploads, self._c_hits, self._c_evictions,
            self._c_upload_bytes, self._g_resident)
        with self._lock:
            return {"store_entries": len(self._entries),
                    "store_uploads": uploads,
                    "store_hits": hits,
                    "store_evictions": evictions,
                    "store_upload_bytes": up_bytes,
                    "store_bytes": resident}


# ---------------------------------------------------------------------------
# dispatch-time argument assembly (used by the engine)
# ---------------------------------------------------------------------------

def _pad_send(send: np.ndarray, cap: int) -> np.ndarray:
    if send.shape[-1] == cap:
        return send
    return np.pad(send, ((0, 0), (0, 0), (0, cap - send.shape[-1])),
                  constant_values=-1)


def _null_send(n_devices: int, cap: int) -> np.ndarray:
    return np.full((n_devices, n_devices, cap), -1, np.int32)


def store_group_args(store: RelationStore, plans: Sequence[CNPlan],
                     sig: PlanSignature, n_stack: int):
    """Arguments for one stacked signature group on the store path.

    Returns ``((fact, dims), shipped_bytes)`` where ``fact`` / each dim slot
    is ``{"text": [N device tensors], "keys": [N device tensors],
    "send": [N, P, P, C] host int32, ...}`` — the only HOST payload is the
    stacked send tables plus the fact's key-column indices
    (``shipped_bytes`` counts exactly that; the program uploads them).
    Slots past ``len(plans)`` are null plans: they alias the first plan's
    store-resident columns and route nothing (all ``-1`` send), contributing
    exactly zero to every histogram.
    """
    pad = n_stack - len(plans)

    def one_relation(refs_sends: List[Tuple[RelationRef, np.ndarray]],
                     rsig: RelationSig) -> Dict:
        cols = [store.columns(ref, rsig.rows, rsig.text_len)
                for ref, _ in refs_sends]
        sends = [_pad_send(send, rsig.cap) for _, send in refs_sends]
        if pad:
            cols.extend([cols[0]] * pad)
            P_dev = sends[0].shape[0]
            sends.extend([_null_send(P_dev, rsig.cap)] * pad)
        return {"text": [c.text for c in cols],
                "keys": [c.keys for c in cols],
                "send": np.stack(sends)}

    fact = one_relation([(p.fact.ref, p.fact.send) for p in plans], sig.fact)
    key_cols = [np.asarray(p.fact.key_cols, np.int32) for p in plans]
    if pad:
        key_cols.extend([key_cols[0]] * pad)
    fact["cols"] = np.stack(key_cols)
    dims = [one_relation([(p.dims[p.included[j]].ref,
                           p.dims[p.included[j]].send) for p in plans], rsig)
            for j, rsig in enumerate(sig.dims)]
    shipped = fact["send"].nbytes + fact["cols"].nbytes + sum(
        d["send"].nbytes for d in dims)
    return (fact, dims), shipped
