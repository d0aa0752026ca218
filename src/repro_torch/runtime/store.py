"""Device-resident relation store: tuple-set columns live on the device once.

The paper's MapReduce jobs re-ship every CN's tuple-set relations on every
query.  Here the big columns are uploaded ONCE per (session, tuple set) and
stay in device memory, and each plan's routing tables (send tables,
key-column indices) are uploaded once per plan and held by its routes
(:func:`store_group_args`): a memoized plan's later dispatches copy nothing
from the host.

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
``store_bytes`` (currently resident), ``store_evictions``, and
``store_chunk_assembles`` (entries built on the device from resident
per-chunk entries after an append, with no column traffic).

On CUDA, MR² reads a group's texts through a device table of their
addresses (``kernels/fct_count``'s routed kernel); :meth:`RelationStore.
text_pointers` makes one per group of text tensors at its first dispatch
and keeps it as long as those tensors live, so a warm dispatch finds it
and ships nothing.

Refs over relations with several append chunks (``RelationRef.chunk_parts``)
are stored per chunk: each part is an entry of its own, content-addressed
like any ref, and the full ref's entry is assembled from the parts on the
device (``_assemble``), bit-identical to a direct upload.  So an append
ships its new chunk, not the relation.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fct import _has_text
from repro_torch.core.plan import CNPlan, RelationRef, RelationRoute
from repro_torch.data.schema import PAD_ID
from repro_torch.kernels.fct_count.kernel import text_pointers
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.obs import default_registry
from repro_torch.obs import span as obs_span
from repro_torch.runtime.batch import PlanSignature, RelationSig, bucket_pow2
from repro_torch.runtime.cache import LruDict


class StoredColumns(NamedTuple):
    """One tuple-set relation's device-resident padded columns.  A relation
    that carries no text (width 0) stores none: its ``text`` is a
    ``[P, rows_pad, 0]`` tensor that holds no bytes."""

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
        # chunked (append-path) entries assembled on the DEVICE from
        # resident per-chunk columns: no host->device column traffic, so
        # they count here instead of store.uploads/upload_bytes
        self._c_assembles = self.metrics.counter("store.chunk_assembles")
        self._g_resident = self.metrics.gauge("store.resident_bytes")
        # bumped by clear(): an upload that started before an invalidation
        # must not re-insert pre-invalidation columns after it
        self.epoch = 0
        # one -1 on the device: null CN slots route nothing (null_send)
        self._minus_one = torch.full((), -1, dtype=torch.int32,
                                     device=mesh.device)
        # cap -> the null send table, one view each, so a padded group's
        # inputs are the same objects at every dispatch
        self._null_sends: Dict[int, torch.Tensor] = {}
        # ids of a group's texts -> (weak references to them, their
        # address table on the device, the entry's token): text_pointers
        self._pointers: Dict[tuple, tuple] = {}

    @property
    def chunk_assembles(self) -> int:
        return self._c_assembles.value

    @property
    def resident_bytes(self) -> int:
        return self._g_resident.value

    # -- lookup / upload -----------------------------------------------------

    def columns(self, ref: RelationRef, rows_pad: int,
                text_pad: int) -> StoredColumns:
        """The ref's device columns padded to (rows_pad, text_pad),
        uploading them on first use (or after eviction).

        Refs spanning several append chunks (``ref.chunk_parts()``) are
        assembled on the DEVICE from per-chunk entries instead of uploading
        the whole column set: each part goes through this same method (a
        part's uid equals the uid of a plain ref over the same rows, so
        pre-append and delta-dispatch uploads alias), then the combined
        entry concatenates the parts' rows and re-pads — bit-identical to
        what a direct upload of the full ref would have produced.  Only the
        parts missing from the store cost host->device traffic, which is
        how an append re-ships one chunk, not the relation.
        """
        key = (ref.uid, rows_pad, text_pad)
        with self._lock:
            cached = self._entries.hit(key)
            if cached is not None:
                self._c_hits.inc()
                return cached
            epoch = self.epoch
        parts = ref.chunk_parts()
        if parts is not None:
            with obs_span("store.chunk_assemble", parts=len(parts),
                          rows_pad=rows_pad, text_pad=text_pad):
                part_cols = [self.columns(p, bucket_pow2(p.shard_rows),
                                          text_pad) for p in parts]
                stored = self._assemble(parts, part_cols, rows_pad, text_pad)
        else:
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
            if parts is not None:
                self._c_assembles.inc()
            else:
                self._c_uploads.inc()
                self._c_upload_bytes.inc(stored.nbytes)
            if self.epoch != epoch:
                # a clear() (data invalidation) overtook this upload: the
                # columns may predate the mutation, and the row-index
                # fingerprint cannot tell — serve this dispatch, cache
                # nothing (the next reference re-reads the base arrays)
                return stored
            resident = self._g_resident.add(stored.nbytes)
            self._entries.put(key, stored)
            if self.max_bytes is not None:
                while resident > self.max_bytes and len(self._entries) > 1:
                    _, dropped = self._entries.popitem(last=False)
                    resident = self._g_resident.add(-dropped.nbytes)
                    self._c_evictions.inc()
            return stored

    @staticmethod
    def _assemble(parts: List[RelationRef], cols: List[StoredColumns],
                  rows_pad: int, text_pad: int) -> StoredColumns:
        """Combine per-chunk device columns into one padded entry.

        Each part entry holds its rows contiguously sharded: worker w's
        first ``ceil(n_part / P)`` slots are rows ``w*S .. (w+1)*S`` (flat
        row order preserved, pad at the flat tail), so slicing off the pad,
        flattening and concatenating the chunks recovers the combined row
        order; re-sharding at the COMBINED shard size ``ceil(n_total / P)``
        and re-padding each worker to ``rows_pad`` then reproduces EXACTLY
        the tensor a direct ``ref.store_columns`` upload builds — all on
        the device, no host columns and no wait on the device.
        """
        P = parts[0].n_devices
        texts, keys = [], []
        for p, c in zip(parts, cols):
            S, n = p.shard_rows, p.n_rows
            texts.append(c.text[:, :S].reshape(P * S, text_pad)[:n])
            k = c.keys[:, :S]
            keys.append(k.reshape((P * S,) + tuple(k.shape[2:]))[:n])
        n_total = sum(p.n_rows for p in parts)
        S_ref = -(-n_total // P)        # == the combined ref's shard_rows
        text = torch.full((P * rows_pad, text_pad), PAD_ID,
                          dtype=texts[0].dtype, device=texts[0].device)
        keyc = torch.zeros((P * rows_pad,) + tuple(keys[0].shape[1:]),
                           dtype=keys[0].dtype, device=keys[0].device)
        # flat row r of the combined ref lands in worker r // S_ref, slot
        # r % S_ref: each worker's block of S_ref rows starts at w*rows_pad
        flat_text = torch.cat(texts)
        flat_keys = torch.cat(keys)
        for w in range(P):
            lo, hi = w * S_ref, min((w + 1) * S_ref, n_total)
            if hi > lo:
                text[w * rows_pad:w * rows_pad + hi - lo] = flat_text[lo:hi]
                keyc[w * rows_pad:w * rows_pad + hi - lo] = flat_keys[lo:hi]
        text = text.view(P, rows_pad, text_pad)
        keyc = keyc.view((P, rows_pad) + tuple(keys[0].shape[1:]))
        return StoredColumns(
            text=text, keys=keyc,
            nbytes=text.numel() * text.element_size()
            + keyc.numel() * keyc.element_size())

    def null_send(self, cap: int) -> torch.Tensor:
        """An all ``-1`` ``[1, P, P, cap]`` send table on the device, for
        the null CN slots of a padded group: a view of one cached scalar, so
        it costs no memory and no copy, and the same view at every call."""
        table = self._null_sends.get(cap)
        if table is None:
            P = self.mesh.size
            table = self._null_sends.setdefault(
                cap, self._minus_one.expand(1, P, P, cap))
        return table

    def text_pointers(self, texts: Sequence[torch.Tensor]
                      ) -> Tuple[torch.Tensor, int]:
        """The ``[N]`` int64 device table of ``texts``' addresses that the
        routed MR² kernel reads, and the bytes this call shipped: uploaded
        the first time these very tensors come together, then found again
        (0 bytes), the same object each time.  The table is dropped when
        one of its texts dies, so a freed address that comes back with
        another tensor never matches."""
        ident = tuple(map(id, texts))

        def found() -> Optional[torch.Tensor]:      # under self._lock
            hit = self._pointers.get(ident)
            if hit is not None and all(r() is t
                                       for r, t in zip(hit[0], texts)):
                return hit[1]
            return None

        with self._lock:
            table = found()
        if table is not None:
            return table, 0
        table = text_pointers(texts, self.mesh.device)
        token = object()
        pointers = self._pointers

        def drop(_ref) -> None:
            entry = pointers.get(ident)
            if entry is not None and entry[2] is token:
                pointers.pop(ident, None)

        with self._lock:
            raced = found()              # a concurrent dispatch made one
            if raced is not None:
                return raced, 0
            self._pointers[ident] = (
                tuple(weakref.ref(t, drop) for t in texts), table, token)
        return table, table.numel() * table.element_size()

    # -- lifecycle / introspection ------------------------------------------

    def clear(self) -> int:
        """Drop every device buffer (data-mutation invalidation hook);
        returns the number of entries dropped."""
        with self._lock:
            dropped = len(self._entries)
            self._entries.clear()
            self._pointers.clear()
            self._g_resident.set(0)
            self.epoch += 1        # fence in-flight uploads (see columns())
            return dropped

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, int]:
        (uploads, hits, evictions, up_bytes, assembles,
         resident) = self.metrics.values(
            self._c_uploads, self._c_hits, self._c_evictions,
            self._c_upload_bytes, self._c_assembles, self._g_resident)
        with self._lock:
            return {"store_entries": len(self._entries),
                    "store_uploads": uploads,
                    "store_hits": hits,
                    "store_evictions": evictions,
                    "store_upload_bytes": up_bytes,
                    "store_chunk_assembles": assembles,
                    "store_bytes": resident}


# ---------------------------------------------------------------------------
# dispatch-time argument assembly (used by the engine)
# ---------------------------------------------------------------------------

def _pad_send(send: np.ndarray, cap: int) -> np.ndarray:
    if send.shape[-1] == cap:
        return send
    return np.pad(send, ((0, 0), (0, 0), (0, cap - send.shape[-1])),
                  constant_values=-1)


def _resident(route: RelationRoute, key: Tuple, host) -> Tuple[torch.Tensor,
                                                               int]:
    """``route.device_tables[key]`` (``key[0]`` is the device) and the
    bytes this call shipped: on the route's first use at ``key`` the host
    array ``host()`` is uploaded, with a leading CN axis of 1, and kept;
    later uses ship nothing."""
    table = route.device_tables.get(key)
    if table is not None:
        return table, 0
    table = torch.from_numpy(host()[None]).to(key[0])
    # a concurrent dispatch of the same plan may have stored one first
    return (route.device_tables.setdefault(key, table),
            table.numel() * table.element_size())


class GroupArgs(NamedTuple):
    """One signature group's store-path arguments and what building them
    shipped: ``shipped`` host->device bytes, ``send_uploads`` send tables
    uploaded, ``send_hits`` send tables found on the device.  ``inputs`` is
    every device tensor of the arguments, in a fixed order: a later group
    whose inputs are these very objects reads the same memory."""

    fact: Dict
    dims: List[Dict]
    shipped: int
    send_uploads: int
    send_hits: int
    inputs: Tuple[torch.Tensor, ...]


def store_group_args(store: RelationStore, plans: Sequence[CNPlan],
                     sig: PlanSignature, n_stack: int) -> GroupArgs:
    """Arguments for one stacked signature group on the store path.

    ``fact`` / each dim slot is ``{"text": [N device tensors], "keys": [N
    device tensors], "send": [N device [1, P, P, C] int32]}``, on CUDA
    with ``"ptrs"``, the texts' address table (:meth:`RelationStore.
    text_pointers`; none for a relation of width 0, which MR² does not
    read), and the fact adds ``"cols"``, N device ``[1, m]``
    int32 key-column indices.  Every tensor is resident: columns and
    address tables in the store, each route's send table (padded to the
    signature's ``cap``) and key-column indices on the route itself,
    uploaded at its first store-path dispatch.  The program joins
    the tables along the CN axis on the device as the first step of routing
    (``core/fct.py::_cn_joined``), so the lookups here copy nothing, and a
    plan dispatched again ships 0 bytes (``shipped`` counts the first
    uses).  Slots past ``len(plans)`` are null plans: they alias the first
    plan's store-resident columns and key columns and route nothing
    (:meth:`RelationStore.null_send`), contributing exactly zero to every
    histogram.
    """
    pad = n_stack - len(plans)
    dev = store.mesh.device
    shipped = uploads = 0

    def one_relation(routes: List[RelationRoute], rsig: RelationSig) -> Dict:
        nonlocal shipped, uploads
        cols = [store.columns(r.ref, rsig.rows, rsig.text_len)
                for r in routes]
        sends = []
        for r in routes:
            table, nbytes = _resident(r, (dev, rsig.cap),
                                      lambda r=r: _pad_send(r.send, rsig.cap))
            sends.append(table)
            shipped += nbytes
            uploads += int(nbytes > 0)
        if pad:
            cols.extend([cols[0]] * pad)
            sends.extend([store.null_send(rsig.cap)] * pad)
        rel = {"text": [c.text for c in cols],
               "keys": [c.keys for c in cols], "send": sends}
        if dev.type == "cuda" and _has_text(rel):
            # what the routed MR² kernel reads
            rel["ptrs"], nbytes = store.text_pointers(rel["text"])
            shipped += nbytes
        return rel

    fact = one_relation([p.fact for p in plans], sig.fact)
    key_cols = []
    for p in plans:
        table, nbytes = _resident(
            p.fact, (dev, "key_cols"),
            lambda p=p: np.asarray(p.fact.key_cols, np.int32))
        key_cols.append(table)
        shipped += nbytes
    fact["cols"] = key_cols + [key_cols[0]] * pad
    dims = [one_relation([p.dims[p.included[j]] for p in plans], rsig)
            for j, rsig in enumerate(sig.dims)]
    n_tables = len(plans) * (1 + len(sig.dims))
    inputs = tuple(t for rel in (fact, *dims)
                   for part in ("text", "keys", "send", "cols")
                   for t in rel.get(part, ()))
    inputs += tuple(rel["ptrs"] for rel in (fact, *dims) if "ptrs" in rel)
    return GroupArgs(fact, dims, shipped, uploads, n_tables - uploads,
                     inputs)
