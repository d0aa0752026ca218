"""Host-side FCT planner: query -> CNs -> shares -> static routing plan.

This is the paper's "master node" work: ``getPartition()`` (Algorithm 2), the
allocation table of §4.2, and the §4.3.3 task pruning — all computed once per
query on the host as dense index tables.  Devices execute the plan with
static shapes only (gather -> all_to_all -> compute); they never hash keys or
make routing decisions.

A ``CNPlan`` is a lightweight *descriptor*: per relation it holds a
:class:`RelationRef` — the identity of the tuple-set columns (row indices
into the base relation plus a content fingerprint, the key of the
device-resident :class:`repro_torch.runtime.store.RelationStore`) — and the per-CN
``send`` routing table.  The big ``text``/``keys`` columns are NOT copied
into the plan; the per-CN baseline (``core.fct.run_cn_plan``) materializes
them on demand through the
``RelationRoute.text`` / ``.keys`` properties, while the engine's store path
uploads each tuple-set relation to the device mesh once per session.  The
``send`` tables are no small payload (at P 1 a fact table holds one slot per
routed tuple, millions at SF1), so the store path uploads each once too, at
the plan's first dispatch, and keeps the device copy on the route
(``RelationRoute.device_tables``): a memoized plan's later dispatches ship
nothing.

Replication accounting: a dimension row needed by several tasks on the SAME
device is sent once (paper Corollary 2, "data filtering"), so the measured
shuffle bytes equal  Σ_i |D_i| · (unique destination devices per row)  which
the shares optimizer minimizes with its  Σ_i d_i·k/a_i  model.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.candidate_network import StarCN, TupleSets
from repro_torch.core.hypercube import TaskGrid, over_decompose
from repro_torch.core.shares import optimize_shares
from repro_torch.core.skew import (Schedule, choose_rho, estimate_task_costs,
                             lpt_schedule, round_robin_schedule,
                             row_imbalance)
from repro_torch.core.star import cn_volume_mass
from repro_torch.data.schema import PAD_ID, StarSchema
from repro_torch.obs import span as obs_span


def _shard_rows(arr: np.ndarray, P: int, pad_value: int) -> np.ndarray:
    rows = arr.shape[0]
    S = max(1, math.ceil(rows / P))
    pad = P * S - rows
    if pad:
        pad_block = np.full((pad,) + arr.shape[1:], pad_value, arr.dtype)
        arr = np.concatenate([arr, pad_block], axis=0)
    return arr.reshape((P, S) + arr.shape[1:])


@dataclasses.dataclass
class RelationRef:
    """Identity + lazy materialization of one tuple-set relation's columns.

    Owns no column copies: ``rows`` indexes into the base relation's arrays
    (shared references).  ``uid`` is a content fingerprint over the row
    indices — stable across replanning of the same tuple set, so it keys
    the session's device-resident RelationStore.  The base arrays are
    assumed immutable for the life of the owning session; data mutations
    must go through the serving layer's ``invalidate`` hooks.
    """

    role: str                            # "fact" | "dim"
    name: str                            # base relation name
    rows: np.ndarray                     # tuple-set row indices into the base
    base_text: np.ndarray                # [R, L] shared reference, not a copy
    base_keys: Tuple[np.ndarray, ...]    # key columns, shared references
    n_devices: int
    uid: Tuple = None
    #: the base relation's append-chunk row counts (``Relation.chunks``),
    #: None for single-chunk relations.  Layout-neutral metadata: the device
    #: layout (and hence ``uid``) is the same contiguous row sharding either
    #: way — chunking only lets the RelationStore split an upload into
    #: per-chunk content-addressed pieces (:meth:`chunk_parts`), so an
    #: append re-ships the new chunk, not the whole column set.
    base_chunks: Optional[Tuple[int, ...]] = None

    def __post_init__(self) -> None:
        if self.uid is None:
            digest = hashlib.blake2b(np.ascontiguousarray(self.rows).tobytes(),
                                     digest_size=8).hexdigest()
            self.uid = (self.role, self.name, len(self.rows), digest,
                        self.n_devices)

    # -- static shape metadata (no materialization) -------------------------

    @property
    def n_rows(self) -> int:
        return int(len(self.rows))

    @property
    def shard_rows(self) -> int:
        """Per-device rows S after row-sharding over the mesh."""
        return max(1, math.ceil(self.n_rows / self.n_devices))

    @property
    def text_len(self) -> int:
        return int(self.base_text.shape[1])

    @property
    def key_width(self) -> int:
        return len(self.base_keys)

    def chunk_parts(self) -> Optional[List["RelationRef"]]:
        """Per-base-chunk sub-refs when ``rows`` spans more than one chunk.

        Returns None when the relation has a single chunk or every row falls
        in one chunk (the legacy single-upload path covers those exactly —
        including delta refs over a freshly appended chunk).  Each sub-ref
        carries the rows of one populated chunk, so its ``uid`` equals the
        uid a pre-append (or delta-dispatch) ref over those same rows
        computed — that aliasing is what lets the store reuse the old
        chunks' device columns after an append.  Requires ``rows`` sorted
        ascending (tuple-set rows come from ``np.nonzero`` and are).
        """
        if self.base_chunks is None or len(self.base_chunks) < 2:
            return None
        bounds = np.cumsum(np.asarray(self.base_chunks, np.int64))[:-1]
        cuts = [0, *np.searchsorted(self.rows, bounds).tolist(),
                len(self.rows)]
        spans = [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]
        if len(spans) < 2:
            return None
        return [RelationRef(role=self.role, name=self.name,
                            rows=self.rows[a:b], base_text=self.base_text,
                            base_keys=self.base_keys,
                            n_devices=self.n_devices)
                for a, b in spans]

    # -- on-demand host materialization -------------------------------------

    def text_shards(self) -> np.ndarray:
        """[P, S, L] int32 tuple-set text, row-sharded and PAD padded."""
        return _shard_rows(self.base_text[self.rows], self.n_devices,
                           PAD_ID).astype(np.int32, copy=False)

    def dim_key_shards(self) -> np.ndarray:
        """[P, S] int32 join-key column (dim relations)."""
        (col,) = self.base_keys
        return _shard_rows(col[self.rows].astype(np.int32, copy=False),
                           self.n_devices, 0)

    def fact_key_shards(self, cols: Sequence[int]) -> np.ndarray:
        """[P, S, len(cols)] int32 selected fact key columns."""
        stacked = np.stack([self.base_keys[i][self.rows] for i in cols],
                           axis=1).astype(np.int32, copy=False)
        return _shard_rows(stacked, self.n_devices, 0)

    def store_columns(self, rows_pad: int,
                      text_pad: int) -> Tuple[np.ndarray, np.ndarray]:
        """(text, keys) host arrays padded for a RelationStore upload.

        Text is padded to ``[P, rows_pad, text_pad]`` with PAD_ID; keys are
        FULL-width for the fact (``[P, rows_pad, m_all]`` — the engine's
        device program selects each CN's columns with a small gathered
        index, so one upload serves every CN over this tuple set) and
        ``[P, rows_pad]`` for a dim.  Padded rows are never named by any
        send table, so the fill values are semantics-free.
        """
        text = self.text_shards()
        P, S, L = text.shape
        text = np.pad(text, ((0, 0), (0, rows_pad - S), (0, text_pad - L)),
                      constant_values=PAD_ID)
        if self.role == "fact":
            keys = self.fact_key_shards(range(self.key_width))
            keys = np.pad(keys, ((0, 0), (0, rows_pad - S), (0, 0)),
                          constant_values=0)
        else:
            keys = np.pad(self.dim_key_shards(),
                          ((0, 0), (0, rows_pad - S)), constant_values=0)
        return text, keys


@dataclasses.dataclass
class RelationRoute:
    """Routing descriptor for one relation of one CN: a store handle
    (:class:`RelationRef`) plus the static per-CN send table.
    ``text``/``keys`` materialize the sharded host arrays on demand (the
    per-CN baseline path).

    ``device_tables`` holds the store path's device copies of ``send``
    (padded to a signature's ``cap``) and of ``key_cols``, filled at the
    route's first store-path dispatch (``runtime/store.py``).  They live as
    long as the route, so as long as the plan that holds it: a plan the
    session drops takes its tables with it."""

    ref: RelationRef
    send: np.ndarray     # int32 [P, P, C]   local row idx to send, -1 pad
    sent_rows: int       # total routed rows (shuffle volume, rows)
    key_cols: Optional[Tuple[int, ...]] = None  # fact: included dim ids
    #: (device, cap) -> send padded to cap, [1, P, P, cap];
    #: (device, "key_cols") -> key_cols, [1, m]
    device_tables: Dict = dataclasses.field(default_factory=dict,
                                            repr=False, compare=False)

    @property
    def text(self) -> np.ndarray:
        """int32 [P, S, L] row-sharded tuple-set text (materialized)."""
        return self.ref.text_shards()

    @property
    def keys(self) -> np.ndarray:
        """int32 [P, S] (dim) or [P, S, m_inc] (fact) keys (materialized)."""
        if self.key_cols is None:
            return self.ref.dim_key_shards()
        return self.ref.fact_key_shards(self.key_cols)

    @property
    def capacity(self) -> int:
        return int(self.send.shape[-1])


@dataclasses.dataclass
class CNPlan:
    cn: StarCN
    included: Tuple[int, ...]
    shares: Tuple[int, ...]
    schedule: Schedule
    fact: RelationRoute
    dims: Dict[int, RelationRoute]
    key_domains: Dict[int, int]
    vocab_size: int
    shuffle_rows: int           # fact + replicated dim rows actually sent
    shuffle_bytes: int          # int32 payload bytes (keys + text)
    rho: int = 1                # effective over-decomposition factor used
    device_rows: Optional[np.ndarray] = None  # int64 [P] routed fact rows
    #: upper bound on max_w freq_CN(w): the CN's total volume-weighted token
    #: mass (``core.star.cn_volume_mass``).  inf = unknown (never pruned);
    #: 0.0 = provably contributes nothing, safe to skip bit-exactly.
    contrib_bound: float = float("inf")

    @property
    def n_devices(self) -> int:
        return int(self.fact.ref.n_devices)

    @property
    def row_imbalance(self) -> float:
        """ACHIEVED per-device fact-row imbalance (max/mean; 1.0 = perfect).

        This is the balance the devices actually see, as opposed to
        ``schedule.imbalance`` which is over LPT's *estimated* task costs."""
        if self.device_rows is None:
            return 1.0
        return row_imbalance(self.device_rows)


def _send_table(pairs_src: np.ndarray, pairs_dst: np.ndarray,
                pairs_local: np.ndarray, P: int) -> Tuple[np.ndarray, int]:
    """Build [P, P, C] send table from (src, dst, local_idx) triples."""
    counts = np.zeros((P, P), np.int64)
    np.add.at(counts, (pairs_src, pairs_dst), 1)
    C = max(1, int(counts.max()))
    table = np.full((P, P, C), -1, np.int32)
    order = np.lexsort((pairs_local, pairs_dst, pairs_src))
    s, d, loc = pairs_src[order], pairs_dst[order], pairs_local[order]
    # position within each (src, dst) group
    group = s.astype(np.int64) * P + d
    start = np.searchsorted(group, group, side="left")
    pos = np.arange(len(group)) - start
    table[s, d, pos] = loc
    return table, int(len(pairs_src))


def build_cn_plan(schema: StarSchema, ts: TupleSets, cn: StarCN,
                  n_devices: int, mode: str = "uniform", rho: int = 4,
                  sample_frac: float = 1.0, salt: int = 0,
                  shares: Optional[Tuple[int, ...]] = None) -> Optional[CNPlan]:
    """Routing plan for a joined star CN.  Returns None for 1-relation CNs.

    ``mode="adaptive"`` is the balance pass: instead of the caller's fixed
    ``rho``, the over-decomposition factor is chosen per CN from the
    OBSERVED tuple-set sizes (:func:`repro_torch.core.skew.choose_rho`) and the
    shares are re-optimized for the full ``rho * P`` task grid — so the
    dominant CN's rows are split across devices at a granularity the data
    itself justifies, and tiny CNs skip over-decomposition (and its extra
    dimension replication) entirely.  Tasks are then LPT-scheduled as in
    ``"skew"`` mode.
    """
    P = n_devices
    fact_idx, dim_idx = ts.cn_rows(cn)
    if fact_idx is None or len(dim_idx) == 0:
        return None
    inc = tuple(sorted(dim_idx))
    m = len(inc)

    # --- shares (§4.1): optimizer over the CN's tuple-set sizes ---
    rho_eff = 1 if mode == "uniform" else rho
    sizes = [max(1, len(dim_idx[i])) for i in inc]
    if mode == "adaptive":
        rho_eff = choose_rho(len(fact_idx), P)
        if shares is None:
            # re-optimize shares for the FULL task grid (T = rho * P) rather
            # than over-decomposing a P-share solution: the divisor lattice
            # of T is richer, so the grid tracks the size ratios closer
            grid_shares = optimize_shares(sizes, P * rho_eff,
                                          fact_size=len(fact_idx)).shares
        else:
            grid_shares = over_decompose(shares, rho_eff)
    else:
        if shares is None:
            shares = optimize_shares(sizes, P, fact_size=len(fact_idx)).shares
        grid_shares = shares if mode == "uniform" else over_decompose(shares,
                                                                      rho)
    grid = TaskGrid(grid_shares)
    T = grid.n_tasks

    # --- per-row task/bucket assignment (host 'getPartition()') ---
    fact_key_cols = [schema.fact_keys(i)[fact_idx] for i in inc]
    fact_tasks = grid.fact_tasks(fact_key_cols, salt)
    dim_buckets = {i: grid.dim_buckets(p, schema.dim_keys(i)[dim_idx[i]], salt)
                   for p, i in enumerate(inc)}

    # --- schedule tasks onto devices (§4.2-4.3) ---
    empty = np.bincount(fact_tasks, minlength=T) == 0
    if mode == "uniform":
        assert T == P, (T, P, "uniform mode requires shares product == P")
        schedule = Schedule(task_to_device=np.arange(T, dtype=np.int32),
                            device_cost=np.bincount(fact_tasks, minlength=T)
                            .astype(np.float64),
                            task_cost=np.bincount(fact_tasks, minlength=T)
                            .astype(np.float64))
    else:
        # the cost estimate and the packing, timed on the active trace
        with obs_span("plan.schedule", mode=mode, tasks=T, devices=P):
            probes = []
            for p, i in enumerate(inc):
                keys = schema.dim_keys(i)[dim_idx[i]]
                num = np.bincount(keys, minlength=schema.key_domain(i))
                probes.append(num[fact_key_cols[p]].astype(np.float64))
            cost = estimate_task_costs(grid, fact_tasks, probes,
                                       [dim_buckets[i] for i in inc],
                                       sample_frac=sample_frac, seed=salt)
            if mode in ("skew", "adaptive"):
                schedule = lpt_schedule(cost, P, prune_empty=empty)
            elif mode == "round_robin":
                schedule = round_robin_schedule(cost, P)
            else:
                raise ValueError(mode)

    t2d = schedule.task_to_device

    # --- fact routing: each row to exactly one device ---
    fact_dst = t2d[fact_tasks]
    keep = fact_dst >= 0
    fact_ref = RelationRef(role="fact", name=schema.fact.name, rows=fact_idx,
                           base_text=schema.fact.text,
                           base_keys=tuple(schema.fact_keys(i)
                                           for i in range(schema.m)),
                           n_devices=P, base_chunks=schema.fact.chunks)
    S_f = fact_ref.shard_rows
    rows = np.arange(len(fact_idx))
    src = (rows // S_f).astype(np.int32)
    local = (rows % S_f).astype(np.int32)
    table, sent_f = _send_table(src[keep], fact_dst[keep].astype(np.int32),
                                local[keep], P)
    fact_route = RelationRoute(ref=fact_ref, send=table, sent_rows=sent_f,
                               key_cols=inc)

    # --- dim routing: each row to every device owning a matching task ---
    dims: Dict[int, RelationRoute] = {}
    shuffle_rows = sent_f
    shuffle_bytes = sent_f * 4 * (fact_ref.text_len + m)
    for p, i in enumerate(inc):
        rows_i = dim_idx[i]
        dim_ref = RelationRef(role="dim", name=schema.dims[i].name,
                              rows=rows_i, base_text=schema.dims[i].text,
                              base_keys=(schema.dim_keys(i),), n_devices=P,
                              base_chunks=schema.dims[i].chunks)
        S_d = dim_ref.shard_rows
        r = np.arange(len(rows_i))
        src_d = (r // S_d).astype(np.int32)
        local_d = (r % S_d).astype(np.int32)
        # owners per bucket (Cor. 2: dedup per device) via one group-by over
        # (bucket coord, device) pairs instead of a python loop over buckets
        coord_p = grid.axis_coords(p)
        live = t2d >= 0
        owner_pairs = np.unique(coord_p[live].astype(np.int64) * P + t2d[live])
        owner_bucket = owner_pairs // P
        owner_dev = (owner_pairs % P).astype(np.int32)
        n_owners = np.bincount(owner_bucket, minlength=grid.shares[p])
        owner_start = np.cumsum(n_owners) - n_owners
        # expand rows x owners-of-their-bucket with repeat/cumsum arithmetic
        per_row = n_owners[dim_buckets[i]]
        n_pairs = int(per_row.sum())
        if n_pairs:
            pair_src = np.repeat(src_d, per_row)
            pair_loc = np.repeat(local_d, per_row)
            row_start = np.cumsum(per_row) - per_row
            within = np.arange(n_pairs) - np.repeat(row_start, per_row)
            pair_dst = owner_dev[
                np.repeat(owner_start[dim_buckets[i]], per_row) + within]
            table_d, sent_d = _send_table(pair_src, pair_dst, pair_loc, P)
        else:
            table_d, sent_d = np.full((P, P, 1), -1, np.int32), 0
        dims[i] = RelationRoute(ref=dim_ref, send=table_d, sent_rows=sent_d)
        shuffle_rows += sent_d
        shuffle_bytes += sent_d * 4 * (dim_ref.text_len + 1)

    device_rows = np.bincount(fact_dst[keep], minlength=P).astype(np.int64)
    return CNPlan(cn=cn, included=inc, shares=grid_shares, schedule=schedule,
                  fact=fact_route, dims=dims,
                  key_domains={i: schema.key_domain(i) for i in inc},
                  vocab_size=schema.vocab_size,
                  shuffle_rows=shuffle_rows, shuffle_bytes=shuffle_bytes,
                  rho=rho_eff, device_rows=device_rows,
                  contrib_bound=cn_volume_mass(schema, ts, cn))
