"""Request/response objects of the FCT service API.

An :class:`FCTRequest` is everything a caller may vary per query; everything
tied to the *dataset* (schema, tokenizer, mesh, engine, stop list) lives on
the :class:`repro_torch.api.session.FCTSession`.  Requests are frozen and
hashable so they can sit in pipeline queues and serve as memo keys.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

Keyword = Union[str, int]

_MODES = ("uniform", "skew", "round_robin", "adaptive")


@dataclasses.dataclass(frozen=True)
class FCTRequest:
    """One FCT query (paper Def. 6): keywords + top-k + planning knobs.

    ``keywords`` accepts term ids (ints) or raw strings (resolved through the
    session's tokenizer); a mix is allowed.  ``mode``/``rho``/``sample_frac``/
    ``salt`` are the skew-scheduler knobs forwarded to ``build_cn_plan``.
    ``mode="adaptive"`` ignores the fixed ``rho`` and lets the balance pass
    pick the over-decomposition per CN from the observed tuple-set sizes
    (sessions with ``SessionConfig(adaptive_rho=True)`` plan default
    ``"uniform"`` requests this way automatically).
    """

    keywords: Tuple[Keyword, ...]
    top_k: int = 10
    r_max: int = 4
    mode: str = "uniform"
    rho: int = 4
    sample_frac: float = 1.0
    salt: int = 0
    #: force the full-histogram path even on sessions with
    #: ``SessionConfig.device_topk``: the caller needs ``all_freqs`` (the
    #: gateway sets this on result-cache fills, which memoize the histogram
    #: so later hits can re-slice any k from it)
    need_histogram: bool = False

    def __post_init__(self) -> None:
        object.__setattr__(self, "keywords", tuple(self.keywords))
        if not self.keywords:
            raise ValueError("FCTRequest needs at least one keyword")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        if self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.r_max < 1:
            raise ValueError(f"r_max must be >= 1, got {self.r_max}")


@dataclasses.dataclass
class FCTResponse:
    """Answer to one :class:`FCTRequest`.

    ``terms`` are the decoded top-k strings (``"<id>"`` placeholders when the
    session has no tokenizer); ``term_ids``/``freqs`` are the raw Def. 6
    result and ``all_freqs`` the full frequency vector the top-k was drawn
    from.  ``timings`` reports every serving phase separately — ``plan_ms``
    (host-side: tuple sets, CN enumeration, routing plans), ``dispatch_ms``
    (device enqueue incl. store uploads), ``collect_ms`` (waiting for the
    device + histogram transfer), ``finalize_ms`` (top-k slice + term
    decode) — plus ``execute_ms`` (= dispatch + collect + finalize) and
    ``total_ms`` (= plan + execute).  The same keys appear on the sync,
    batched, pipelined and gateway cache-hit paths (a hit reports zero
    plan/dispatch/collect).  On CUDA, a response that dispatched device
    work also carries ``device_route_ms``, ``device_mr1_ms`` and
    ``device_mr2_ms``: the device time of routing, MR¹ and MR², between
    CUDA events the engine records on the stream after the uploads and
    after each stage, summed over the query's groups (a batch's shared
    groups count on its first response only).  Such an interval holds the
    stage's kernels and any idle the host leaves between them while it
    still enqueues the stage.  They are absent on the CPU
    and on cache hits.  ``engine_stats`` is the *delta* of the engine
    counters attributable to this query (for ``query_batch``, to the whole
    batch — the dispatch is shared); ``cold`` is True iff that delta
    includes at least one program build.  ``cache_hit`` marks responses the
    serving gateway's :class:`repro_torch.serve.ResultCache` answered
    without touching the engine (top-k re-sliced from the memoized full
    histogram); ``coalesced`` marks responses that attached to an identical
    in-flight query instead of dispatching their own (same zero-engine-cost
    re-slice, but the histogram came from the leader request, not the
    cache).

    ``trace`` is the request's :class:`repro_torch.obs.Trace` — the recorded
    span tree: ``plan`` (with ``plan.tuple_sets``, ``plan.cns``,
    ``plan.cn_plan`` and ``plan.map_only`` beneath it when the plan was not
    cached), ``dispatch``, the engine's ``engine.dispatch_group`` spans
    (``store.group_args`` with ``store.upload`` / ``store.chunk_assemble``,
    or ``engine.host_stack``; ``engine.upload``; ``fct.route``, ``fct.mr1``,
    ``fct.mr2``), ``collect``, ``finalize``, plus cache-lookup / batcher
    spans where they apply.  Every span is host time; the device-stage
    times above are kept out of it.  ``trace.records()`` gives structured
    dicts, ``repro_torch.obs.chrome_trace([...])`` a Chrome trace_event
    document.

    ``accum_policy`` names the device-accumulation precision the histogram
    carries: ``"int32-checked"`` — exact below 2^31, wrap-around raises
    instead of answering — or ``"int64-exact"``.  The serving gateway
    advertises it per tenant; cached and coalesced responses inherit the
    master response's policy.
    """

    terms: List[str]
    term_ids: np.ndarray
    freqs: np.ndarray
    #: full frequency vector the top-k was drawn from — ``None`` on the
    #: device-side top-k path (``finalize == "device_topk"``), whose whole
    #: point is that the histogram never reaches the host
    all_freqs: Optional[np.ndarray]
    n_cns: int
    n_joined_cns: int
    shuffle_rows: int
    shuffle_bytes: int
    imbalance: float
    timings: Dict[str, float]
    engine_stats: Dict[str, int]
    cold: bool
    request: Optional[FCTRequest] = None
    trace: Optional[object] = None       # repro_torch.obs.Trace (span tree)
    cache_hit: bool = False
    coalesced: bool = False
    accum_policy: str = "int32-checked"
    row_imbalance: float = 1.0   # dominant CN's ACHIEVED per-worker fact-row
    #                              imbalance (max/mean; ``imbalance`` above
    #                              is over LPT's estimated task costs)
    #: which finalize ran: ``"host"`` (full histogram transferred, top-k
    #: sliced in numpy) or ``"device_topk"`` (the fct_topk program returned
    #: O(k) candidates; ``all_freqs`` is None)
    finalize: str = "host"
    #: the session data epoch this response's histogram reflects: bumped by
    #: every ``FCTSession.append`` (and ``invalidate``).  A response is
    #: computed against ONE epoch's snapshot end to end — a query racing an
    #: append reports either the pre- or post-append epoch, never a mix
    data_epoch: int = 0

    def topk(self) -> List[Tuple[str, int]]:
        """(term, freq) pairs with zero-frequency tail dropped."""
        return [(t, int(f)) for t, f in zip(self.terms, self.freqs) if f > 0]


@dataclasses.dataclass(frozen=True)
class AppendResult:
    """Outcome of one :meth:`repro_torch.api.FCTSession.append` call.

    ``base_rows`` is the relation's row count BEFORE the append — the
    boundary delta dispatches use to restrict tuple sets to the new chunk.
    ``data_epoch`` is the session epoch AFTER the append (unchanged when
    ``rows_appended == 0``: an empty append is a no-op, nothing to fence).
    ``tuple_sets_patched`` counts cached keyword tuple sets extended in
    place (one cheap mask pass over the new rows each); ``plans_dropped``
    counts invalidated routing plans (row routing does change — but CN
    enumerations, built programs and the per-chunk device store survive,
    which is what keeps post-append queries warm).

    ``trace`` is the append's :class:`repro_torch.obs.Trace`: through the
    gateway, a ``gateway.append`` root with ``session.append``, one
    ``session.delta_freq`` per patched (keywords, r_max) — the planner's
    ``plan.cn_plan`` and the engine's spans beneath it — and
    ``gateway.patch``; from ``FCTSession.append`` alone, its
    ``session.append`` span.
    """

    relation: str
    role: str                 # "fact" | "dim"
    dim_index: int            # -1 for the fact
    base_rows: int
    rows_appended: int
    data_epoch: int
    tuple_sets_patched: int = 0
    plans_dropped: int = 0
    trace: Optional[object] = None       # repro_torch.obs.Trace (span tree)
