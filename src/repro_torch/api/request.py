"""Request/response objects of the FCT service API.

An :class:`FCTRequest` is everything a caller may vary per query; everything
tied to the *dataset* (schema, tokenizer, mesh, engine, stop list) lives on
the :class:`repro_torch.api.session.FCTSession`.  Requests are frozen and
hashable so they can serve as memo keys.
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
    ``total_ms`` (= plan + execute).  ``engine_stats`` is the *delta* of the
    engine counters attributable to this query (for ``query_batch``, to the
    whole batch — the dispatch is shared); ``cold`` is True iff that delta
    includes at least one program build.

    ``trace`` is the request's :class:`repro_torch.obs.Trace` — the recorded
    span tree (plan/dispatch/collect/finalize, plus store-upload spans).

    ``accum_policy`` names the device-accumulation precision the histogram
    carries: ``"int32-checked"`` — exact below 2^31, wrap-around raises
    instead of answering — or ``"int64-exact"``.
    """

    terms: List[str]
    term_ids: np.ndarray
    freqs: np.ndarray
    all_freqs: np.ndarray
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
    accum_policy: str = "int32-checked"
    row_imbalance: float = 1.0   # dominant CN's ACHIEVED per-worker fact-row
    #                              imbalance (max/mean; ``imbalance`` above
    #                              is over LPT's estimated task costs)

    def topk(self) -> List[Tuple[str, int]]:
        """(term, freq) pairs with zero-frequency tail dropped."""
        return [(t, int(f)) for t, f in zip(self.terms, self.freqs) if f > 0]
