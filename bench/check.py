"""The comparison that decides ``correct``: every answer of the window
against the plain reference, exactly.

Each number compared has the limit 0, the answers being exact integers:

* ``bins_wrong``: over the answers, the most bins of the full frequency
  vector (``all_freqs``) that differ from the reference's;
* ``topk_wrong``: answers whose top-k ids, order or counts differ;
* ``failed``: requests that raised or never answered;
* ``stale`` (cells that append): answers computed at a data epoch older
  than the appends that had returned before their call.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from bench.reference.star import topk

LIMITS = {"bins_wrong": 0, "topk_wrong": 0, "failed": 0, "stale": 0}


def compare(answers: Sequence[Tuple[Sequence[int], int, object, np.ndarray]],
            failed: int, stale: Optional[int] = None) -> Dict[str, dict]:
    """``answers``: ``(keywords, top_k, response, reference freq)`` each."""
    bins = tk = 0
    for kws, k, resp, ref in answers:
        if resp.all_freqs is not None:
            bins = max(bins, int(np.count_nonzero(
                np.asarray(resp.all_freqs) != ref)))
        ids, f = topk(ref, kws, k)
        if not (np.array_equal(np.asarray(resp.term_ids), ids)
                and np.array_equal(np.asarray(resp.freqs), f)):
            tk += 1
    values = {"bins_wrong": bins, "topk_wrong": tk, "failed": int(failed)}
    if stale is not None:
        values["stale"] = int(stale)
    return {name: {"value": v, "limit": LIMITS[name]}
            for name, v in values.items()}


def correct(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
