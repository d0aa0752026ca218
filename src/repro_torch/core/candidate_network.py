"""Schema graph, tuple sets and star candidate-network enumeration (§3).

Tuple-set semantics follow DISCOVER [17] as used by the paper's example:
``R^K`` is the set of tuples of R whose contained *query*-keyword set is
EXACTLY K.  This makes MTJNT(CN_i) ∩ MTJNT(CN_j) = ∅ (the paper's Eq. 1
precondition) — a result instance determines its CN uniquely from the tree
shape plus each tuple's exact keyword subset — so per-CN frequencies sum.

For a star schema (dimensions connect only through the fact), a candidate
network is a leaf subset L ⊆ dims plus an exact keyword bitmask per node in
{fact} ∪ L.  Validity (Total) and Minimality (Def. 3):
  * union of all masks == full query mask                     (total)
  * every leaf mask ∉ union(other masks)  — i.e. dropping any leaf loses a
    keyword (a leaf with ∅ is a free leaf ⇒ removable ⇒ non-minimal)
  * |L| == 0: fact alone must carry the full mask
  * |L| == 1: the fact is removable too (removal leaves one node), so the
    leaf mask must not be full; and the leaf is removable unless the fact
    mask misses some of its keywords.
Masks may OVERLAP (fact^{k1,k2} ⋈ D^{k2,k3} is a valid CN) — exact-subset
labels keep the result sets disjoint regardless.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.data.schema import StarSchema, keyword_mask


@dataclasses.dataclass(frozen=True)
class StarCN:
    """A star candidate network: exact keyword bitmask per node.

    ``fact_mask`` — exact keyword bitmask required of fact tuples;
    ``dim_masks`` — per-dimension bitmask, or None if the dim is excluded;
    ``single_dim`` — if >= 0, the CN is that single dimension alone (no join).
    """

    fact_mask: int
    dim_masks: Tuple[object, ...]  # int | None per dimension
    single_dim: int = -1

    @property
    def included(self) -> Tuple[int, ...]:
        return tuple(i for i, m in enumerate(self.dim_masks) if m is not None)

    def n_relations(self) -> int:
        return 1 if self.single_dim >= 0 else 1 + len(self.included)


def enumerate_star_cns(n_keywords: int, m_dims: int, r_max: int) -> List[StarCN]:
    """All valid star CNs with ≤ r_max relations."""
    full = (1 << n_keywords) - 1
    cns: List[StarCN] = []
    if r_max >= 1:
        cns.append(StarCN(fact_mask=full, dim_masks=(None,) * m_dims))
        for i in range(m_dims):
            dm: List[object] = [None] * m_dims
            cns.append(StarCN(fact_mask=-1, dim_masks=tuple(dm), single_dim=i))
    masks_nonempty = list(range(1, full + 1))
    masks_any = list(range(full + 1))
    for leaves in _subsets(range(m_dims)):
        if not leaves or 1 + len(leaves) > r_max:
            continue
        for fact_mask in masks_any:
            for leaf_masks in itertools.product(masks_nonempty, repeat=len(leaves)):
                union = fact_mask
                for lm in leaf_masks:
                    union |= lm
                if union != full:
                    continue
                if not _minimal(fact_mask, leaf_masks, full):
                    continue
                dim_masks: List[object] = [None] * m_dims
                for leaf, lm in zip(leaves, leaf_masks):
                    dim_masks[leaf] = lm
                cns.append(StarCN(fact_mask=fact_mask, dim_masks=tuple(dim_masks)))
    return cns


def _minimal(fact_mask: int, leaf_masks: Tuple[int, ...], full: int) -> bool:
    n = len(leaf_masks)
    for i in range(n):  # each leaf must contribute a unique keyword
        union = fact_mask
        for j, lm in enumerate(leaf_masks):
            if j != i:
                union |= lm
        if union == full:
            return False
    if n == 1 and leaf_masks[0] == full:
        return False  # fact removable: single leaf already total
    return True


def _subsets(items):
    items = list(items)
    out = []
    for r in range(len(items) + 1):
        out.extend(itertools.combinations(items, r))
    return out


@dataclasses.dataclass
class TupleSets:
    """Exact-keyword-subset bitmasks per relation (host-side, one data pass)."""

    fact_kw: np.ndarray                 # int64 [fact_rows]
    dim_kw: List[np.ndarray]            # per dim, int64 [rows]
    full: int

    @staticmethod
    def build(schema: StarSchema, keywords: Sequence[int]) -> "TupleSets":
        return TupleSets(
            fact_kw=keyword_mask(schema.fact.text, keywords),
            dim_kw=[keyword_mask(d.text, keywords) for d in schema.dims],
            full=(1 << len(keywords)) - 1,
        )

    def fact_rows(self, mask: int) -> np.ndarray:
        return np.nonzero(self.fact_kw == mask)[0]

    def dim_rows(self, i: int, mask: int) -> np.ndarray:
        return np.nonzero(self.dim_kw[i] == mask)[0]

    def cn_rows(self, cn: StarCN):
        """(fact_row_idx or None, {dim_i: row_idx}) for a CN's tuple sets."""
        if cn.single_dim >= 0:
            return None, {cn.single_dim: self.dim_rows(cn.single_dim, self.full)}
        dims = {i: self.dim_rows(i, cn.dim_masks[i]) for i in cn.included}
        return self.fact_rows(cn.fact_mask), dims


def prune_empty_cns(cns: List[StarCN], ts: TupleSets) -> List[StarCN]:
    """Drop CNs where some tuple set is empty (no MTJNT can exist)."""
    out = []
    for cn in cns:
        fact_idx, dim_idx = ts.cn_rows(cn)
        if fact_idx is not None and len(fact_idx) == 0:
            continue
        if any(len(v) == 0 for v in dim_idx.values()):
            continue
        out.append(cn)
    return out
