"""Plain PyTorch version of the weighted token histogram (MR² inner loop).

freq[b, w] = Σ_rows weight[b, row] · count(tokens[b, row], w),   PAD excluded.

:func:`routed_weighted_histogram` is the same over routed relations given
by their texts and send tables: it builds the routed tokens, then counts.

Tokens outside ``[0, vocab)`` are dropped, negative ids included — as the
TPU kernel does (its one-hot compare never matches them).  The reference
package's own plain version disagrees on negatives (its scatter wraps them
to the top of the vocab); the main path never produces one, because text is
padded with PAD_ID 0.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.data.schema import PAD_ID


def weighted_histogram(tokens: torch.Tensor, weights: torch.Tensor,
                       vocab: int) -> torch.Tensor:
    """tokens [B, R, L] int32, weights [B, R] -> [B, vocab] in the weight
    dtype; integer dtypes accumulate exactly modulo their width."""
    B, R, L = tokens.shape
    tok = tokens.reshape(B, R * L).long()
    keep = (tok != PAD_ID) & (tok >= 0) & (tok < vocab)
    w = weights.unsqueeze(-1).expand(B, R, L).reshape(B, R * L)
    w = torch.where(keep, w, torch.zeros((), dtype=w.dtype, device=w.device))
    base = torch.arange(B, device=tokens.device).unsqueeze(-1) * vocab
    idx = torch.where(keep, tok, 0) + base
    out = torch.zeros(B * vocab, dtype=weights.dtype, device=tokens.device)
    out.index_add_(0, idx.reshape(-1), w.reshape(-1))
    return out.view(B, vocab)


def routed_weighted_histogram(texts: Sequence[torch.Tensor],
                              send: torch.Tensor, weights: torch.Tensor,
                              vocab: int) -> torch.Tensor:
    """MR² over routed relations, written out: build each CN's routed
    tokens, then :func:`weighted_histogram`.

    ``texts[n]`` is CN n's ``[P, S, L]`` text, ``send [N, P(src), P(dst),
    C]`` the local row each source sends each destination (-1 pads),
    ``weights [N, P(dst), P*C]``.  Destination ``dst`` receives, in source
    order, rows ``send[n, src, dst, :]`` of source ``src``; an index
    outside ``[0, S)`` is clamped to it (a pad weighs 0) -> ``[N, vocab]``.
    """
    N, P, _, C = send.shape
    S, L = texts[0].shape[1:]
    received = send.transpose(1, 2).long().clamp(0, S - 1)  # [N, dst, src, C]
    source = torch.arange(P, device=send.device).view(1, 1, P, 1) * S
    rows = (received + source).reshape(N, P * P * C)
    tokens = torch.stack([texts[n].reshape(P * S, L)[rows[n]]
                          for n in range(N)])
    return weighted_histogram(tokens, weights.reshape(N, P * P * C), vocab)
