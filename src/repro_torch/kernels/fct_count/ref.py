"""Plain PyTorch version of the weighted token histogram (MR² inner loop).

freq[b, w] = Σ_rows weight[b, row] · count(tokens[b, row], w),   PAD excluded.

Tokens outside ``[0, vocab)`` are dropped, negative ids included — as the
TPU kernel does (its one-hot compare never matches them).  The reference
package's own plain version disagrees on negatives (its scatter wraps them
to the top of the vocab); the main path never produces one, because text is
padded with PAD_ID 0.
"""
from __future__ import annotations

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
