"""serve_step factory — the unit the serving launcher runs per token.

The reference's ``make_train_step`` waits for the backward kernels of
flash_attention and lru_scan (ROADMAP Q9b).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as model_lib


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, cache, tokens, pos: int):
        """Greedy next token [B] (int64, where the reference returns int32)
        and the updated cache."""
        logits, cache = model_lib.decode_step(params, cache, tokens, pos, cfg)
        return logits[:, -1].argmax(dim=-1), cache
    return serve_step
