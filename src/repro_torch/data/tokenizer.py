"""Hashing tokenizer + stopword handling.

Real deployments put the tokenizer at ingest; here it exists so the examples
can run on actual strings and so term ids round-trip to something readable.
Term id 0 is PAD; ids [1, n_stopwords] are stopwords (excluded from FCT
results, mirroring the paper's stop-word filter in MapReduce^2nd).
"""
from __future__ import annotations

import re
from typing import Iterable, List, Sequence

import numpy as np

from repro_torch.data.schema import PAD_ID

_WORD = re.compile(r"[A-Za-z0-9_]+")

DEFAULT_STOPWORDS = (
    "the a an and or of to in on for with at by from is are was were be been".split()
)


class HashingTokenizer:
    """Stable string->id tokenizer over a fixed vocab, with a decode table."""

    def __init__(self, vocab_size: int, stopwords: Sequence[str] = DEFAULT_STOPWORDS):
        self.vocab_size = vocab_size
        self.stop_ids = set()
        self._decode: dict[int, str] = {}
        self._stop_strings = set(stopwords)
        for s in stopwords:
            self.stop_ids.add(self._hash(s))

    def _hash(self, word: str) -> int:
        h = 2166136261
        for ch in word.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        tid = 1 + (h % (self.vocab_size - 1))  # never PAD_ID
        self._decode.setdefault(tid, word)
        return tid

    def encode(self, s: str, length: int) -> np.ndarray:
        ids = [self._hash(w.lower()) for w in _WORD.findall(s)]
        ids = ids[:length] + [PAD_ID] * max(0, length - len(ids))
        return np.asarray(ids, np.int32)

    def encode_batch(self, texts: Iterable[str], length: int) -> np.ndarray:
        return np.stack([self.encode(t, length) for t in texts])

    def decode(self, tid: int) -> str:
        return self._decode.get(int(tid), f"<{tid}>")

    def stop_mask(self) -> np.ndarray:
        mask = np.zeros((self.vocab_size,), bool)
        for tid in self.stop_ids:
            mask[tid] = True
        mask[PAD_ID] = True
        return mask


def decode_topk(tok: HashingTokenizer, term_ids, freqs) -> List[tuple]:
    return [(tok.decode(t), int(f)) for t, f in zip(term_ids, freqs) if f > 0]
