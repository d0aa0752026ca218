"""TTL result cache for the serving gateway.

Refinement traffic repeats *whole queries*, not just plan shapes: a user
iterating on a keyword set re-issues the same (keywords, r_max, mode) query
many times, often varying only ``top_k``.  The session-level caches (tuple
sets, routing plans, built programs) already make such repeats warm, but they
still cost a device dispatch and a vocab-sized transfer each.  This cache
memoizes the finished :class:`repro_torch.api.FCTResponse` — including the full
frequency vector — so a repeat is answered on the host in microseconds with
ZERO engine dispatches.

Keys deliberately exclude ``top_k``: the cached response carries
``all_freqs``, so a hit re-slices the requested top-k from the memoized
histogram (``topk_terms`` is the same Def. 6 selection the engine path
uses).  Keywords are canonicalized to a *sorted id tuple* — the paper's
query is a keyword set, and FCT totals are order-invariant — so permuted
and string-vs-id spellings of one query share an entry.

Entries expire after ``ttl_s`` seconds (None = never) and can be dropped
eagerly via :meth:`invalidate` — the hook a data-mutation path must call,
since the engine has no way to know the underlying relations changed.
"""
from __future__ import annotations

import threading
import time
from typing import Hashable, Optional

from repro_torch.obs import default_registry
from repro_torch.runtime.cache import LruDict


class ResultCache:
    """Bounded LRU of finished responses with per-entry TTL.

    One instance serves one schema (the gateway keeps a cache per tenant, so
    budgets and invalidation are tenant-isolated); the key is everything on
    the request that changes the *histogram*: (sorted keyword ids, r_max,
    mode, rho, sample_frac, salt).  ``clock`` is injectable for tests.
    """

    def __init__(self, max_entries: Optional[int] = 256,
                 ttl_s: Optional[float] = 60.0, clock=time.monotonic,
                 metrics=None) -> None:
        if ttl_s is not None and ttl_s < 0:
            raise ValueError(f"ttl_s must be >= 0 or None, got {ttl_s}")
        self.ttl_s = ttl_s
        self._clock = clock
        self._entries = LruDict(max_entries)  # key -> (expires_at, value)
        self._lock = threading.Lock()
        self.metrics = metrics if metrics is not None else default_registry()
        self._c_hits = self.metrics.counter("result_cache.hits")
        self._c_misses = self.metrics.counter("result_cache.misses")
        self._c_expirations = self.metrics.counter("result_cache.expirations")
        self._c_invalidations = self.metrics.counter(
            "result_cache.invalidations")
        # bumped by every invalidate(): a put that started (query dispatched)
        # before an invalidation must not re-insert pre-invalidation data
        self.generation = 0

    @property
    def enabled(self) -> bool:
        """ttl_s == 0 disables the cache (every lookup misses, puts are
        dropped) — the serving loop's ``--result-cache-ttl 0``."""
        return self.ttl_s is None or self.ttl_s > 0

    def get(self, key: Hashable):
        """The cached value, or None (miss / expired — expiry also drops
        the entry so a later put can refresh it)."""
        with self._lock:
            if not self.enabled:
                self._c_misses.inc()
                return None
            entry = self._entries.hit(key)
            if entry is None:
                self._c_misses.inc()
                return None
            expires_at, value = entry
            if expires_at is not None and self._clock() >= expires_at:
                del self._entries[key]
                self._c_expirations.inc()
                self._c_misses.inc()
                return None
            self._c_hits.inc()
            return value

    def put(self, key: Hashable, value,
            generation: Optional[int] = None) -> None:
        """Insert; pass the ``generation`` observed when the value's
        computation STARTED to drop results that an ``invalidate`` call
        overtook (they reflect pre-invalidation data)."""
        if not self.enabled:
            return
        expires_at = (None if self.ttl_s is None
                      else self._clock() + self.ttl_s)
        with self._lock:
            if generation is not None and generation != self.generation:
                return                    # invalidated while in flight
            # refresh-on-put: a re-inserted key gets the new expiry (LruDict's
            # first-writer-wins setdefault would pin the stale one)
            self._entries.pop(key, None)
            self._entries.put(key, (expires_at, value))

    def drain(self):
        """Atomically take every live entry out for patch-up, bumping the
        generation: ``(new_generation, [(key, value), ...])``.

        The append path drains, patches each histogram by the append delta,
        and re-inserts with ``generation=new_generation`` — puts from queries
        dispatched BEFORE the drain carry the old generation and are
        dropped, exactly like :meth:`invalidate` (drain IS an invalidation
        whose data survives in patched form).  Expired entries are skipped
        and counted; re-inserted entries get a fresh TTL through the normal
        :meth:`put`.
        """
        with self._lock:
            self.generation += 1
            out = []
            if not self.enabled:
                return self.generation, out
            now = self._clock()
            for key, (expires_at, value) in self._entries.items():
                if expires_at is not None and now >= expires_at:
                    self._c_expirations.inc()
                    continue
                out.append((key, value))
            self._entries.clear()
            return self.generation, out

    def invalidate(self, key: Hashable = None) -> int:
        """Drop one entry (``key``) or every entry (``key=None``); returns
        the number dropped.  Call on any mutation of the underlying data.
        Also fences in-flight queries: their later generation-checked put
        is discarded, so pre-invalidation results cannot re-enter."""
        with self._lock:
            self.generation += 1
            if key is not None:
                dropped = 1 if self._entries.pop(key, None) is not None else 0
            else:
                dropped = len(self._entries)
                self._entries.clear()
            self._c_invalidations.inc(dropped)
            return dropped

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        hits, misses, expirations, invalidations = self.metrics.values(
            self._c_hits, self._c_misses, self._c_expirations,
            self._c_invalidations)
        with self._lock:
            return {"result_entries": len(self._entries),
                    "result_hits": hits, "result_misses": misses,
                    "result_expirations": expirations,
                    "result_invalidations": invalidations,
                    "result_evictions": self._entries.evictions}
