"""Built-program cache for the FCT runtime.

One entry per (program family, shape signature, CN count, backend, mesh)
key; the value is the built program — a closure over the signature's static
dims that runs the device body on tensors.  PyTorch runs eagerly, so
"building" is cheap, but the key discipline is the reference's: the key pins
every dimension the program's shapes depend on, so a warm query builds
nothing.

``traces`` counts builds (the counter keeps the reference's name, where it
counted ``jax.jit`` traces).  Tests assert warm queries leave it untouched.

``max_entries`` bounds the cache for long-lived processes: entries are kept
in LRU order (a ``get_or_build`` hit refreshes recency) and the
least-recently-used program is dropped once the cap is exceeded; a later
request for that signature simply rebuilds it (a miss + build, counted).

``LruDict`` is the shared bounded-LRU primitive — the session-level caches
in ``repro_torch/api`` (tuple sets, routing plans) and the relation store
reuse it rather than re-rolling the eviction bookkeeping.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Optional, Tuple

from repro_torch.obs import default_registry


class LruDict(OrderedDict):
    """OrderedDict with LRU semantics and an optional size bound.

    ``hit(key)`` returns the value (or None) and refreshes its recency;
    ``put(key, value)`` inserts — first writer wins if the key raced in —
    refreshes, evicts past ``max_entries`` (None = unbounded) and returns
    the kept value.  ``evictions`` counts drops.  Callers provide their own
    locking and hit/miss counters.
    """

    def __init__(self, max_entries: Optional[int] = None) -> None:
        super().__init__()
        self.max_entries = max_entries
        self.evictions = 0

    def hit(self, key: Hashable):
        value = self.get(key)
        if value is not None:
            try:
                self.move_to_end(key)
            except KeyError:  # concurrently evicted; the value stays valid
                pass
        return value

    def put(self, key: Hashable, value):
        value = self.setdefault(key, value)
        self.move_to_end(key)
        while self.max_entries is not None and len(self) > self.max_entries:
            self.popitem(last=False)
            # fct-lint: waive[R3] -- externally-locked primitive (docstring): every caller holds its own lock around put/hit
            self.evictions += 1
        return value


class ExecutableCache:
    """Hashable-key -> built program, with LRU eviction and hit/miss/
    build ("traces")/eviction counters."""

    def __init__(self, max_entries: Optional[int] = None,
                 metrics=None) -> None:
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self._fns = LruDict(max_entries)
        self._lock = threading.Lock()
        self.metrics = metrics if metrics is not None else default_registry()
        self._c_hits = self.metrics.counter("executable_cache.hits")
        self._c_misses = self.metrics.counter("executable_cache.misses")
        self._c_traces = self.metrics.counter("executable_cache.traces")

    @property
    def max_entries(self) -> Optional[int]:
        return self._fns.max_entries

    @property
    def evictions(self) -> int:
        return self._fns.evictions

    @property
    def traces(self) -> int:
        return self._c_traces.value

    def get_or_build(self, key: Hashable, builder: Callable[[], Callable]):
        """Return the cached program for ``key``, building it on first use.

        The cache may be shared across sessions, so all bookkeeping happens
        under ``_lock``.  ``builder`` runs outside the lock; if two threads
        race the same cold key, ``LruDict.put``'s first-writer-wins keeps
        exactly one program and the loser's build is discarded (both builds
        are counted).
        """
        return self.fetch(key, builder)[0]

    def fetch(self, key: Hashable, builder: Callable[[], Callable]
              ) -> Tuple[Callable, bool]:
        """``get_or_build`` that also says whether this call built the
        program (the engine puts it on the span of the dispatch that paid
        for the build)."""
        with self._lock:
            fn = self._fns.hit(key)
        if fn is not None:
            self._c_hits.inc()
            return fn, False
        self._c_misses.inc()
        fn = builder()
        self._c_traces.inc()
        with self._lock:
            return self._fns.put(key, fn), True

    def __len__(self) -> int:
        return len(self._fns)

    def stats(self) -> Dict[str, int]:
        # one registry-lock cut for the counters, then the LRU bookkeeping
        # under its own lock — each group internally consistent
        hits, misses, traces = self.metrics.values(
            self._c_hits, self._c_misses, self._c_traces)
        with self._lock:
            return {"entries": len(self), "hits": hits, "misses": misses,
                    "traces": traces, "evictions": self._fns.evictions}


_GLOBAL_CACHE = ExecutableCache()


def default_cache() -> ExecutableCache:
    """Process-wide cache shared by the default engine."""
    return _GLOBAL_CACHE
