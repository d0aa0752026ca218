"""Metrics registry: counters, gauges, and log-bucketed histograms.

One ``MetricsRegistry`` owns ONE lock (``_lock``); every instrument it
creates shares that same lock object under the attribute name ``_lock``,
so all bumps happen as ``with self._lock: self._value += n``.
The registry lock is the innermost lock in the process: component locks
(engine ``_lock``s, cache locks, …) may be held *around* an instrument bump,
but registry code never calls back into component code while holding it —
``gauge_fn`` callbacks are evaluated outside the lock at snapshot time.
This one-way ordering makes ABBA deadlocks impossible.

Instruments are cheap append-only objects: ``registry.counter(name, **labels)``
creates a NEW instrument per call (so per-tenant engines can each own an
``engine.bytes_shipped`` without clashing); ``snapshot()`` aggregates all
instruments sharing a ``(name, labels)`` key — counters and sum-gauges add,
``agg="max"`` gauges take the max, histograms merge bucket counts.  Each
component keeps a direct handle to its own instruments, so its legacy
``stats()`` view reads exactly its own contribution via ``value`` /
``registry.values(...)`` (one lock acquisition = one consistent cut).

Naming convention: ``<component>.<measure>`` in snake_case, with the unit as
a suffix when not a plain count (``_bytes``, ``_ms``).  Labels render in the
snapshot as ``name{key=value,...}`` with keys sorted.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# Fixed log2-scale latency buckets (milliseconds): 2^-7 ms (~8us) .. 2^14 ms
# (~16s).  Shared by every latency histogram so snapshots merge cleanly.
LATENCY_BUCKETS_MS: Tuple[float, ...] = tuple(2.0 ** i for i in range(-7, 15))

# Small pow-2 buckets for occupancy-style histograms (batch sizes, depths).
OCCUPANCY_BUCKETS: Tuple[float, ...] = tuple(float(2 ** i) for i in range(0, 9))


def render_key(name: str, labels: Dict[str, Any]) -> str:
    """``name{k=v,...}`` with sorted label keys; bare ``name`` if unlabeled."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class _Instrument:
    kind = "instrument"

    def __init__(self, registry: "MetricsRegistry", name: str,
                 labels: Dict[str, Any]) -> None:
        self._registry = registry
        self._lock = registry._lock  # the one registry lock
        self.name = name
        self.labels = dict(labels)

    @property
    def key(self) -> str:
        return render_key(self.name, self.labels)

    def _read(self):  # caller holds self._lock
        raise NotImplementedError


class Counter(_Instrument):
    """Monotonic counter.  ``reset()`` exists only for cache ``clear()``
    compatibility; metric sinks should treat values as monotonic."""

    kind = "counter"

    def __init__(self, registry, name, labels) -> None:
        super().__init__(registry, name, labels)
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def _read(self):
        return self._value


class Gauge(_Instrument):
    """Point-in-time value.  ``agg`` controls cross-instrument aggregation in
    ``snapshot()``: ``"sum"`` (default, e.g. in-flight depths add across
    components) or ``"max"`` (peaks)."""

    kind = "gauge"

    def __init__(self, registry, name, labels, agg: str = "sum") -> None:
        if agg not in ("sum", "max"):
            raise ValueError(f"agg must be 'sum' or 'max', got {agg!r}")
        super().__init__(registry, name, labels)
        self.agg = agg
        self._value = 0

    def set(self, value) -> None:
        with self._lock:
            self._value = value

    def add(self, delta):
        """Add ``delta`` and return the new value (one atomic step, so
        callers can pair it with ``set_max`` for peak tracking)."""
        with self._lock:
            self._value += delta
            return self._value

    def set_max(self, value) -> None:
        with self._lock:
            if value > self._value:
                self._value = value

    @property
    def value(self):
        with self._lock:
            return self._value

    def _read(self):
        return self._value


def _percentile(bounds: Sequence[float], counts: Sequence[int],
                total: int, p: float) -> float:
    """Linear-interpolated percentile from bucket counts.  ``counts`` has
    ``len(bounds) + 1`` entries; the last is the +inf overflow bucket."""
    if total <= 0:
        return 0.0
    rank = (p / 100.0) * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if c and cum >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            if hi <= lo:
                return float(hi)
            frac = (rank - (cum - c)) / c
            return float(lo + (hi - lo) * frac)
    return float(bounds[-1])


class Histogram(_Instrument):
    """Fixed-bucket histogram (Prometheus-style ``le`` semantics: bucket i
    counts observations ``<= bounds[i]``, plus a +inf overflow bucket)."""

    kind = "histogram"

    def __init__(self, registry, name, labels,
                 buckets: Sequence[float] = LATENCY_BUCKETS_MS) -> None:
        super().__init__(registry, name, labels)
        self.bounds: Tuple[float, ...] = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._n = 0

    def observe(self, value: float) -> None:
        idx = bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def percentile(self, p: float) -> float:
        with self._lock:
            return _percentile(self.bounds, self._counts, self._n, p)

    def _read(self):
        return {"bounds": self.bounds, "counts": list(self._counts),
                "sum": self._sum, "count": self._n}


def _histogram_summary(bounds, counts, total, hsum) -> Dict[str, Any]:
    return {
        "count": total,
        "sum": round(float(hsum), 6),
        "p50": round(_percentile(bounds, counts, total, 50.0), 6),
        "p95": round(_percentile(bounds, counts, total, 95.0), 6),
        "p99": round(_percentile(bounds, counts, total, 99.0), 6),
        "buckets": {("+inf" if i == len(bounds) else repr(bounds[i])): c
                    for i, c in enumerate(counts) if c},
    }


class MetricsRegistry:
    """Threadsafe home for every instrument in the process.

    ``snapshot()`` returns one consistent cut of every registered
    instrument — all native instruments are read under the single registry
    lock, then callback gauges (``gauge_fn``) are evaluated outside it.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: List[_Instrument] = []
        self._callbacks: List[Tuple[str, Dict[str, Any], Callable[[], Any]]] = []

    # -- instrument factories -------------------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        c = Counter(self, name, labels)
        with self._lock:
            self._instruments.append(c)
        return c

    def gauge(self, name: str, agg: str = "sum", **labels) -> Gauge:
        g = Gauge(self, name, labels, agg=agg)
        with self._lock:
            self._instruments.append(g)
        return g

    def histogram(self, name: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS_MS,
                  **labels) -> Histogram:
        h = Histogram(self, name, labels, buckets=buckets)
        with self._lock:
            self._instruments.append(h)
        return h

    def gauge_fn(self, name: str, fn: Callable[[], Any], **labels) -> None:
        """Register a callback gauge.  ``fn`` is called at snapshot time,
        OUTSIDE the registry lock (it may take component locks)."""
        with self._lock:
            self._callbacks.append((name, dict(labels), fn))

    def labeled(self, **labels) -> "LabeledRegistry":
        """A facade whose instruments all carry ``labels`` (merged with any
        call-site labels).  The gateway hands one per tenant."""
        return LabeledRegistry(self, labels)

    # -- reads ----------------------------------------------------------------
    def values(self, *instruments: _Instrument) -> List[Any]:
        """Read several instruments under ONE lock acquisition — the
        consistent-snapshot primitive behind legacy ``stats()`` views."""
        with self._lock:
            return [inst._read() for inst in instruments]

    def snapshot(self, labels: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """One consistent cut: ``{"counters": {...}, "gauges": {...},
        "histograms": {...}}`` keyed by ``name{label=value}``.  ``labels``
        filters to instruments whose labels contain every given pair."""

        def match(inst_labels: Dict[str, Any]) -> bool:
            if not labels:
                return True
            return all(inst_labels.get(k) == v for k, v in labels.items())

        with self._lock:
            rows = [(i.kind, i.key, getattr(i, "agg", None), i._read())
                    for i in self._instruments if match(i.labels)]
            callbacks = [(n, dict(lb), fn) for n, lb, fn in self._callbacks
                         if match(lb)]

        counters: Dict[str, int] = {}
        gauges: Dict[str, Any] = {}
        hists: Dict[str, Dict[str, Any]] = {}
        for kind, key, agg, data in rows:
            if kind == "counter":
                counters[key] = counters.get(key, 0) + data
            elif kind == "gauge":
                if key not in gauges:
                    gauges[key] = data
                elif agg == "max":
                    gauges[key] = max(gauges[key], data)
                else:
                    gauges[key] += data
            else:  # histogram
                cur = hists.get(key)
                if cur is None or cur["bounds"] != data["bounds"]:
                    if cur is not None:  # mismatched bounds: keep both keys
                        key = f"{key}#b{len(data['bounds'])}"
                    hists[key] = {"bounds": data["bounds"],
                                  "counts": list(data["counts"]),
                                  "sum": data["sum"], "count": data["count"]}
                else:
                    cur["counts"] = [a + b for a, b in
                                     zip(cur["counts"], data["counts"])]
                    cur["sum"] += data["sum"]
                    cur["count"] += data["count"]
        for name, lb, fn in callbacks:  # outside the registry lock
            gauges[render_key(name, lb)] = fn()
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {k: _histogram_summary(v["bounds"], v["counts"],
                                                 v["count"], v["sum"])
                           for k, v in hists.items()},
        }


class LabeledRegistry:
    """View over a base registry that stamps fixed labels on every
    instrument it creates.  Safe to nest (labels merge, inner wins)."""

    def __init__(self, base: MetricsRegistry, labels: Dict[str, Any]) -> None:
        self._base = base
        self._labels = dict(labels)

    def counter(self, name: str, **labels) -> Counter:
        return self._base.counter(name, **{**self._labels, **labels})

    def gauge(self, name: str, agg: str = "sum", **labels) -> Gauge:
        return self._base.gauge(name, agg=agg, **{**self._labels, **labels})

    def histogram(self, name: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS_MS,
                  **labels) -> Histogram:
        return self._base.histogram(name, buckets=buckets,
                                    **{**self._labels, **labels})

    def gauge_fn(self, name: str, fn: Callable[[], Any], **labels) -> None:
        self._base.gauge_fn(name, fn, **{**self._labels, **labels})

    def labeled(self, **labels) -> "LabeledRegistry":
        return LabeledRegistry(self._base, {**self._labels, **labels})

    def values(self, *instruments: _Instrument) -> List[Any]:
        return self._base.values(*instruments)

    def snapshot(self, labels: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        return self._base.snapshot(labels)


_DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """Process-wide registry shared by default-constructed components."""
    return _DEFAULT_REGISTRY
