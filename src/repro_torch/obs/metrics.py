"""Metrics registry: counters and gauges.

One ``MetricsRegistry`` owns ONE lock (``_lock``); every instrument it
creates shares that same lock object under the attribute name ``_lock``,
so all bumps happen as ``with self._lock: self._value += n``.  The registry
lock is the innermost lock in the process: component locks (cache locks,
store locks, …) may be held *around* an instrument bump, but registry code
never calls back into component code while holding it.  This one-way
ordering makes ABBA deadlocks impossible.

Instruments are cheap append-only objects: ``registry.counter(name, **labels)``
creates a NEW instrument per call (so several engines can each own an
``engine.bytes_shipped`` without clashing); ``snapshot()`` adds up all
instruments sharing a ``(name, labels)`` key.  Each component keeps a direct
handle to its own instruments, so its ``stats()`` view reads exactly its own
contribution via ``value`` / ``registry.values(...)`` (one lock acquisition =
one consistent cut).

Naming convention: ``<component>.<measure>`` in snake_case, with the unit as
a suffix when not a plain count (``_bytes``, ``_ms``).  Labels render in the
snapshot as ``name{key=value,...}`` with keys sorted.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List


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
        self._lock = registry._lock  # the one registry lock
        self.name = name
        self.labels = dict(labels)
        self._value = 0

    @property
    def key(self) -> str:
        return render_key(self.name, self.labels)

    @property
    def value(self):
        with self._lock:
            return self._value


class Counter(_Instrument):
    """Monotonic counter."""

    kind = "counter"

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n


class Gauge(_Instrument):
    """Point-in-time value (instruments of one key add up in
    ``snapshot()``)."""

    kind = "gauge"

    def set(self, value) -> None:
        with self._lock:
            self._value = value

    def add(self, delta):
        """Add ``delta`` and return the new value, in one atomic step."""
        with self._lock:
            self._value += delta
            return self._value


class MetricsRegistry:
    """Threadsafe home for every instrument in the process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: List[_Instrument] = []

    def _register(self, inst: _Instrument) -> _Instrument:
        with self._lock:
            self._instruments.append(inst)
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._register(Counter(self, name, labels))

    def gauge(self, name: str, **labels) -> Gauge:
        return self._register(Gauge(self, name, labels))

    def values(self, *instruments: _Instrument) -> List[Any]:
        """Read several instruments under ONE lock acquisition — the
        consistent-snapshot primitive behind components' ``stats()``."""
        with self._lock:
            return [inst._value for inst in instruments]

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """One consistent cut: ``{"counters": {...}, "gauges": {...}}`` keyed
        by ``name{label=value}``, instruments of one key added up."""
        out: Dict[str, Dict[str, Any]] = {"counters": {}, "gauges": {}}
        with self._lock:
            for inst in self._instruments:
                bucket = out[inst.kind + "s"]
                bucket[inst.key] = bucket.get(inst.key, 0) + inst._value
        return out


_DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """Process-wide registry shared by default-constructed components."""
    return _DEFAULT_REGISTRY
