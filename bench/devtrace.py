"""Device busy time, kernel time by name and idle gaps from ``torch.profiler``.

The arithmetic of the device's busy time is copied from
``chip_smoke.py::profile_device`` (commit b56447e): only kernels and copies
count (the device-side copies of ``record_function`` ranges span whole
programs), and busy time is the union of their intervals.  Beside it, each
idle gap of the device is put down to what the host was doing then: the
innermost of the program's own spans (``FCTResponse.trace``: ``plan``,
``dispatch``, ``engine.dispatch_group``, ``collect``, ...) that covers the
gap's middle, else ``client`` (the harness between requests).  The program
times its spans with ``time.perf_counter_ns``; a ``record_function`` mark
whose host time is known ties that clock to the profiler's.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

MARK = "bench.clock_mark"


class DeviceTrace:
    """``with DeviceTrace() as dt: ...`` profiles the block; afterwards
    ``dt.result(spans)`` gives the readings."""

    def __enter__(self) -> "DeviceTrace":
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._mark_ns = time.perf_counter_ns()
        with torch.profiler.record_function(MARK):
            pass
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self._prof.__exit__(*exc)

    def result(self, spans: Iterable[Tuple[str, int, int, int]]) -> dict:
        """Readings of the traced block.  ``spans`` are the program's host
        spans as ``(name, depth, t0_ns, dur_ns)`` in ``perf_counter_ns``.

        Returns ``busy_s`` (the union of device intervals), ``window_s``,
        ``kernels`` (device seconds by kernel name) and ``idle_by_host``
        (idle device seconds by what the host was doing)."""
        from torch.autograd import DeviceType
        mark_us = None
        intervals: List[Tuple[float, float]] = []
        kernels: Dict[str, float] = {}
        for e in self._prof.events():
            if e.name == MARK and e.device_type == DeviceType.CPU:
                mark_us = e.time_range.start
            elif e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                r = e.time_range
                intervals.append((r.start, r.end))
                kernels[e.name] = kernels.get(e.name, 0.0) + (r.end - r.start) / 1e6
        out = {"busy_s": 0.0, "window_s": self.window_s, "kernels": kernels,
               "idle_by_host": {}}
        if not intervals:
            return out
        if mark_us is None:     # no mark: the window starts at the first op
            mark_us = min(s for s, _ in intervals)
        busy_us, gaps = union(intervals, mark_us,
                              mark_us + self.window_s * 1e6)
        out["busy_s"] = busy_us / 1e6
        # host spans on the profiler's clock (microseconds)
        shift = mark_us - self._mark_ns / 1e3
        placed = [(t0 / 1e3 + shift, (t0 + dur) / 1e3 + shift, depth, name)
                  for name, depth, t0, dur in spans]
        out["idle_by_host"] = attribute(gaps, placed)
        return out


def union(intervals: Iterable[Tuple[float, float]], start: float,
          end: float) -> Tuple[float, List[Tuple[float, float]]]:
    """``(busy, gaps)`` of device intervals within ``[start, end]``: the
    length of their union, and the idle stretches between ``start``, the
    intervals and ``end``."""
    busy, gaps, cur = 0.0, [], start
    for s, e in sorted(intervals):
        s, e = max(s, start), min(e, end)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        busy += max(0.0, e - max(s, cur))
        cur = max(cur, e)
    if end > cur:
        gaps.append((cur, end))
    return busy, gaps


def attribute(gaps: Iterable[Tuple[float, float]],
              spans: Iterable[Tuple[float, float, int, str]]
              ) -> Dict[str, float]:
    """Idle seconds (gaps in microseconds) by the host span ``(start, end,
    depth, name)`` that covers each gap's middle: the deepest, the shortest
    of equals; ``client`` where none does."""
    spans = sorted(spans)
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        label, best = "client", None
        for s, e, depth, name in spans:
            if s > mid:
                break
            if e >= mid and (best is None or (depth, s - e) > best):
                label, best = name, (depth, s - e)
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return idle


def spans_of(traces: Iterable[Optional[object]]) -> List[Tuple[str, int, int, int]]:
    """``(name, depth, t0_ns, dur_ns)`` of every span of the program's
    request traces (``repro_torch.obs.Trace``); a span's depth is the number
    of its ancestors plus one, stage spans without a parent are depth 1."""
    out = []
    for tr in traces:
        if tr is None:
            continue
        spans = tr.spans()
        parent = {s.span_id: s.parent_id for s in spans}
        for s in spans:
            depth, p = 1, s.parent_id
            while p:
                depth, p = depth + 1, parent.get(p, 0)
            out.append((s.name, depth, s.t0_ns, s.dur_ns))
    return out


def top(items: Dict[str, float], n: int = 10, width: int = 120
        ) -> List[list]:
    """The ``n`` largest entries as ``[name, seconds]``, largest first, each
    name cut to ``width`` characters (kernel names spell out their template
    arguments)."""
    return [[k[:width], v]
            for k, v in sorted(items.items(), key=lambda kv: -kv[1])[:n]]


def idle_share(run) -> Optional[float]:
    """Share of the traced stretch in which no kernel or copy ran on the
    device, in %; None where nothing was traced."""
    dt = run.device_trace
    if dt is None or not dt["window_s"]:
        return None
    return (1.0 - dt["busy_s"] / dt["window_s"]) * 100.0
