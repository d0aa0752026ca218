"""What every cell shares: the spec, a run's record, the per-metric readers
and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``bench/configs/<name>
.json``, found by the ``file`` of its entry) and a traffic mix
(``bench/traffic/<mix>.json``), whose ``client`` names the module under
``bench/clients/`` that sets the program up, runs the window and hands the
answers to the reference.  Each metric, end-to-end or per-layer, is read by
``bench/metrics/<name>.py``'s ``read(run)``, which returns a number or None
(nothing to read: the metric is left out of the line).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: top-level modules that may not be loaded in a run: JAX, and the JAX
#: package of this repository and its benchmarks
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def load_spec(path: Optional[Path] = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def find_cell(spec: dict, workload: str):
    """``(cell, config, traffic)`` of the named workload; KeyError when the
    spec has no such cell."""
    cells = {w["name"]: w for w in spec["workloads"]}
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return cell, config, traffic


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


@dataclasses.dataclass
class Run:
    """One run of one cell: its inputs and everything measured."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    #: set-up phases, seconds, in order
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    setup_s: Optional[float] = None
    #: keyword sets of the traffic's pool, as token ids
    pool: List[tuple] = dataclasses.field(default_factory=list)
    #: ``(pool index, top_k, response)`` of the set-up's queries, in order
    setup_answers: List[tuple] = dataclasses.field(default_factory=list)
    #: ``(pool index, top_k, response, latency ms)`` of the window; in a
    #: cell that appends, also the appends that had returned before the call
    answers: List[tuple] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    #: answers older than the appends that had returned before their call
    #: (None where the cell appends nothing)
    stale: Optional[int] = None
    errors: List[str] = dataclasses.field(default_factory=list)
    window_s: Optional[float] = None
    #: RF1 refreshes of the window: ms from the first append's call to the
    #: last append's return
    refresh_ms: List[float] = dataclasses.field(default_factory=list)
    #: the device trace's readings (``DeviceTrace.result``) and the pool
    #: index of each request it covers
    device_trace: Optional[dict] = None
    traced: List[int] = dataclasses.field(default_factory=list)
    memory_peak_bytes: Optional[int] = None
    #: the reference's ``(freq, stats)`` per pool index
    reference: Dict[int, tuple] = dataclasses.field(default_factory=dict)
    #: the program's live objects, dropped before the reference runs
    state: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def phase(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + seconds


def metric_entries(spec: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a cell reports: with ``trace`` its per-layer metrics,
    else its end-to-end ones."""
    e2e = [m for m in spec["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]


def reader(name: str):
    """``read`` of ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics._{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(entries: List[dict], run: Run) -> Dict[str, dict]:
    out = {}
    for m in entries:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def sync(run: Run) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    if run.device.type == "cuda":
        import torch
        torch.cuda.synchronize(run.device)


def free(run: Run) -> None:
    """Return the program's freed device memory, so that the reference
    that follows runs in it."""
    import gc
    gc.collect()
    if run.device.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def client(name: str):
    return importlib.import_module(f"bench.clients.{name}")
