"""Run one cell of ``BENCHMARK.json`` once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's tables from the seed, sets the program up and warms it
(``setup_s``), drives the cell's traffic for ``--seconds``, then frees the
program, runs the plain reference over the same tables and compares every
answer of the window with it.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(and with ``--trace 1``, ``breakdown``) and, last, ``checks``: each number
compared with its limit, which also end standard error.  Exits non-zero
without a result when there is no CUDA device, too few of them, or when a
JAX module is loaded once the reference and the metric readers have run.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import gc  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from bench import check, harness  # noqa: E402
from bench.devtrace import top  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    return 1


def main(argv=None, *, device=None, spec=None, config=None) -> int:
    """One run.  ``device``, ``spec`` and ``config`` replace the card, the
    committed ``BENCHMARK.json`` and the cell's configuration (tests drive
    a run on the CPU with them)."""
    args = parse(argv)
    spec = spec if spec is not None else harness.load_spec()
    try:
        cell, cfg, traffic = harness.find_cell(spec, args.workload)
    except KeyError:
        return fail(f"no workload {args.workload!r} in BENCHMARK.json")
    cfg = config if config is not None else cfg
    if device is None:
        if not torch.cuda.is_available():
            return fail("no CUDA device (torch.cuda.is_available() is False)")
        if torch.cuda.device_count() < cell["chips"]:
            return fail(f"{cell['name']} needs {cell['chips']} devices, "
                        f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
        # the program's host work is numpy and Python: one intra-op thread
        # keeps torch's pool from contending with it for the host's cores
        torch.set_num_threads(1)
    device = torch.device(device)
    run = harness.Run(cell=cell, config=cfg, traffic=traffic,
                      seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=device,
                      t_start=T_START)
    client = harness.client(traffic["client"])
    client.setup(run)
    run.setup_s = time.perf_counter() - run.t_start
    # set-up's objects go to the collector's permanent generation, so that
    # no full collection walks them inside the window
    gc.collect()
    gc.freeze()
    try:
        client.window(run)
    finally:
        gc.unfreeze()
    on_card = device.type == "cuda"
    if on_card:
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    client.finish(run)
    t = time.perf_counter()
    answers = client.reference(run)
    checks = check.compare(answers, run.failed, run.stale)
    reference_s = time.perf_counter() - t
    metrics = harness.read_metrics(
        harness.metric_entries(spec, cell["name"], run.trace), run)
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": check.correct(checks), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if run.device_trace is not None:
        dt = run.device_trace
        dev["busy_s"], dev["window_s"] = dt["busy_s"], dt["window_s"]
        result["breakdown"] = {"device_ops": top(dt["kernels"]),
                               "idle_gaps": top(dt["idle_by_host"])}
    result["setup_phases_s"] = run.phases
    result["reference_s"] = reference_s
    if run.errors:
        result["errors"] = run.errors[:5]
    result["checks"] = checks
    loaded = harness.forbidden_loaded()
    if loaded:
        return fail(f"forbidden modules loaded: {loaded}")
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
