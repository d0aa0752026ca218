"""Tiny copies of the benchmark's configurations, and a whole run on the
CPU, for the benchmark's own tests."""
from __future__ import annotations

import contextlib
import io
import json
import sys

from bench import harness

if str(harness.ROOT / "src") not in sys.path:
    sys.path.insert(0, str(harness.ROOT / "src"))

SEED = 3_000_000_019            # past 32 bits: seeds may be that large


def config(name: str, scale: float = 0.002, vocab: int = 0) -> dict:
    """The named configuration with every table cut to ``scale`` (and the
    vocabulary to ``vocab``, the planted keywords its last ids)."""
    cfg = json.loads((harness.BENCH / "configs" / f"{name}.json").read_text())
    cfg["rows"] = {k: max(16, int(v * scale)) for k, v in cfg["rows"].items()}
    cfg["scale_factor"] = scale
    if vocab:
        n = len(cfg["planted"]["keywords"])
        cfg["vocab"] = vocab
        cfg["planted"]["keywords"] = list(range(vocab - n, vocab))
    return cfg


def run_cell(workload: str, cfg: dict, seconds: float = 1.0,
             seed: int = SEED):
    """``(exit code, result or None, stderr)`` of one run on the CPU."""
    from bench import run
    out, err = io.StringIO(), io.StringIO()
    # other tests of this process may have loaded JAX: the run's own check
    # looks only at what the run loads
    loaded = harness.forbidden_loaded
    before = set(loaded())
    harness.forbidden_loaded = lambda: sorted(set(loaded()) - before)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = run.main(["--workload", workload, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", "0"],
                          device="cpu", config=cfg)
    finally:
        harness.forbidden_loaded = loaded
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
