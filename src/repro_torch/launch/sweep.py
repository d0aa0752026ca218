"""Run the dry-run matrix (arch x shape) as isolated subprocesses: the
port's counterpart of the reference's ``launch/sweep.py``.

One cell per process (``python -m repro_torch.launch.dryrun``), so a crash
or an out-of-memory loses only that cell.  The port has one card, so there
is no mesh axis to sweep.  Results land in ``<out-dir>/<arch>_<shape>.json``
plus an aggregate ``all.jsonl``, which a rerun resumes from.  The output
directory is named after the device the cells ran on: the GPU's name
(``results/dryrun_torch/NVIDIA_H100_80GB_HBM3``) or ``meta``.

    python -m repro_torch.launch.sweep --device meta [--only recurrentgemma]
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import subprocess
import sys
import time

ARCHS = [
    "recurrentgemma-2b", "pixtral-12b", "smollm-360m", "gemma-7b",
    "granite-20b", "olmo-1b", "hubert-xlarge", "deepseek-v2-236b",
    "deepseek-moe-16b", "rwkv6-1.6b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
SRC = pathlib.Path(__file__).resolve().parents[2]


def device_dir_name(device: str) -> str:
    """``meta``, ``cpu``, or the name of the CUDA device, made a path."""
    if device in ("meta", "cpu"):
        return device
    import torch
    from repro_torch.launch.mesh import resolve_device
    name = torch.cuda.get_device_name(resolve_device(device))
    return re.sub(r"[^A-Za-z0-9.-]+", "_", name)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-root", default="results/dryrun_torch",
                    help="the device's directory goes under it")
    ap.add_argument("--device", default="cuda",
                    help="meta, cpu or cuda (default)")
    ap.add_argument("--timeout", type=int, default=1200)
    ap.add_argument("--only", default=None, help="arch filter substring")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out_root) / device_dir_name(args.device)
    out_dir.mkdir(parents=True, exist_ok=True)
    agg = out_dir / "all.jsonl"
    done = set()
    if agg.exists():
        for line in agg.read_text().splitlines():
            try:
                r = json.loads(line)
                done.add((r["arch"], r["shape"]))
            except json.JSONDecodeError:
                pass

    cells = [(a, s) for a in ARCHS for s in args.shapes.split(",")]
    for arch, shape in cells:
        if (arch, shape) in done:
            continue
        if args.only and args.only not in arch:
            continue
        tag = f"{arch}_{shape}".replace("-", "_").replace(".", "_")
        cell_json = out_dir / f"{tag}.json"
        t0 = time.time()
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--device", args.device, "--out",
               str(cell_json)]
        env = dict(os.environ)
        env["PYTHONPATH"] = str(SRC) + (os.pathsep + env["PYTHONPATH"]
                                        if env.get("PYTHONPATH") else "")
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=args.timeout, env=env)
            if cell_json.exists():
                rec = json.loads(cell_json.read_text())
            else:
                rec = {"arch": arch, "shape": shape, "status": "error",
                       "reason": (proc.stderr or "")[-400:]}
        except subprocess.TimeoutExpired:
            rec = {"arch": arch, "shape": shape, "status": "timeout",
                   "reason": f">{args.timeout}s"}
        rec["wall_s"] = round(time.time() - t0, 1)
        with open(agg, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"{arch:18s} {shape:12s} {rec['status']:7s} "
              f"{rec['wall_s']:7.1f}s {rec.get('reason', '')[:60]}",
              flush=True)
    return out_dir


if __name__ == "__main__":
    main()
