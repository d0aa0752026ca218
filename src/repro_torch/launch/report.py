"""Render the dry-run's tables from a sweep's ``all.jsonl``: the port's
counterpart of the reference's ``launch/report.py``.

    python -m repro_torch.launch.report results/dryrun_torch/meta/all.jsonl \\
        [roofline|dryrun|summary]

The reference's two tables, for one card: ``roofline`` (the terms on one
NVIDIA H100, bottleneck, fraction, GB held, useful ratio) and ``dryrun``
(status, record seconds, argument GB on one card and per device of the
reference's meshes, peak GB, fits).  A record measured on a card adds its
columns: wall ms, ``max_memory_allocated`` and the achieved fraction.
``summary`` is one row an architecture: each shape's counts, bound,
fraction and fit, and the seconds its record took.
"""
from __future__ import annotations

import json
import sys

ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def load(path):
    seen = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            seen[(r["arch"], r["shape"])] = r   # keep the last per cell
    return sorted(seen.values(),
                  key=lambda r: (r["arch"], ORDER.get(r["shape"], 9)))


def _measured(r) -> str:
    m = r.get("measured")
    if not m:
        return "— | — | —"
    frac = m.get("achieved_fraction")
    return (f"{m['wall_ms']:.3f} | "
            f"{m.get('max_memory_allocated', 0) / 1e9:.2f} | "
            f"{'—' if frac is None else f'{frac:.4f}'}")


def roofline_table(recs) -> str:
    lines = ["| arch | shape | comp s | mem s | coll s | bottleneck | frac "
             "| GB/dev | useful | wall ms | card GB | achieved |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] == "skip":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skipped: {r['reason']} | — | — | — | — | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"{r['status'].upper()} | — | — | — | — | — | — |")
            continue
        rf = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.4g} | "
            f"{rf['memory_s']:.4g} | {rf['collective_s']:.3g} | "
            f"{rf['bottleneck']} | {r['roofline_fraction']:.4f} | "
            f"{rf['per_device_memory_gb']:.1f} | {rf['useful_ratio']:.3f} | "
            f"{_measured(r)} |")
    return "\n".join(lines)


def dryrun_table(recs) -> str:
    lines = ["| arch | shape | status | record s | args GB | args GB/dev "
             "16x16 | args GB/dev 2x16x16 | peak GB | fits one card |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['status']}: "
                         f"{r.get('reason', '')[:50]} | — | — | — | — | — "
                         f"| — |")
            continue
        per = r["arg_bytes_per_dev"]
        fits = "yes" if r["fits_one_card"] else f"no: {r['fits_reason']}"
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['record_s']:.2f} | "
            f"{r['arg_bytes'] / 1e9:.2f} | {per['16x16'] / 1e9:.3f} | "
            f"{per['2x16x16'] / 1e9:.3f} | "
            f"{r['counts']['peak_bytes'] / 1e9:.2f} | {fits} |")
    return "\n".join(lines)


def summary_table(recs) -> str:
    """One row an architecture, one column a shape: FLOPs, bytes, peak GB
    (the call's) + argument GB, the bound's term, the fraction, fits."""
    cells = {(r["arch"], r["shape"]): r for r in recs}
    shapes = sorted({r["shape"] for r in recs}, key=lambda n: ORDER.get(n, 9))
    lines = ["| arch | " + " | ".join(shapes) + " |",
             "|---|" + "---|" * len(shapes)]
    for arch in sorted({r["arch"] for r in recs}):
        row = []
        for shape in shapes:
            r = cells.get((arch, shape))
            if r is None or r["status"] != "ok":
                row.append("—" if r is None else r["status"])
                continue
            rf = r["roofline"]
            row.append(f"{rf['flops']:.3g} F, {rf['hbm_bytes']:.3g} B, "
                       f"{r['counts']['peak_bytes'] / 1e9:.4g}+"
                       f"{r['arg_bytes'] / 1e9:.4g} GB, {rf['bottleneck']}, "
                       f"{r['roofline_fraction']:.4f}, "
                       f"{'fits' if r['fits_one_card'] else 'no'}, "
                       f"{r['record_s']:.2f} s")
        lines.append(f"| {arch} | " + " | ".join(row) + " |")
    return "\n".join(lines)


TABLES = {"roofline": roofline_table, "dryrun": dryrun_table,
          "summary": summary_table}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    recs = load(argv[0])
    print(TABLES[argv[1] if len(argv) > 1 else "roofline"](recs))


if __name__ == "__main__":
    main()
