"""One-card dry-run: the port's counterpart of the reference's
``launch/dryrun.py``.

For one (arch x shape) cell: build the parameters, AdamW state, cache and
batch on the ``meta`` device (nothing allocated), count one call of the
cell's step on them (``launch/op_analysis.py``: FLOPs, bytes, peak live
bytes, the virtual mesh's collectives), and write the roofline terms of one
NVIDIA H100 (``launch/roofline.py``) as JSON.  The reference compiles each
cell for a 256- or 512-device TPU mesh and reads XLA's memory analysis; the
port has one card and no compiler, so the record holds:

    status              ok, skip (the reference's reasons,
                        ``configs/base.py::cell_is_runnable``) or error
    params_*            the reference's ``count_params``: total, active
                        (routed experts at top_k / n_experts), matmul
    arg_bytes           parameters, optimizer state, cache and batch on one
                        card, by part
    arg_bytes_per_dev   the same per device of the reference's meshes
                        (16x16, 2x16x16), computed from the spec trees of
                        ``distributed/sharding.py``, not compiled
    counts              the counter's flops, bytes, peak_bytes, ops,
                        flops_by_loop, collectives
    roofline, roofline_fraction
    fits_one_card       arguments plus the peak below 80 GB, else the
                        reason in ``fits_reason``

With ``--device cuda`` (the default) a cell that fits also runs on the card:
its parameters from ``--seed``, one call as a warm-up under
``FlopCounterMode``, then one timed call.  ``measured`` holds
``max_memory_allocated`` (above what was allocated before the cell was
built), the wall time, the achieved share
``model_flops / (wall x 989e12)`` beside the predicted
``roofline_fraction``, the kernel launches of the timed call, and two
checks against the meta record: the argument bytes of the same tensors on
the card, and the matrix products' FLOPs.  The hand-written kernels launch
through ctypes, where ``FlopCounterMode`` does not see them, so the FLOPs
compare with attention and the scan taken out on both sides (the meta
side's ``flops_by_loop`` of their plain versions).  A cell that cannot build
or launch a kernel fails; it does not become a meta-only record.
``--device meta`` gives the record alone and needs no card; ``--device
cpu`` measures on the host (plain versions, no share of a device peak).

``--batch``/``--seq`` cut a cell's shape; the cuts are listed in the
record's ``reduced``.  The reference's ``make_production_mesh`` has no
counterpart on one card (``distributed/sharding.py``).

Usage:
    python -m repro_torch.launch.dryrun --arch recurrentgemma-2b \\
        --shape decode_32k [--device meta] [--out cell.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      cell_is_runnable, get_arch)
from repro_torch.distributed import sharding as sh
from repro_torch.launch import op_analysis
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.step import make_serve_step, make_train_step

#: the loops whose plain versions the card replaces by a ctypes kernel
KERNEL_LOOPS = ("flash_attention", "lru_scan")


def input_specs(cfg: ArchConfig, shape_name: str, device="meta",
                shape: Optional[ShapeConfig] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
    """The cell's model inputs with the reference's shapes and dtypes: on
    ``meta`` empty, elsewhere drawn from ``generator`` (token ids uniform
    over the vocab, frames and patches N(0, 1)).  ``shape`` overrides
    ``SHAPES[shape_name]`` (a cut)."""
    shape = shape or SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    dev = torch.device(device)

    def ids(*size):
        if dev.type == "meta":
            return torch.empty(size, dtype=torch.int32, device=dev)
        return torch.randint(0, cfg.vocab_size, size, generator=generator,
                             device=generator.device).to(dev, torch.int32)

    def floats(*size):
        if dev.type == "meta":
            return torch.empty(size, dtype=torch.float32, device=dev)
        return torch.randn(size, generator=generator,
                           device=generator.device).to(dev)

    if shape.kind == "decode":
        return {"tokens": ids(b, 1),
                "pos": torch.full((), s - 1, dtype=torch.int32, device=dev)}
    if cfg.frontend == "frame":
        return {"frames": floats(b, s, cfg.frontend_dim),
                "labels": ids(b, s)}
    if cfg.frontend == "patch":
        n_patch = max(1, s // cfg.patch_frac)
        return {"patches": floats(b, n_patch, cfg.frontend_dim),
                "tokens": ids(b, s - n_patch), "labels": ids(b, s - n_patch)}
    return {"tokens": ids(b, s), "labels": ids(b, s)}


def count_params(cfg: ArchConfig, params: Optional[model_lib.LM] = None):
    """(total, active, matmul_active) parameter counts of ``params`` (by
    default built on meta); the reference's rule over the port's parameter
    names (the reference's tree paths, ``models/convert.py``)."""
    if params is None:
        params = model_lib.init_params(cfg, "meta")
    total = active = matmul = 0
    for name, p in params.named_parameters():
        n = p.numel()
        names = name.split(".")
        total += n
        routed = (cfg.n_experts > 0 and "ffn" in names
                  and any(d == cfg.n_experts for d in p.shape)
                  and "shared" not in names and "router" not in names)
        a = n * (cfg.moe_top_k / cfg.n_experts) if routed else n
        active += a
        is_table = "table" in names or "pos_embed" in names
        if not is_table or cfg.tie_embeddings:
            matmul += a
    return total, active, matmul


def model_flops(cfg: ArchConfig, shape: ShapeConfig,
                matmul_params: float) -> float:
    if shape.kind == "train":
        return 6.0 * matmul_params * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * matmul_params * shape.global_batch * shape.seq_len
    return 2.0 * matmul_params * shape.global_batch  # decode: one token


@dataclasses.dataclass
class Cell:
    """A cell's arguments on one device and its step as a closure."""
    args: Dict[str, object]      # params, opt, cache, batch (those it has)
    call: Callable[[], object]


def _nbytes(tree) -> int:
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def build_cell(cfg: ArchConfig, shape: ShapeConfig, device,
               seed: int = 0) -> Cell:
    """The cell's arguments on ``device`` (``meta``: nothing allocated;
    elsewhere random from ``seed``) and its step: ``serve_step`` at the
    last position for decode, ``forward``'s logits under inference for
    prefill, one ``make_train_step`` step for train."""
    dev = resolve_device(device)
    params = model_lib.init_params(cfg, dev, seed=seed)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed + 1)
    batch = input_specs(cfg, shape.name, dev, shape, gen)
    if shape.kind == "decode":
        cache = model_lib.init_cache(cfg, shape.global_batch, shape.seq_len,
                                     dev)
        step = make_serve_step(cfg)
        pos = shape.seq_len - 1
        return Cell({"params": params, "cache": cache, "batch": batch},
                    lambda: step(params, cache, batch["tokens"], pos))
    if shape.kind == "prefill":
        inputs = {k: v for k, v in batch.items() if k != "labels"}

        def prefill():
            with torch.inference_mode():
                return model_lib.forward(params, inputs, cfg)[0]
        return Cell({"params": params, "batch": batch}, prefill)
    params.requires_grad_(True)
    opt = init_opt_state(dict(params.named_parameters()))
    step = make_train_step(cfg)
    return Cell({"params": params, "opt": opt, "batch": batch},
                lambda: step(params, opt, batch)[2])


def per_device_bytes(cfg: ArchConfig, cell: Cell) -> Dict[str, int]:
    """Argument bytes per device of each reference mesh, from the specs."""
    out = {}
    for name, (mesh, dp) in sh.MESHES.items():
        rules = sh.ShardingRules(dp=dp)
        pspecs = sh.param_specs(cfg, rules)
        named = dict(cell.args["params"].named_parameters())
        total = sh.bytes_per_device(pspecs, named, mesh)
        if "opt" in cell.args:
            total += sh.bytes_per_device(sh.opt_specs(pspecs),
                                         cell.args["opt"], mesh)
        if "cache" in cell.args:
            total += sh.bytes_per_device(sh.cache_specs(cfg, rules),
                                         cell.args["cache"], mesh)
        batch = cell.args["batch"]
        specs = dict(sh.batch_specs(cfg, rules), pos=())
        total += sh.bytes_per_device({k: specs[k] for k in batch}, batch,
                                     mesh)
        out[name] = total
    return out


def cell_shape(shape_name: str, batch: Optional[int] = None,
               seq: Optional[int] = None):
    """The cell's ``ShapeConfig``, cut to ``batch``/``seq``, and the list
    of cuts."""
    shape = SHAPES[shape_name]
    reduced: List[str] = []
    if batch is not None and batch != shape.global_batch:
        reduced.append(f"B {batch} (from {shape.global_batch})")
        shape = dataclasses.replace(shape, global_batch=batch)
    if seq is not None and seq != shape.seq_len:
        reduced.append(f"S {seq} (from {shape.seq_len})")
        shape = dataclasses.replace(shape, seq_len=seq)
    return shape, reduced


def meta_record(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The record of one runnable cell, built and counted on meta."""
    t0 = time.perf_counter()
    cell = build_cell(cfg, shape, "meta")
    arg_bytes = {k: _nbytes(v) for k, v in cell.args.items()}
    _, counts = op_analysis.count(cell.call)
    total, active, matmul = count_params(cfg, cell.args["params"])
    mf = model_flops(cfg, shape, matmul)
    held = sum(arg_bytes.values()) + counts.peak_bytes
    roof = rl.analyze(counts, mf, held)
    fits = held < rl.HBM_BYTES
    return {
        "params_total": total, "params_active": active,
        "params_matmul": matmul, "model_flops": mf,
        "arg_bytes": sum(arg_bytes.values()), "arg_bytes_by_part": arg_bytes,
        "arg_bytes_per_dev": per_device_bytes(cfg, cell),
        "counts": counts.to_dict(),
        "roofline": roof.to_dict(),
        "roofline_fraction": rl.roofline_fraction(roof),
        "fits_one_card": fits,
        "fits_reason": "" if fits else (
            f"arguments {sum(arg_bytes.values()) / 1e9:.1f} GB + peak "
            f"{counts.peak_bytes / 1e9:.1f} GB = {held / 1e9:.1f} GB > "
            f"{rl.HBM_BYTES / 1e9:.0f} GB"),
        "record_s": time.perf_counter() - t0,
    }


def _launches() -> Dict[str, int]:
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.lru_scan import kernel as lru_kernel
    return {k: v for lib in (flash_kernel.LIB, lru_kernel.LIB)
            for k, v in lib.launches.items()}


def measure(cfg: ArchConfig, shape: ShapeConfig, rec: dict, device,
            seed: int = 0) -> dict:
    """Runs the cell on ``device`` (CUDA or CPU) and holds it against its
    meta record ``rec``."""
    from torch.utils.flop_counter import FlopCounterMode
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    cell = build_cell(cfg, shape, dev, seed)
    arg_bytes = sum(_nbytes(v) for v in cell.args.values())
    with FlopCounterMode(display=False) as fc:      # the warm-up call
        cell.call()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = _launches()
    t0 = time.perf_counter()
    cell.call()
    sync()
    wall = time.perf_counter() - t0
    after = _launches()
    counts = rec["counts"]
    kernel_loops = KERNEL_LOOPS if cuda else ()
    meta_flops = counts["flops"] - sum(counts["flops_by_loop"].get(k, 0.0)
                                       for k in kernel_loops)
    out = {
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "arg_bytes": arg_bytes, "arg_bytes_equal": arg_bytes == rec["arg_bytes"],
        "flops": fc.get_total_flops(), "meta_flops": meta_flops,
        "flops_equal": fc.get_total_flops() == meta_flops,
        "flops_compared": ("without " + ", ".join(kernel_loops)
                           if kernel_loops else "all"),
        "wall_ms": wall * 1e3,
        "launches": {k: after[k] - before[k] for k in after
                     if after[k] != before[k]},
    }
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev) - base
        out.update({
            "max_memory_allocated": peak,
            "allocated_before": base,
            "meta_held_over_card": (rec["arg_bytes"]
                                    + counts["peak_bytes"]) / peak,
            "achieved_fraction": rec["model_flops"]
            / (wall * rl.PEAK_BF16_FLOPS),
            "predicted_fraction": rec["roofline_fraction"]})
    return out


def run_cell(arch: str, shape_name: str, device="cuda",
             batch: Optional[int] = None, seq: Optional[int] = None,
             seed: int = 0, verbose: bool = True) -> dict:
    cfg = get_arch(arch)
    shape, reduced = cell_shape(shape_name, batch, seq)
    ok, reason = cell_is_runnable(cfg, SHAPES[shape_name])
    rec = {"arch": arch, "shape": shape_name, "mesh": "1 card",
           "device": "meta", "reduced": reduced,
           "status": "skip", "reason": reason}
    if not ok:
        return rec
    rec.update(meta_record(cfg, shape))
    rec["status"] = "ok"
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    if dev.type != "meta" and rec["fits_one_card"]:
        rec["measured"] = measure(cfg, shape, rec, dev, seed)
        rec["device"] = rec["measured"]["device"]
    if verbose:
        rf = rec["roofline"]
        print(f"[{arch} {shape_name}{' ' + ', '.join(reduced) if reduced else ''}] "
              f"flops={rf['flops']:.4e} bytes={rf['hbm_bytes']:.4e} "
              f"peak={rec['counts']['peak_bytes'] / 1e9:.2f}GB "
              f"args={rec['arg_bytes'] / 1e9:.2f}GB "
              f"bottleneck={rf['bottleneck']} "
              f"frac={rec['roofline_fraction']:.4f} "
              f"fits={rec['fits_one_card']} "
              f"record={rec['record_s']:.2f}s", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--device", default="cuda",
                    help="meta (the record alone), cuda (default: also run "
                         "a cell that fits on the card) or cpu")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the shape's global batch")
    ap.add_argument("--seq", type=int, default=None,
                    help="cut the shape's sequence length")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    try:
        rec = run_cell(args.arch, args.shape, args.device, args.batch,
                       args.seq, args.seed)
    except Exception as e:  # noqa: BLE001 — recorded as a failed cell
        traceback.print_exc()
        rec = {"arch": args.arch, "shape": args.shape, "mesh": "1 card",
               "device": args.device, "status": "error",
               "reason": f"{type(e).__name__}: {e}"}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if k != "roofline"}))
    return 0 if rec["status"] in ("ok", "skip") else 1


if __name__ == "__main__":
    sys.exit(main())
