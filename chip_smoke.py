#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 1.0] [--seed 0]

Phases, one line each, then a kernels line and a last line with the device:

  1. card     ``nvidia-smi`` name and power limit.
  2. build    compile the hand-written CUDA kernels from the checkout's
              sources (``nvcc``, one process per source, started together).
  3. kernels  each kernel against its plain PyTorch version on the card:
              int32 (random, past 2^24, wrapping past 2^31), int64 (past
              2^33, wrapping near 2^62), float32 (exact range), ragged
              vocabs, all-PAD, ids outside the vocab, B > 1.  Integer and
              exact-range float cases must be bit-equal (``torch.equal``).
  4. main     the FCT main path at TPC-H SF1 cardinalities (LINEITEM
              6 001 215, PART 200 000, SUPPLIER 10 000, ORDERS 1 500 000;
              TPC-H spec v3 §4.2.5), text_len 12, vocab 32 768: a cold
              ``FCTSession.query``, two warm ones (0 program builds, 0
              column uploads), a 3-request ``query_batch`` and an int64
              query, every answer bit-equal to the numpy ``fct_star`` +
              ``topk_terms`` oracle, with every kernel launch counter reset
              just before and read just after.  ``--scale`` cuts the row
              counts only.
  5. profile  one more warm query under ``torch.profiler``: device time by
              kernel, fct_count's share, the device's idle share.
  6. timing   each kernel at the main path's largest call (its actual
              inputs): first held against the plain version on those inputs
              (integer dtypes bit-equal; float32, off the main path, runs on
              the int32 call's nonzero-weight mask so every bin stays below
              2^24 and must be bit-equal too), then timed: kernel, plain
              version, one PyTorch library call on prepared inputs, and the
              device-memory bound.

Exits non-zero, printing no result, when there is no CUDA device, when the
package is missing beside this script, or when any phase fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and float32
# operations/s outside the tensor cores, used for scalar adds
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12

SF1_ROWS = {"fact_rows": 6_001_215, "part_rows": 200_000,
            "supp_rows": 10_000, "order_rows": 1_500_000}
VOCAB, TEXT_LEN = 32768, 12

KERNELS = {  # name -> (weight dtype name, TPU kernel it replaces)
    "fct_count_exact_int32": ("int32", "src/repro/kernels/fct_count/kernel.py:170"),
    "fct_count_exact_int64": ("int64", "src/repro/kernels/fct_count/kernel.py:170"),
    "fct_count_float32": ("float32", "src/repro/kernels/fct_count/kernel.py:100"),
}
SOURCE = "src/repro_torch/kernels/fct_count/csrc/fct_count.cu"


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str, t0: float, what: str) -> None:
    print(f"[{name}] {time.perf_counter() - t0:.3f}s {what}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# --- phase 3: each kernel against its plain version --------------------------

def kernel_cases(torch, np, dev):
    """(label, tokens [B, R, L], weights [B, R], vocab, expectation)."""
    rng = np.random.default_rng(1234)
    ranks = np.arange(1, VOCAB, dtype=np.float64) ** -1.1
    zipf = ranks / ranks.sum()

    def text(b, r, l):
        t = rng.choice(np.arange(1, VOCAB), size=(b, r, l), p=zipf)
        t[rng.random((b, r, l)) < 0.1] = 0
        return t.astype(np.int32)

    def w(shape, lo, hi, dtype):
        return rng.integers(lo, hi, shape).astype(dtype)

    cases = [
        ("int32 random", text(1, 20000, 12), w((1, 20000), 0, 1000, np.int32),
         VOCAB, None),
        ("int32 past 2^24", rng.integers(1, 16, (1, 512, 5)).astype(np.int32),
         w((1, 512), 0, 1 << 19, np.int32), 100, "past24"),
        ("int32 wraps past 2^31", np.full((1, 24, 1), 7, np.int32),
         np.full((1, 24), (1 << 27) + 12345, np.int32), 64, "wraps"),
        ("int32 B=3 ids outside vocab", rng.integers(-1, 36, (3, 700, 5))
         .astype(np.int32), w((3, 700), -50, 50, np.int32), 33, None),
        ("int32 ragged vocab 100", rng.integers(0, 103, (2, 333, 7))
         .astype(np.int32), w((2, 333), 0, 9, np.int32), 100, None),
        ("int32 all PAD", np.zeros((2, 64, 4), np.int32),
         np.ones((2, 64), np.int32), 64, "zero"),
        ("int64 past 2^33", rng.integers(1, 50, (1, 300, 3)).astype(np.int32),
         w((1, 300), (1 << 31) - 4, 1 << 35, np.int64), 128, "past33"),
        ("int64 wraps near 2^62", rng.integers(1, 30, (1, 257, 3))
         .astype(np.int32), w((1, 257), 1 << 61, 1 << 62, np.int64), 64,
         None),
        ("int64 B=2 two vocab tiles", text(2, 10000, 12),
         w((2, 10000), 0, 1 << 40, np.int64), VOCAB, None),
        ("float32 exact range", text(1, 20000, 12),
         w((1, 20000), 0, 9, np.float32), VOCAB, "float"),
        ("float32 B=3 ragged vocab 33", rng.integers(-1, 36, (3, 100, 5))
         .astype(np.int32), w((3, 100), 0, 9, np.float32), 33, "float"),
    ]
    for label, t, ww, vocab, expect in cases:
        yield (label, torch.from_numpy(t).to(dev), torch.from_numpy(ww).to(dev),
               vocab, expect)


def run_kernel_cases(torch, np, dev, ops, kernel):
    errs = {name: 0.0 for name in KERNELS}
    lines = []
    for label, t, w, vocab, expect in kernel_cases(torch, np, dev):
        got = ops.weighted_histogram(t, w, vocab)
        want = ops.weighted_histogram(t, w, vocab, backend="ref")
        torch.cuda.synchronize()
        name = kernel.INSTANTIATIONS[w.dtype][1]
        diff = (got.double() - want.double()).abs().max().item()
        errs[name] = max(errs[name], diff)
        check(torch.equal(got, want), f"{label}: kernel != plain "
                                      f"(max abs diff {diff})")
        g = got.cpu()
        if expect == "past24":
            check(int(g.max()) > (1 << 24), f"{label}: did not pass 2^24")
        elif expect == "past33":
            check(int(g.max()) > (1 << 33), f"{label}: did not pass 2^33")
        elif expect == "wraps":
            check(bool((g < 0).any()), f"{label}: no bin wrapped negative")
        elif expect == "zero":
            check(not bool(g.any()), f"{label}: PAD was counted")
        elif expect == "float":
            check(float(g.abs().max()) < 2 ** 24, f"{label}: left the "
                                                   "float32 exact range")
        lines.append(f"{label}: equal")
    return errs, lines


# --- phase 4: the main path ----------------------------------------------------

class Recorder:
    """Wraps the kernel entry point during the main path to keep, per weight
    dtype, the inputs of its largest call (for phase 5's timing).  Launch
    counting stays in the wrapped function."""

    def __init__(self, fn):
        self.fn = fn
        self.largest = {}

    def __call__(self, tokens, weights, vocab):
        key = weights.dtype
        best = self.largest.get(key)
        if best is None or tokens.numel() > best[0].numel():
            self.largest[key] = (tokens, weights, vocab)
        return self.fn(tokens, weights, vocab)


def build_schema(np, args):
    from repro_torch.data.tpch import TpchConfig, generate, plant_keywords
    cfg = TpchConfig(scale=args.scale, text_len=TEXT_LEN, vocab_size=VOCAB,
                     skew=0.0, seed=args.seed, **SF1_ROWS)
    kws = [VOCAB - 3, VOCAB - 2, VOCAB - 1]
    schema = plant_keywords(generate(cfg),
                            {"PART": [kws[0]], "SUPPLIER": [kws[1]],
                             "ORDERS": [kws[2]],
                             "LINEITEM": [kws[0], kws[2]]}, frac=0.3)
    return schema, kws


def check_answer(np, resp, oracle, kws, k, label):
    from repro_torch.core.star import topk_terms
    check(np.array_equal(resp.all_freqs, oracle),
          f"{label}: all_freqs differ from fct_star")
    ids, f = topk_terms(oracle, kws, k)
    check(np.array_equal(resp.term_ids, ids), f"{label}: term_ids differ")
    check(np.array_equal(resp.freqs, f), f"{label}: freqs differ")


def run_main_path(torch, np, args, dev):
    from repro_torch.api import FCTRequest, FCTSession, SessionConfig
    from repro_torch.core.star import fct_star
    from repro_torch.kernels.fct_count import kernel, ops

    t0 = time.perf_counter()
    schema, kws = build_schema(np, args)
    sizes = {r.name: r.rows for r in [schema.fact, *schema.dims]}
    print(f"[main] deployment TPC-H SF1 x scale {args.scale}: rows {sizes}, "
          f"text_len {TEXT_LEN}, vocab {VOCAB}, seed {args.seed}, keywords "
          f"{kws}; generated in {time.perf_counter() - t0:.3f}s", flush=True)
    full = FCTRequest(keywords=tuple(kws), top_k=10, r_max=4)
    subsets = [FCTRequest(keywords=tuple(s), top_k=10, r_max=4)
               for s in ([kws[0], kws[1]], [kws[1], kws[2]],
                         [kws[0], kws[2]])]
    t1 = time.perf_counter()
    oracles = {r.keywords: fct_star(schema, list(r.keywords), 4)
               for r in [full, *subsets]}
    print(f"[main] fct_star oracles for {len(oracles)} keyword sets in "
          f"{time.perf_counter() - t1:.3f}s", flush=True)

    recorder = Recorder(kernel.fct_count)
    kernel.fct_count = recorder
    torch.cuda.reset_peak_memory_stats(dev)
    kernel.reset_launches()
    ops.reset_path_counts()
    try:
        session = FCTSession(schema, device=dev)
        resps = [("cold", session.query(full))]
        resps += [(f"warm{i}", session.query(full)) for i in (1, 2)]
        batch = session.query_batch(subsets)
        session64 = FCTSession(schema, device=dev,
                               config=SessionConfig(accum_policy="int64"))
        resp64 = session64.query(full)
        torch.cuda.synchronize(dev)
    finally:
        kernel.fct_count = recorder.fn
    launches = dict(kernel.LAUNCHES)
    paths = dict(ops.PATH_COUNTS)

    for label, r in resps:
        check_answer(np, r, oracles[full.keywords], kws, 10, label)
        t = r.timings
        print(f"[main] query {label}: plan_ms {t['plan_ms']} dispatch_ms "
              f"{t['dispatch_ms']} collect_ms {t['collect_ms']} total_ms "
              f"{t['total_ms']} builds {r.engine_stats['traces']} uploads "
              f"{r.engine_stats['store_uploads']} CNs {r.n_cns} (joined "
              f"{r.n_joined_cns}) shuffle_bytes {r.shuffle_bytes}",
              flush=True)
    for label, r in resps[1:]:
        check(r.engine_stats["traces"] == 0, f"{label}: built programs")
        check(r.engine_stats["store_uploads"] == 0,
              f"{label}: uploaded columns")
    for req, r in zip(subsets, batch):
        check_answer(np, r, oracles[req.keywords], list(req.keywords), 10,
                     f"batch {req.keywords}")
    t = batch[0].timings
    print(f"[main] query_batch x{len(batch)}: plan_ms "
          f"{[r.timings['plan_ms'] for r in batch]} dispatch_ms "
          f"{t['dispatch_ms']} collect_ms {t['collect_ms']} batches "
          f"{batch[0].engine_stats['batches_run']} for "
          f"{batch[0].engine_stats['cns_run']} CNs", flush=True)
    check_answer(np, resp64, oracles[full.keywords], kws, 10, "int64")
    check(resp64.accum_policy == "int64-exact", "int64 policy not applied")
    t = resp64.timings
    print(f"[main] query int64: plan_ms {t['plan_ms']} dispatch_ms "
          f"{t['dispatch_ms']} collect_ms {t['collect_ms']}", flush=True)
    check(launches["fct_count_exact_int32"] > 0, "int32 kernel never ran")
    check(launches["fct_count_exact_int64"] > 0, "int64 kernel never ran")
    check(paths["ref"] == 0, f"plain version ran on the main path: {paths}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[main] launches {launches} paths {paths} device_peak_bytes "
          f"{peak} store_bytes {session.store.resident_bytes} + "
          f"{session64.store.resident_bytes}", flush=True)
    return launches, recorder.largest, session, full


# --- phase 5: where one warm query's device time goes -------------------------

def profile_warm_query(torch, session, req) -> str:
    """One more warm query under ``torch.profiler``: device time by kernel
    name, fct_count's share of it, and the device's busy share of the
    query's wall time (host clock up to a synchronize)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.query(req)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        # device-side copies of record_function ranges span whole programs:
        # only kernels and copies count
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            r = e.time_range
            spans.append((r.start, r.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + r.elapsed_us() / 1e3
    if not spans:
        return (f"wall_ms {wall_ms:.3f}; device time not measured (the "
                "profiler saw no device events)")
    busy_ms, end = 0.0, float("-inf")
    for s, e in sorted(spans):       # union of the device intervals, in us
        busy_ms += max(0.0, e - max(s, end)) / 1e3
        end = max(end, e)
    device_ms = sum(by_name.values())
    count_ms = sum(v for k, v in by_name.items() if "fct_count_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return (f"wall_ms {wall_ms:.3f} device_busy_ms {busy_ms:.3f} (idle share "
            f"{1 - busy_ms / wall_ms:.4f}) device_ms {device_ms:.3f} "
            f"fct_count_ms {count_ms:.3f} (share {count_ms / device_ms:.4f});"
            " top: " + "; ".join(f"{k[:70]} {v:.3f}ms" for k, v in top))


# --- phase 6: timing -----------------------------------------------------------

def median_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def compare_at_shape(torch, ops, name, tokens, weights, vocab):
    """The kernel against its plain version on one main-path call's inputs:
    bit-equal, for every instantiation (float32 inputs stay below 2^24)."""
    got = ops.weighted_histogram(tokens, weights, vocab)
    want = ops.weighted_histogram(tokens, weights, vocab, backend="ref")
    torch.cuda.synchronize()
    if weights.dtype.is_floating_point:
        check(float(want.abs().max()) < 2 ** 24,
              f"{name}: main-path shape left the float32 exact range")
    err = (got.double() - want.double()).abs().max().item()
    check(torch.equal(got, want), f"{name} at shape "
          f"{list(tokens.shape)} vocab {vocab}: kernel != plain (max abs "
          f"diff {err})")
    del got, want
    torch.cuda.empty_cache()
    return err


def time_kernel(torch, ops, tokens, weights, vocab):
    B, R, L = tokens.shape
    w_item = weights.element_size()
    ms = median_ms(torch, lambda: ops.weighted_histogram(tokens, weights,
                                                         vocab))
    plain = median_ms(torch, lambda: ops.weighted_histogram(
        tokens, weights, vocab, backend="ref"))
    # the library yardstick: one index_add_ over prepared flat inputs (PAD
    # and out-of-range masking done beforehand, outside the timing)
    tok = tokens.reshape(B, R * L).long()
    keep = (tok != 0) & (tok >= 0) & (tok < vocab)
    idx = (torch.where(keep, tok, 0)
           + torch.arange(B, device=tok.device)[:, None] * vocab).reshape(-1)
    wflat = torch.where(keep, weights[:, :, None].expand(B, R, L)
                        .reshape(B, R * L), 0).reshape(-1)
    lib = median_ms(torch, lambda: torch.zeros(
        B * vocab, dtype=weights.dtype, device=tokens.device).index_add_(
            0, idx, wflat))
    nbytes = B * R * L * 4 + B * R * w_item + B * vocab * w_item
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = B * R * L / PEAK_SCALAR_OPS_PER_S * 1e3
    return {"ms": ms, "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "shape": [B, R, L, vocab]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiplies the SF1 row counts (default 1.0)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port is missing ({SRC / 'repro_torch'})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.fct_count import kernel, ops
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    phase("card", t0, f"{torch.cuda.get_device_name(0)}, torch "
                      f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    kernel.build()
    phase("build", t0, f"{SOURCE} -> {kernel.library_path().name}, nvcc "
                       f"{kernel.BUILD_SECONDS:.3f}s")

    t0 = time.perf_counter()
    errs, lines = run_kernel_cases(torch, np, dev, ops, kernel)
    phase("kernels", t0, f"{len(lines)} cases bit-equal to the plain "
                         f"version: {'; '.join(lines)}")

    t0 = time.perf_counter()
    launches, largest, session, req = run_main_path(torch, np, args, dev)
    phase("main", t0, "every answer bit-equal to fct_star/topk_terms; "
                      "warm queries built 0 programs and uploaded 0 columns")

    t0 = time.perf_counter()
    phase("profile", t0, profile_warm_query(torch, session, req))

    t0 = time.perf_counter()
    report = []
    for name, (dtype_name, replaces) in KERNELS.items():
        dtype = getattr(torch, dtype_name)
        if dtype in largest:
            tokens, weights, vocab = largest[dtype]
        else:   # off the main path: the int32 path's largest call, with its
            # nonzero-weight mask as weights so every bin stays below 2^24
            tokens, weights, vocab = largest[torch.int32]
            weights = (weights != 0).to(dtype)
        err = compare_at_shape(torch, ops, name, tokens, weights, vocab)
        # "equal"/"max_abs_err" hold at this entry's shape; the small cases
        # of phase 3 are reported beside them
        entry = {"name": name, "route": "cuda", "source": SOURCE,
                 "replaces": replaces, "launches": launches[name],
                 "equal": err == 0.0, "max_abs_err": err,
                 "cases_max_abs_err": errs[name], "tolerance": 0}
        entry.update(time_kernel(torch, ops, tokens, weights, vocab))
        report.append(entry)
    phase("timing", t0, "each kernel bit-equal to its plain version at the "
                        "main path's largest call per dtype, then the median "
                        "of 20 CUDA-event timings after 3 warm-up calls")
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
