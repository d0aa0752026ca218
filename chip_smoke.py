#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 1.0] [--seed 0]

Phases, one line each, then a kernels line and a last line with the device:

  1. card       ``nvidia-smi`` name and power limit.
  2. build      compile the hand-written CUDA kernels from the checkout's
                sources (``nvcc``, one process per source, started
                together): fct_count, flash_attention and lru_scan (each
                LM source holds its backward kernel too).
     build_report  ptxas's registers and spills of each kernel (fct_count,
                flash_attention, lru_scan), and the HMMA (tensor-core)
                instructions ``cuobjdump -sass`` finds in each: every bf16
                flash instantiation, forward and backward (dK/dV and dQ),
                must have some, the float32 ones none; no bf16 backward
                instantiation may spill registers.
  3. kernels    each kernel against its plain PyTorch version on the card.
                fct_count: int32 (random, past 2^24, wrapping past 2^31),
                int64 (past 2^33, wrapping near 2^62), float32 (exact
                range), ragged vocabs, all-PAD, ids outside the vocab,
                B > 1; integer and exact-range float cases bit-equal
                (``torch.equal``).  flash_attention: D in {16, 32, 64, 80,
                128, 192, 256}, GQA (15/5 too), MQA, Dv != D (192/128 and
                16/8 among them), encoder (non-causal), windows with S >
                window and a window that is no multiple of the tile, ragged
                S, causal with no window at S 1 100, float32 within 2e-5 and bfloat16 within 4e-2 (the
                reference's tolerances).  lru_scan: float32 within 1e-5,
                bfloat16 within 4e-2, at the chunk (128 steps) and tile (64
                / 128 channels) edges: S in {1, 127, 128, 129, 8 229}, W in
                {5, 127, 129, 2 560}, B 1 and 3, views off a 16-byte
                boundary, a long-memory input (a in [0.999, 1), S 8 192).
                On every flash and lru_scan case also the backward kernel
                against the plain version's autograd on the card: flash
                float32 within 1e-4 of each gradient's max |g|, bf16 within
                4e-2 + 4e-2 |g|; lru_scan float32 within 1e-5 max|g| +
                1e-5 |g|, bf16 4e-2 + 4e-2 |g|; two backward calls
                bit-equal.
  4. main       the FCT main path at TPC-H SF1 cardinalities (LINEITEM
                6 001 215, PART 200 000, SUPPLIER 10 000, ORDERS 1 500 000;
                TPC-H spec v3 §4.2.5), text_len 12, vocab 32 768: a cold
                ``FCTSession.query``, two warm ones (0 program builds, 0
                column uploads), a 3-request ``query_batch`` and an int64
                query, every answer bit-equal to the numpy ``fct_star`` +
                ``topk_terms`` oracle, with every kernel's launch count
                reset just before and read just after.  ``--scale`` cuts the
                row counts only.
  5. profile    one more warm query under ``torch.profiler``: device time by
                kernel, fct_count's share, the device's idle share (the
                prefill of phase 10 is profiled the same way).
  6. fct_timing each fct_count instantiation at the main path's largest call
                (its actual inputs): held against the plain version on those
                inputs (bit-equal), then timed: kernel, plain version, one
                ``index_add_`` on prepared inputs, the kernel on controls of
                the same shape (uniform tokens: no hot bins; every weight 1:
                every token read; both), and the byte bound of what the inputs need (weights, the tokens
                of rows whose weight is not 0, the output) beside the padded
                bound that reads every token; the share of zero-weight rows.
  7. serve      the serving path on phase 4's deployment: a ``Gateway`` over a
                ``SchemaRegistry`` of two tenants (``tpch``: phase 4's schema
                as is, int32 policy; ``demo``: ``repro_torch.data.demo``),
                batch window 5 ms, result-cache TTL 3 600 s, ``patch``
                appends.  Burst 1: the full keyword set and one 2-keyword
                subset to tpch, each twice while in flight (coalescing), and
                four demo queries; every tpch answer bit-equal to the
                oracle.  Burst 2: the same stream, all cache hits, no engine
                batch; a different top_k re-sliced from the cache.  One
                uncached query on the warm session through a second,
                cache-less gateway, under ``torch.profiler``.  Append:
                60 012 LINEITEM rows (1%), keys and tokens from
                ``data/tpch.py``'s distributions and ``--seed``, keywords
                planted as in phase 4; the patched hits equal ``fct_star``
                on the appended schema; the first query after it (through
                the session) re-plans, builds 0 programs and assembles the
                chunked columns on the device, and only the new chunk's
                rows were uploaded.  ``invalidate`` and a re-query: equal to
                the oracle, 0 programs built.  A ``device_topk`` session:
                the same top-k from an O(k) transfer.  Then ``python -m
                repro_torch.launch.fct_serve --smoke --device cuda`` in
                process, to its ``SMOKE OK``.  Each path (burst 1, burst 2,
                the uncached query, append + ``delta_freq``, the first
                post-append query, the re-query, the device top-k queries,
                the launcher smoke) runs with every count set to 0 just
                before it and read just after: fct_count int32 launched in
                each but burst 2, which launched nothing, and no
                plain-version call; each path's count goes into the kernels
                line as ``<path>_launches``.
 7b. analysis   the port's invariant checks (``repro_torch.analysis``):
                the AST lint (R1-R5) over ``src/repro_torch``, 0 violations,
                its waivers listed; the runtime contracts (C1-C4) over the
                three FCT program families at P 1 and 8 under both policies
                on the card, 0 failures, inside ``counted`` (both integer
                fct_count instantiations launched, no plain-version call;
                ``analysis_launches`` in the kernels line); then
                ``examples/quickstart_torch.py`` and
                ``examples/fct_query_expansion_torch.py`` as subprocesses
                with no ``--device`` (so on the card), each one's top terms
                equal to ``topk_terms(fct_star(...))`` on
                ``data/demo.py``'s database.
  8. pipeline   the warm full query 8 times through ``FCTSession.submit``
                on phase 4's session: FIFO, every answer equal to the
                oracle; the burst's wall time against 8 sequential
                ``query`` calls, and the device's idle share over one more
                burst (``torch.profiler``, as phase 5).  The counts are set
                to 0 just before the submit burst and read just after it
                (``pipeline_submit_launches``).
  9. engine_paths  the engine's other paths on phase 4's deployment and
                its full query's joined-CN plans (P 1, int32): storeless
                calls (``FCTEngine().run_plans`` and
                ``run_plans_individual`` with no store, each uploading the
                columns to a store of its own), bit-equal to ``fct_star``
                and to the session store's ``run_plans`` (which uploads no
                column), their column upload bytes and wall times;
                ``run_cn_plan_two_jobs`` on the largest joined
                two-dimension CN, without and with a checkpoint in a
                temporary directory (its size, save and restore times),
                each bit-equal to that CN's ``run_plans_individual`` row;
                one storeless int64 ``run_plans``.  Then P 8 on the same
                generator at 0.05 of SF1's cardinalities (cut: on the host of
                an H100 machine one cold P 8 plan of the planted triple at
                SF1, Zipf z 1 keys, takes 26.5 s in uniform mode and 29.0 s
                in adaptive mode, against 20.2 s at P 1, and this phase
                plans four modes on three engines): modes
                uniform, skew, round_robin and adaptive (rho 4) by
                ``query`` and ``query_batch`` through sessions on
                ``FCTEngine()``, ``FCTEngine(reduce_scatter=False)`` and
                ``FCTEngine(batch=False, bucket=False)``, each engine's
                storeless ``run_plans`` too, device top-k under psum,
                and ``run_fct_query`` equal to the session's answer; every
                answer bit-equal to ``fct_star``.  Each path (``batched``,
                ``batched_percn``, ``two_jobs``, ``two_jobs_ckpt``,
                ``batched_int64``, ``p8_modes``) runs inside ``counted``:
                its fct_count kernel launched, no plain-version call, and
                its count goes into the kernels line as
                ``<path>_launches``.
 10. lm_prefill recurrentgemma-2b (arXiv:2402.19427) at full width and
                depth in bf16, random weights from ``--seed``: one prefill
                ``forward`` of B 1 x S 8 192 tokens (cut from the dry-run's
                prefill_32k, B 32 x S 32 768, whose float32 logits alone
                would take 1.07 TB), every count reset just before and read
                just after: one flash_attention launch per local layer (8),
                one lru_scan launch per rglru layer (18), no plain-version
                call.  Keeps the first local layer's attention inputs and
                the first rglru layer's scan inputs.
  11. lm_decode  the same model in float32: ``forward`` of B 1 x S 2 304
                (flash, since S >= 1 024; past the 2 048 window, so the
                decode ring buffer wraps) against token-by-token
                ``decode_step``: max abs logit error below 5e-3, top-1 ids
                equal wherever the forward's top-2 margin exceeds 1e-2.
  12. lm_serve   ``python -m repro_torch.launch.serve --arch
                recurrentgemma-2b --full --batch 4 --prompt-len 12
                --gen-len 24``, in process: tokens/s.
 13. lm_timing  flash_attention and lru_scan on the inputs kept in phase 10:
                held against their plain versions there (flash in bf16 by
                the one rounding both sides share: |kernel - plain| <=
                2^-7 |plain| + 2^-8 mean|plain|; lru_scan within 1e-5 and
                two calls bit-equal), then timed: kernel, plain version,
                ``scaled_dot_product_attention`` with the same band mask
                (flash only; no single PyTorch call computes the
                recurrence), and the bound; every ``ms`` one call (host
                launch overhead included).  lru_scan also reports
                ``per_call_ms``, a call of 20 back to back, its GB/s and
                share of 3.35 TB/s both ways, the chunk and tile the built
                library reports, two controls (B 4 x S 8 192 of the same
                width, and a long-memory input: a in [0.999, 1)), and one
                ``torch.add`` of a and b, which moves the same bytes.  Then
                the backward kernels on lm_train's first backward inputs
                (the last local layer's q, k, v, o, lse, dO; the last rglru
                layer's a, h, dh): held to their plain versions, two calls
                bit-equal.  K3b with dO brought to a unit max by a power of
                two: against its own formula in dense float32 (each of dq,
                dk, dv within 2^-8 |dense| + 1e-4 max|dense|, a limit that
                zeros and the band cut by 32 keys must break in each), and
                through autograd against the plain version's (2^-7 |plain|
                + 2^-7 max|plain|); K4b against the plain loop run
                backwards within 1e-5 max|g| + 1e-5 |g|.  Then timed beside
                the bound (K3b: the band's backward operations, 2.5 x the
                forward's, at the bf16 peak; K4b: 5 B*S*W elements at 3.35
                TB/s), the plain versions' backward
                and ``scaled_dot_product_attention``'s backward (each
                forward + backward minus its forward), launches per train
                step.  K3b's entry also names its bf16 design, what it
                launches there (head splits, grids, blocks an SM), ptxas's
                registers and spills of the two instantiations it runs, the
                CUDA-core design's time on the same card (the float32
                kernels on float32 copies of the inputs) and the parent's
                time cited from PERF.md.  Then flash_attention and its
                backward at the new head
                dims, on phase 17's captured first-layer prefill inputs of
                HuBERT-XLarge ([1, 4 096, 16, 80], full mask) and
                DeepSeek-V2 (q/k [1, 4 096, 128, 192], v [..., 128],
                causal): the forward by phase 3's rule and the one-rounding
                rule, the backward (on the kernel's own o and lse and a dO
                from a fixed seed) by lm_train's, two calls bit-equal, each
                timed beside its bound, the plain version and
                ``scaled_dot_product_attention``; they go into the kernels
                line as ``new_head_dims``.  (Run after phases 14-17, whose
                inputs it uses.)
 14. lm_train   recurrentgemma-2b at full width and depth in bf16, remat
                "full", random weights from ``--seed``: 6
                ``make_train_step`` steps of B 1 x S 4 096 from
                ``train/loop.py::data_stream(--seed)`` (cut from the
                dry-run's train_4k, B 256 x S 4 096: one card holds B 1),
                every count reset just before each step and read just after:
                per step 16 flash forward launches (8 local layers, each
                recomputed once), 8 flash_attention_bwd, 34 lru_scan (the 16
                rglru layers of the 8 checkpointed units twice, the 2 suffix
                rglru layers once), 18 lru_scan_bwd, no plain-version call;
                finite losses and grad norms, the last loss below the first;
                median step ms, tokens/s, ``max_memory_allocated``, and one
                more step under ``torch.profiler`` (the flash backward's
                device time, all of it and by kernel: delta, dK/dV, the
                partials' sum, dQ).
 15. lm_grad    float32, full width, depth cut to one unit (rglru, rglru,
                local) so float32 state and the plain path fit, B 1 x S
                2 304: loss and every gradient leaf through the kernels
                against the plain versions (``backend="ref"``): loss within
                1e-5 relative, each leaf within 1e-4 of its max |g|.
 16. train_loop ``python -m repro_torch.launch.train --full --layers 3``
                (one unit at full width; at full depth the optimizer state
                alone is 35 GB of float32 npz), B 1 x S 2 304, in process:
                8 steps uninterrupted; 8 with ``--ckpt-every 4 --fail-at 4``
                into a temporary directory, which fails as injected; then
                resumed to step 8, its losses within 1e-5 relative of the
                uninterrupted run's (bit-equality reported).  Then the
                compressed data-parallel trainer at P 4 (B 4 x S 1 024, one
                unit, bf16) 12 steps against the exact one: both train, the
                last losses within 0.1; step 1's ``compressed_psum`` on the
                card bit-equal, leaf by leaf, to a plain recomputation of
                its definition (shared scale, half-even rounding, int32
                sum, residual rounded once).
 17. lm_archs   the nine other architectures of ``configs/base.py``
                (Pixtral-12B, SmolLM-360M, Gemma-7B, Granite-20B, OLMo-1B,
                HuBERT-XLarge, DeepSeek-V2-236B, DeepSeekMoE-16B,
                RWKV6-1.6B) at full width, random weights from ``--seed``.
                Each: a bf16 prefill ``forward`` of B 1 x S 4 096 (cut from
                prefill_32k; Pixtral's first 256 positions are patches) at
                full depth, but DeepSeek-V2's dense layer and as many MoE
                layers as leave 16 GB of the card free (at least two), inside
                ``counted``: one flash launch per attention or MLA layer,
                no plain-version call, finite logits, aux > 0 exactly for
                the MoE models; wall ms, ``max_memory_allocated`` and one
                more forward under ``torch.profiler`` (device idle share;
                RWKV6's of its first 4 layers, whose 200 000 launches at
                full depth take the profiler half a minute to read).
                Then float32 at depth cut to the layout's prefix and one
                unit: ``forward`` at S 1 088 (flash) against token-by-token
                ``decode_step`` (Pixtral's patches through ``embeds=``;
                MoE at capacity_factor 16, drop-free), within 5e-3 and the
                same top-1 where the margin is clear; HuBERT has no decode
                step.  Then two bf16 ``make_train_step`` steps, remat
                "full", B 1 x S 2 048, at the depth whose parameters stay
                under 3e9 (AdamW's state, about 16 B a parameter; RWKV6 at
                4 layers for time), each inside ``counted`` with the exact
                flash and flash-backward launches, finite loss and grad
                norm, aux > 0 exactly with MoE layers, and where the model
                has attention a third step under ``torch.profiler`` (the
                flash backward's device time, as lm_train's); DeepSeek-V2 trains
                its dense layer and takes the gradient of its dense layer
                and one MoE layer besides (not one MoE layer fits beside
                AdamW's state).
 18. dryrun     ``repro_torch.launch.dryrun``'s meta records of all ten
                architectures x four shapes (each ok, or a skip with the
                reference's reason; none an error; no collective on one
                card; written to ``results/dryrun_torch/<GPU>/``), then two
                cells on the card, each run inside ``counted`` (a warm-up
                call under ``FlopCounterMode`` and a timed call) and held to
                its meta record: the argument bytes of the same tensors
                equal, the matrix products' FLOPs equal with attention and
                the scan taken out on both sides (the kernels launch
                through ctypes, which ``FlopCounterMode`` does not see), the
                meta peak against ``max_memory_allocated`` as a ratio, and
                the achieved share of 989e12 FLOP/s beside the predicted
                roofline fraction.  M1: recurrentgemma-2b decode_32k at its
                full shape (B 128, one ``serve_step`` at position 32 767),
                no kernel.  M2: prefill_32k cut to B 1 x S 8 192 (as phase
                10), 8 flash_attention and 18 lru_scan launches a call, no
                plain-version call (``dryrun_launches`` in the kernels
                line: both calls).  Then ``examples/serve_lm_torch.py`` as
                a subprocess with no ``--device``, to its line on cuda:0.

Float32 matrix products run in full float32 (TF32 off).  Exits non-zero,
printing no result, when there is no CUDA device, when the package is
missing beside this script, or when any phase fails.
"""
from __future__ import annotations

import argparse
import json
import importlib.util
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet), set by main() from
# repro_torch/launch/roofline.py: HBM3 bytes/s, and float32 operations/s
# outside the tensor cores, used for scalar adds
PEAK_BYTES_PER_S = PEAK_SCALAR_OPS_PER_S = None

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


# --- phase 2: what the compiler made of each kernel --------------------------

_ARG_TYPES = {"f": "float32", "i": "int32", "l": "int64",
              "13__nv_bfloat16": "bfloat16"}


def kernel_name(mangled: str) -> str:
    """``flash_attention_mma_kernel<256,256>`` from a mangled symbol
    (``flash_bwd_reduce_kernel`` from one that is no template)."""
    m = re.search(r"\d+([a-z_]+kernel)I(.*?)EEv", mangled)
    if m is None:
        m = re.search(r"\d+([a-z_]+kernel)E", mangled)
        return m.group(1) if m else mangled
    dims = re.findall(r"Li(\d+)E", m.group(2))
    dtype = m.group(2).split("Li")[0]
    args = ([_ARG_TYPES.get(dtype, dtype)] if dtype else []) + dims
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_report(log: str) -> dict:
    """kernel -> (registers, spill store bytes, spill load bytes) from what
    ``nvcc -Xptxas=-v`` printed."""
    report, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = kernel_name(m.group(1)), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name] = (int(m.group(1)), *spills)
    return report


def sass_hmma(lib_path) -> dict:
    """kernel -> number of HMMA (tensor-core) instructions in its SASS, by
    ``cuobjdump -sass``; empty when the toolkit has no cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = shutil.which("cuobjdump") or (
        str(Path(CUDA_HOME) / "bin" / "cuobjdump") if CUDA_HOME else None)
    if not tool or not Path(tool).exists():
        return {}
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr}")
    counts, name = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts


#: kernel -> (registers, spill store bytes, spill load bytes), from the
#: build of this run (``build_report``)
PTXAS: dict = {}
BF16_BWD_KERNELS = ("flash_bwd_dkdv_mma_kernel", "flash_bwd_dq_mma_kernel")
BF16_FLASH_KERNELS = ("flash_attention_mma_kernel", *BF16_BWD_KERNELS)
F32_BWD_KERNELS = ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")


def build_report(libs) -> str:
    """Registers, spills and HMMA count of every kernel of ``libs``; fails
    unless every bf16 flash instantiation, forward and backward, runs on the
    tensor cores and the float32 ones do not, and unless ptxas reported
    every bf16 flash instantiation in this run's build with no register
    spilled."""
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    parts, hmma_all = [], {}
    for lib in libs:
        regs = ptxas_report(lib.build_log or "")
        PTXAS.update(regs)
        hmma = sass_hmma(lib.path)
        hmma_all.update(hmma)
        for name in sorted(set(regs) | set(hmma)):
            r = regs.get(name)
            rs = (f"{r[0]} registers, spill stores/loads {r[1]}/{r[2]} B"
                  if r else "ptxas not run here (library already built)")
            parts.append(f"{name}: {rs}, HMMA {hmma.get(name, 'not measured')}")
    mma = {k: v for k, v in hmma_all.items()
           if k.startswith("flash_attention_mma_kernel")}
    if hmma_all:
        check(len(mma) == len(HEAD_DIMS) and all(v > 0 for v in
                                                 mma.values()),
              f"bf16 flash kernels without tensor-core instructions: {mma}")
        check(all(v == 0 for k, v in hmma_all.items()
                  if k.startswith("flash_attention_kernel")),
              "the float32 flash kernel uses the tensor cores")
        for prefix in BF16_BWD_KERNELS:
            bwd = {k: v for k, v in hmma_all.items() if k.startswith(prefix)}
            check(len(bwd) == len(HEAD_DIMS) and all(v > 0 for v in
                                                     bwd.values()),
                  f"bf16 flash backward kernels without tensor-core "
                  f"instructions: {bwd}")
        check(all(v == 0 for k, v in hmma_all.items()
                  if k.startswith(F32_BWD_KERNELS)),
              "a float32 flash backward kernel uses the tensor cores")
    wanted = [f"{prefix}<{d},{dv}>" for prefix in BF16_FLASH_KERNELS
              for d, dv in HEAD_DIMS]
    missing = [name for name in wanted if name not in PTXAS]
    check(not missing, f"no ptxas figures from this run's build for "
                       f"{missing}")
    spilled = {name: PTXAS[name] for name in wanted
               if PTXAS[name][1] or PTXAS[name][2]}
    check(not spilled, f"bf16 flash instantiations spill: {spilled}")
    return "; ".join(parts)


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
    reset_all_counts()
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
    return launches, recorder.largest, session, full, schema, oracles


# --- phase 5: where one warm query's device time goes -------------------------

def profile_device(torch, run, kernels, host_ops=True) -> str:
    """``run()`` once under ``torch.profiler``: device time by kernel name,
    the share of each of ``kernels`` (name -> substring of its device
    kernel's name), and the device's busy share of the wall time (host clock
    up to a synchronize).  ``host_ops=False`` records the device's activity
    alone (the readings use nothing else), which spares a run of hundreds
    of thousands of launches millions of host events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
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
    shares = []
    for label, key in kernels.items():
        ms = sum(v for k, v in by_name.items() if key in k)
        shares.append(f"{label}_ms {ms:.3f} (share {ms / device_ms:.4f})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return (f"wall_ms {wall_ms:.3f} device_busy_ms {busy_ms:.3f} (idle share "
            f"{1 - busy_ms / wall_ms:.4f}) device_ms {device_ms:.3f} "
            + " ".join(shares) + "; top: "
            + "; ".join(f"{k[:70]} {v:.3f}ms" for k, v in top))


# --- phase 6: timing -----------------------------------------------------------

def median_ms(torch, fn, iters=20, warmup=3, calls=1):
    """Median over ``iters`` CUDA-event timings of ``calls`` back-to-back
    calls of ``fn``, divided by ``calls``.  One call (the default) counts the
    host's launch overhead; a run of them lets it overlap the call before."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
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


def time_kernel(torch, ops, tokens, weights, vocab, seed):
    """Kernel, plain version and ``index_add_`` on one main-path call's
    inputs; beside them the kernel on controls of the same shape: tokens
    uniform over ``[1, vocab)`` (no hot bins), every weight 1 (every token
    read), and both.  The bound counts what the inputs need once rows of
    weight 0 are skipped: the weights, the tokens of the other rows, the
    output; the padded bound reads every token."""
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
    del tok, keep, idx, wflat
    # controls: uniform tokens (no hot bins), and every weight 1 (every
    # token read), each beside the main path's own tokens and weights
    gen = torch.Generator(device=tokens.device).manual_seed(seed)
    uniform = torch.randint(1, vocab, tokens.shape, generator=gen,
                            dtype=torch.int32, device=tokens.device)
    ones = torch.ones_like(weights)
    controls = {name: median_ms(torch, lambda t=t, w=w: ops.weighted_histogram(
        t, w, vocab)) for name, t, w in (
            ("uniform_tokens_ms", uniform, weights),
            ("all_rows_ms", tokens, ones),
            ("all_rows_uniform_tokens_ms", uniform, ones))}
    del uniform, ones
    torch.cuda.empty_cache()
    nonzero = int((weights != 0).sum())
    nbytes = B * R * w_item + nonzero * L * 4 + B * vocab * w_item
    padded = B * R * L * 4 + B * R * w_item + B * vocab * w_item
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nonzero * L / PEAK_SCALAR_OPS_PER_S * 1e3
    return {"ms": ms, "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "padded_bound_ms": padded / PEAK_BYTES_PER_S * 1e3,
            "zero_weight_share": 1 - nonzero / (B * R), **controls,
            "shape": [B, R, L, vocab]}


# --- phases 7-8: the serving path on phase 4's deployment ----------------------

APPEND_FRAC = 0.01              # LINEITEM rows appended in the serve phase
DEMO_QUERIES = ["alps bordeaux", "polished azure", "alps express priority",
                "bordeaux fragile"]
FULL_HISTOGRAM_BYTES = VOCAB * 4    # an int32 histogram's host transfer


def append_rows(np, schema, kws, n, seed):
    """``n`` LINEITEM rows as ``append`` takes them: foreign keys uniform
    over the existing domains and Zipf(1.1) token text with 10% PAD, the
    generator's own distributions (``data/tpch.py``, skew 0), and the
    keywords planted into 30% of the rows as phase 4 planted LINEITEM."""
    from repro_torch.data import tpch
    rng = np.random.default_rng(seed + 1000)
    fact = schema.fact
    keys = {c: tpch._zipf_keys(rng, n, fact.key_domains[c], 0.0)
            for c in fact.keys}
    text = tpch._text(rng, n, TEXT_LEN, VOCAB)
    for kw in (kws[0], kws[2]):
        rows = np.nonzero(rng.random(n) < 0.3)[0]
        text[rows, rng.integers(0, TEXT_LEN, rows.size)] = kw
    return [{**{c: int(keys[c][i]) for c in keys}, "text": text[i]}
            for i in range(n)]


class Timed:
    """Wraps a bound method to keep the wall time of each call."""

    def __init__(self, fn):
        self.fn, self.ms = fn, []

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.ms.append((time.perf_counter() - t0) * 1e3)


class UploadLog:
    """Records the rows of every ref whose columns go host -> device."""

    def __init__(self, ref_cls):
        self.ref_cls, self.inner = ref_cls, ref_cls.store_columns
        self.uploads = []

    def __enter__(self):
        log, inner = self.uploads, self.inner

        def store_columns(ref, *args):
            text, keys = inner(ref, *args)
            log.append((ref.name, int(ref.rows.min()), int(ref.rows.max()),
                        text.nbytes + keys.nbytes))
            return text, keys

        self.ref_cls.store_columns = store_columns
        return self

    def __exit__(self, *exc):
        self.ref_cls.store_columns = self.inner


def check_topk(np, resp, oracle, kws, k, label):
    from repro_torch.core.star import topk_terms
    ids, f = topk_terms(oracle, kws, k)
    check(np.array_equal(resp.term_ids, ids), f"{label}: term_ids differ")
    check(np.array_equal(resp.freqs, f), f"{label}: freqs differ")


def latency_line(snap, tenant):
    h = snap["histograms"][f"gateway.query_latency_ms{{schema={tenant}}}"]
    return (f"{tenant}: n {h['count']} p50 {h['p50']} p95 {h['p95']} p99 "
            f"{h['p99']} ms")


def run_serve(torch, np, args, dev, schema, oracles, full):
    """Phase 7; returns the launches of each of its paths, each counted
    from 0 around that path alone, and the launcher smoke's line."""
    from repro_torch.api import FCTRequest, FCTSession, SessionConfig
    from repro_torch.core.plan import RelationRef
    from repro_torch.core.star import fct_star
    from repro_torch.data.demo import TOK, build_db
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import Gateway, GatewayConfig, SchemaRegistry

    kws = list(full.keywords)
    sub = FCTRequest(keywords=(kws[0], kws[1]), top_k=10, r_max=4)
    tpch_reqs = [full, full, sub, sub]
    demo_reqs = [FCTRequest(keywords=tuple(q.split()), top_k=10, r_max=4)
                 for q in DEMO_QUERIES]
    metrics = MetricsRegistry()
    registry = SchemaRegistry(device=dev, metrics=metrics)
    registry.register("tpch", schema,
                      config=SessionConfig(accum_policy="int32"))
    registry.register("demo", build_db(), tokenizer=TOK)
    gateway = Gateway(registry, GatewayConfig(
        batch_window_ms=5.0, result_cache_ttl_s=3600.0,
        append_policy="patch"), metrics=metrics)
    path_launches = {}

    def burst():
        t0 = time.perf_counter()
        futs = ([gateway.submit("tpch", r) for r in tpch_reqs]
                + [gateway.submit("demo", r) for r in demo_reqs])
        resps = [f.result(timeout=900) for f in futs]
        wall = (time.perf_counter() - t0) * 1e3
        return resps, wall

    def check_burst(label, resps):
        for req, r in zip(tpch_reqs, resps):
            check_answer(np, r, oracles[req.keywords], list(req.keywords), 10,
                         f"{label} tpch {req.keywords}")

    (first, wall1), path_launches["gateway_burst"] = counted(
        "gateway burst 1", burst)
    check_burst("burst 1", first)
    check(sum(r.coalesced for r in first) >= 1, "burst 1: nothing coalesced")
    tpch = registry.session("tpch")
    batches = {t: registry.session(t).engine.batches_run
               for t in ("tpch", "demo")}
    (second, wall2), hit_launches = counted(
        "gateway burst 2", burst, kernels=())
    check_burst("burst 2", second)
    check(not hit_launches, f"burst 2 launched kernels: {hit_launches}")
    check(all(r.cache_hit for r in second), "burst 2 missed the cache")
    check(all(registry.session(t).engine.batches_run == batches[t]
              for t in batches), "burst 2 ran engine batches")
    hit_ms = []
    for k in (5, 10, 3):
        t0 = time.perf_counter()
        r = gateway.query("tpch", FCTRequest(keywords=full.keywords,
                                             top_k=k, r_max=4))
        hit_ms.append((time.perf_counter() - t0) * 1e3)
        check(r.cache_hit and len(r.term_ids) == k,
              f"top_k {k} was not re-sliced from the cache")
        check_topk(np, r, oracles[full.keywords], kws, k, f"top_k {k}")
    print(f"[serve] burst 1 (cold: plans for 2 keyword sets) {wall1:.3f} ms, "
          f"{sum(r.coalesced for r in first)} coalesced; burst 2 "
          f"{wall2:.3f} ms, all {len(second)} cache hits, 0 batches; cache "
          f"hits re-sliced at top_k 5/10/3 in "
          f"{', '.join(f'{m:.3f}' for m in hit_ms)} ms", flush=True)

    # an uncached query on the warm session: a second gateway over the same
    # registry with its result cache off
    with Gateway(registry, GatewayConfig(batch_window_ms=5.0,
                                         result_cache_ttl_s=0),
                 metrics=MetricsRegistry()) as probe:
        t0 = time.perf_counter()
        r, path_launches["gateway_uncached"] = counted(
            "uncached gateway query", lambda: probe.query("tpch", full))
        miss_ms = (time.perf_counter() - t0) * 1e3
        check_answer(np, r, oracles[full.keywords], kws, 10, "uncached")
        prof = profile_device(torch, lambda: probe.query("tpch", full),
                              {"fct_count": "fct_count_kernel"})
    print(f"[serve] uncached tpch query on the warm session (window 5 ms): "
          f"{miss_ms:.3f} ms (plan {r.timings['plan_ms']} dispatch "
          f"{r.timings['dispatch_ms']} collect {r.timings['collect_ms']}); "
          f"profile of one more: {prof}", flush=True)

    # append 1% of LINEITEM through the gateway (patch policy)
    n_new = int(round(schema.fact.rows * APPEND_FRAC))
    rows = append_rows(np, schema, kws, n_new, args.seed)
    base_rows = schema.fact.rows
    before = tpch.stats()
    tpch.append, tpch.delta_freq = Timed(tpch.append), Timed(tpch.delta_freq)
    try:
        with UploadLog(RelationRef) as log:
            t0 = time.perf_counter()
            # the session's append, then delta_freq for the patch
            ar, path_launches["append_delta_freq"] = counted(
                "gateway append", lambda: gateway.append("tpch", "LINEITEM",
                                                         rows))
            gw_append_ms = (time.perf_counter() - t0) * 1e3
            post, path_launches["post_append_query"] = counted(
                "first post-append query", lambda: tpch.query(full))
    finally:
        append_ms, delta_ms = tpch.append.ms, tpch.delta_freq.ms
        del tpch.append, tpch.delta_freq
    after = tpch.stats()
    check(ar.rows_appended == n_new and ar.base_rows == base_rows,
          f"append result {ar}")
    check(gateway.stats()["tpch"]["histograms_patched"] == 2,
          "the two cached histograms were not patched")
    appended = tpch.schema
    t0 = time.perf_counter()
    new_oracles = {r.keywords: fct_star(appended, list(r.keywords), 4)
                   for r in (full, sub)}
    oracle_s = time.perf_counter() - t0
    for req in (full, sub):
        r = gateway.query("tpch", req)
        check(r.cache_hit and r.data_epoch == ar.data_epoch,
              f"post-append {req.keywords}: not a patched hit")
        check_answer(np, r, new_oracles[req.keywords], list(req.keywords), 10,
                     f"patched hit {req.keywords}")
    check_answer(np, post, new_oracles[full.keywords], kws, 10,
                 "first post-append query")
    check(post.engine_stats["traces"] == 0,
          "the first post-append query built programs")
    up_bytes = after["store_upload_bytes"] - before["store_upload_bytes"]
    assembles = (after["store_chunk_assembles"]
                 - before["store_chunk_assembles"])
    # LINEITEM columns go up only for rows of the new chunk; a dimension's
    # columns only for a CN the new rows made non-empty (none was cached)
    fact_up = [u for u in log.uploads if u[0] == "LINEITEM"]
    check(fact_up and all(lo >= base_rows for _, lo, _, _ in fact_up),
          f"a LINEITEM upload left the new chunk: {fact_up[:5]}")
    chunk_bytes = sum(b for *_, b in fact_up)
    dim_bytes = sum(b for *_, b in log.uploads) - chunk_bytes
    check(up_bytes == chunk_bytes + dim_bytes,
          f"upload bytes {up_bytes} != the logged {chunk_bytes + dim_bytes}")
    check(assembles >= 1, "no chunked entry was assembled on the device")
    t = post.timings
    print(f"[serve] append of {n_new} LINEITEM rows (data epoch "
          f"{ar.data_epoch}): session append {append_ms[0]:.3f} ms, "
          f"delta_freq {' + '.join(f'{m:.3f}' for m in delta_ms)} ms, "
          f"gateway append (patch) {gw_append_ms:.3f} ms; first "
          f"post-append query {t['total_ms']} ms (plan {t['plan_ms']} "
          f"dispatch {t['dispatch_ms']} collect {t['collect_ms']}), builds "
          f"{post.engine_stats['traces']}, chunk assembles {assembles}, "
          f"uploads {len(fact_up)} LINEITEM chunk parts {chunk_bytes} B + "
          f"{len(log.uploads) - len(fact_up)} dimension entries {dim_bytes} "
          f"B (the columns uploaded before it: "
          f"{before['store_upload_bytes']} B); appended "
          f"oracles in {oracle_s:.3f}s", flush=True)

    dropped = gateway.invalidate("tpch")
    r, path_launches["requery"] = counted(
        "re-query after invalidate", lambda: gateway.query("tpch", full))
    check(not r.cache_hit, "invalidated entry still served")
    check_answer(np, r, new_oracles[full.keywords], kws, 10, "re-query")
    check(r.engine_stats["traces"] == 0, "the re-query built programs")
    t = r.timings
    print(f"[serve] invalidate dropped {dropped} results; re-query "
          f"{t['total_ms']} ms (plan {t['plan_ms']} dispatch "
          f"{t['dispatch_ms']}), builds 0, uploads "
          f"{r.engine_stats['store_uploads']}", flush=True)

    topk = FCTSession(appended, device=dev,
                      config=SessionConfig(device_topk=True))
    d_resps, path_launches["device_topk"] = counted(
        "device top-k", lambda: [topk.query(full) for _ in range(3)])
    # the same session's host finalize, warm: the latency to compare with
    h_resps = [topk.query(FCTRequest(keywords=full.keywords, top_k=10,
                                     r_max=4, need_histogram=True))
               for _ in range(2)]
    for h in h_resps:
        check(h.finalize == "host", "need_histogram did not take the host "
                                    "finalize")
        check_answer(np, h, new_oracles[full.keywords], kws, 10,
                     "host finalize beside device top-k")
    for i, d in enumerate(d_resps):
        check(d.finalize == "device_topk" and d.all_freqs is None,
              f"device top-k {i}: finalize {d.finalize}")
        check_topk(np, d, new_oracles[full.keywords], kws, 10,
                   f"device top-k {i}")
        check(np.array_equal(d.term_ids, r.term_ids)
              and np.array_equal(d.freqs, r.freqs),
              "device top-k differs from the host top-k")
        check(d.engine_stats["device_to_host_bytes"] <= 1024,
              f"device top-k moved {d.engine_stats['device_to_host_bytes']} B")
    print(f"[serve] device top-k (k 10): device_to_host_bytes "
          f"{d_resps[-1].engine_stats['device_to_host_bytes']} against the "
          f"full histogram's {FULL_HISTOGRAM_BYTES} (host finalize on the "
          f"same session: {h_resps[-1].engine_stats['device_to_host_bytes']}"
          f"); groups pruned {d_resps[-1].engine_stats['groups_pruned']} of "
          f"{d_resps[-1].engine_stats['groups_pruned'] + d_resps[-1].engine_stats['batches_run']}"
          f"; cold {d_resps[0].timings['total_ms']} ms, warm "
          f"{d_resps[1].timings['total_ms']} / "
          f"{d_resps[2].timings['total_ms']} ms against the host finalize's "
          f"warm {h_resps[0].timings['total_ms']} / "
          f"{h_resps[1].timings['total_ms']} ms", flush=True)
    del topk, d_resps, h_resps

    st, snap = gateway.stats(), metrics.snapshot()
    print("[serve] latency " + "; ".join(latency_line(snap, t)
                                        for t in ("tpch", "demo")), flush=True)
    print("[serve] " + "; ".join(
        f"{t}: result cache {st[t]['result_hits']} hits / "
        f"{st[t]['result_misses']} misses, {st[t]['windows_flushed']} "
        f"windows (mean {st[t]['mean_window_queries']}, peak "
        f"{st[t]['max_window_queries']}), {st[t]['coalesced']} coalesced"
        for t in ("tpch", "demo")), flush=True)
    gateway.close()
    registry.close()
    del gateway, registry, tpch, appended
    torch.cuda.empty_cache()
    smoke, path_launches["fct_serve_smoke"] = counted(
        "fct_serve --smoke", lambda: run_fct_serve_smoke(torch))
    print("[serve] launches by path, each counted from 0 around that path "
          f"alone: {path_launches}", flush=True)
    return path_launches, smoke


def run_fct_serve_smoke(torch) -> str:
    import contextlib
    import io

    from repro_torch.launch import fct_serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fct_serve.main(["--smoke", "--device", "cuda"])
    lines = out.getvalue().strip().splitlines()
    check(lines and lines[-1] == "SMOKE OK", "fct_serve --smoke did not "
          f"reach SMOKE OK: {lines[-5:]}")
    torch.cuda.empty_cache()
    return (f"python -m repro_torch.launch.fct_serve --smoke --device cuda: "
            + " / ".join(ln for ln in lines if ln.startswith("#")
                         or ln == "SMOKE OK"))


def example_answer(script: str):
    """Runs ``examples/<script>`` on the card as a user would (no
    ``--device``) and returns (its top-k ids, freqs, device, the oracle's
    ids and freqs on ``data/demo.py``'s database for the example's query)."""
    from repro_torch.core.star import fct_star, topk_terms
    from repro_torch.data import demo
    path = ROOT / "examples" / script
    spec = importlib.util.spec_from_file_location(path.stem, path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)       # its constants; main() not run
    proc = subprocess.run(
        [sys.executable, str(path)], cwd=ROOT, capture_output=True,
        text=True, timeout=600, env={**os.environ, "PYTHONPATH": str(SRC)})
    check(proc.returncode == 0,
          f"{script} exited {proc.returncode}: {proc.stderr[-2000:]}")
    m = re.search(r"^term ids \[([\d, ]*)\] freqs \[([\d, ]*)\] on (\S+)$",
                  proc.stdout, re.M)
    check(m is not None, f"{script} printed no term ids: {proc.stdout}")
    ids, freqs = ([int(x) for x in g.split(",") if x.strip()]
                  for g in m.groups()[:2])
    kws = [int(demo.TOK.encode(kw, 1)[0]) for kw in example.QUERY]
    want_ids, want_freqs = topk_terms(
        fct_star(demo.build_db(), kws, example.R_MAX), kws, example.TOP_K,
        demo.TOK.stop_mask())
    return ids, freqs, m.group(3), want_ids.tolist(), want_freqs.tolist()


def run_analysis(dev):
    """The port's invariant checks on the card: the lint over
    ``src/repro_torch`` (0 violations), the runtime contracts at P 1 and 8
    under both policies (0 failures, inside ``counted``: both integer
    fct_count instantiations launched, no plain-version call), then both
    FCT examples as subprocesses, each answer equal to ``fct_star`` +
    ``topk_terms`` on the demo database.  Returns (the contracts' launches,
    the phase's line)."""
    from repro_torch.analysis import lint_paths
    from repro_torch.analysis.contracts import check_all_contracts
    report = lint_paths(SRC / "repro_torch", repo_root=ROOT)
    check(report.ok, "lint: " + "; ".join(v.render()
                                          for v in report.violations))
    (failures, checked), launches = counted(
        "analysis contracts", lambda: check_all_contracts(device=dev),
        kernels=("fct_count_exact_int32", "fct_count_exact_int64"))
    check(not failures, f"contracts: {failures}")
    answers = []
    for script in ("quickstart_torch.py", "fct_query_expansion_torch.py"):
        ids, freqs, device, want_ids, want_freqs = example_answer(script)
        check(device.startswith("cuda"), f"{script} ran on {device}")
        check((ids, freqs) == (want_ids, want_freqs),
              f"{script}: {ids} {freqs}, fct_star: {want_ids} {want_freqs}")
        answers.append(f"{script} on {device}: ids {ids} freqs {freqs}")
    return launches, (
        f"lint: {report.files_checked} files of src/repro_torch, 0 "
        f"violations, {len(report.waived)} waived "
        f"({', '.join(f'{w.path}:{w.line} {w.rule}' for w in report.waived)}"
        f"); contracts: {checked} programs at P 1 and 8 under int32 and "
        f"int64, 0 failures, fct_count launched {launches} and no "
        f"plain-version call; examples equal to fct_star/topk_terms: "
        + "; ".join(answers))


def run_pipeline(torch, np, session, full, oracle):
    """Phase 8; returns the launches of the submit burst alone."""
    kws = list(full.keywords)
    t0 = time.perf_counter()
    seq = [session.query(full) for _ in range(8)]
    seq_ms = (time.perf_counter() - t0) * 1e3
    order = []

    def submit_burst():
        futs = [session.submit(full) for _ in range(8)]
        for i, f in enumerate(futs):
            f.add_done_callback(lambda _, i=i: order.append(i))
        return [f.result(timeout=900) for f in futs]

    t0 = time.perf_counter()
    burst, launches = counted("submit burst", submit_burst)
    burst_ms = (time.perf_counter() - t0) * 1e3
    check(order == list(range(8)), f"futures resolved out of order: {order}")
    for i, r in enumerate(seq + burst):
        check_answer(np, r, oracle, kws, 10, f"pipeline answer {i}")
    prof = profile_device(
        torch, lambda: [f.result(timeout=900)
                        for f in [session.submit(full) for _ in range(8)]],
        {"fct_count": "fct_count_kernel"})
    session.close()
    print(f"[pipeline] 8 submits {burst_ms:.3f} ms against 8 sequential "
          f"queries {seq_ms:.3f} ms (ratio {burst_ms / seq_ms:.4f}); FIFO; "
          f"profile of one more burst of 8: {prof}; launches of the "
          f"submit burst alone: {launches}", flush=True)
    return launches


# --- phase 9: the engine's other paths --------------------------------------

P8_SCALE = 0.05     # of SF1's cardinalities: every P = 8 plan at SF1 costs
P8_MODES = ("uniform", "skew", "round_robin", "adaptive")  # tens of seconds
P8_ENGINES = {"rs": {}, "psum": {"reduce_scatter": False},
              "unbatched": {"batch": False, "bucket": False}}


def timed(torch, dev, fn, trace=None):
    """(fn's result, wall ms up to a synchronize); ``fn`` runs with
    ``trace`` active when one is given."""
    from repro_torch.obs import maybe_activate
    t0 = time.perf_counter()
    with maybe_activate(trace):
        out = fn()
    torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


def span_ms(trace):
    """Total ms of the trace's spans, by name."""
    out = {}
    for sp in trace.spans():
        out[sp.name] = out.get(sp.name, 0.0) + sp.dur_ns / 1e6
    return out


def run_engine_paths(torch, np, args, dev, session, full, oracle):
    """Phase 9; returns the launches of each path, each counted from 0
    around that path alone."""
    import tempfile
    import warnings
    from repro_torch.api import FCTRequest, FCTSession, SessionConfig
    from repro_torch.core.accum import INT64_EXACT
    from repro_torch.core.fct import run_cn_plan_two_jobs, run_fct_query
    from repro_torch.core.star import fct_star
    from repro_torch.data.schema import PAD_ID
    from repro_torch.obs import MetricsRegistry, Trace
    from repro_torch.runtime.cache import ExecutableCache
    from repro_torch.runtime.engine import FCTEngine

    def column_bytes(eng):     # what its storeless calls' stores uploaded
        return eng.metrics.snapshot()["counters"].get("store.upload_bytes", 0)

    kws = list(full.keywords)
    planned = session._plan(full)             # phase 4's, from the cache
    plans, mesh = planned.plans, session.mesh
    launches = {}

    def with_map_only(freq):   # the joined CNs plus the map-only CNs
        out = planned.host_freq + freq
        out[PAD_ID] = 0
        return out

    before = session.engine.stats()
    store_cols0 = session.store.stats()["store_upload_bytes"]
    store, store_ms = timed(torch, dev, lambda: session.engine.run_plans(
        plans, mesh, store=session.store))
    after = session.engine.stats()
    check(np.array_equal(with_map_only(store), oracle),
          "store-path run_plans differs from fct_star")
    store_bytes = after["bytes_shipped"] - before["bytes_shipped"]
    store_cols = session.store.stats()["store_upload_bytes"] - store_cols0
    check(store_cols == 0, f"the session's store uploaded {store_cols} "
          f"column bytes for plans it had run")

    cache = ExecutableCache()
    lines = []
    for label, individual in (("batched", False), ("batched_percn", True)):
        eng = FCTEngine(cache=cache, metrics=MetricsRegistry())
        run = eng.run_plans_individual if individual else eng.run_plans
        trace = Trace()
        (out, ms), launches[label] = counted(
            f"storeless {label}",
            lambda: timed(torch, dev, lambda: run(plans, mesh), trace))
        spans = span_ms(trace)
        if individual:
            per_cn, out = out, out.sum(axis=0)
        check(np.array_equal(out, store),
              f"storeless {label} differs from the store path")
        check(np.array_equal(with_map_only(out), oracle),
              f"storeless {label} differs from fct_star")
        st = eng.stats()
        check(column_bytes(eng) > 0, f"storeless {label} uploaded no column")
        lines.append(f"{label} {ms:.3f} ms (column uploads "
                     f"{spans.get('store.upload', 0.0):.3f} ms of the groups' "
                     f"dispatch {spans['engine.dispatch_group']:.3f} ms), "
                     f"store.upload_bytes {column_bytes(eng)}, bytes_shipped "
                     f"{st['bytes_shipped']}, groups {st['batches_run']}")
    lines.append(f"session store {store_ms:.3f} ms, store.upload_bytes "
                 f"{store_cols}, bytes_shipped {store_bytes}")
    print(f"[engine_paths] P 1 SF1 x {args.scale}: " + "; ".join(lines),
          flush=True)

    # the split two-job path on the largest joined two-dimension CN
    big = max((i for i, p in enumerate(plans) if len(p.included) == 2),
              key=lambda i: plans[i].fact.ref.n_rows)
    (two, ms), launches["two_jobs"] = counted("two jobs", lambda: timed(
        torch, dev, lambda: run_cn_plan_two_jobs(plans[big], mesh,
                                                 cache=cache)))
    check(np.array_equal(two, per_cn[big]),
          "two-job path differs from the CN's run_plans_individual row")
    trace = Trace()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        (two_ck, ck_ms), launches["two_jobs_ckpt"] = counted(
            "two jobs with a checkpoint", lambda: timed(
                torch, dev, lambda: run_cn_plan_two_jobs(
                    plans[big], mesh, checkpoint_dir=ckpt_dir, cache=cache),
                trace))
        size = sum(f.stat().st_size for f in Path(ckpt_dir).rglob("*")
                   if f.is_file())
    check(np.array_equal(two_ck, per_cn[big]),
          "two-job path with a checkpoint differs from the fused path")
    spans = span_ms(trace)
    print(f"[engine_paths] two jobs on CN {big} ({plans[big].fact.ref.n_rows} "
          f"fact rows, {len(plans[big].included)} dimensions): {ms:.3f} ms; "
          f"with a checkpoint {ck_ms:.3f} ms, checkpoint {size} bytes, save "
          f"{spans['fct.checkpoint_save']:.3f} ms, restore "
          f"{spans['fct.checkpoint_restore']:.3f} ms", flush=True)

    eng64 = FCTEngine(cache=cache, metrics=MetricsRegistry())
    (t64, ms), launches["batched_int64"] = counted(
        "storeless int64", lambda: timed(torch, dev, lambda: eng64.run_plans(
            plans, mesh, accum=INT64_EXACT)),
        kernels=("fct_count_exact_int64",))
    check(np.array_equal(with_map_only(t64), oracle),
          "storeless int64 run_plans differs from fct_star")
    print(f"[engine_paths] storeless int64 {ms:.3f} ms, store.upload_bytes "
          f"{column_bytes(eng64)}", flush=True)

    # P = 8 at a cut scale: every mode, both aggregation layouts, unbatched
    t0 = time.perf_counter()
    schema8, kws8 = build_schema(np, argparse.Namespace(
        scale=args.scale * P8_SCALE, seed=args.seed))
    oracle8 = fct_star(schema8, kws8, 4)
    reqs = [FCTRequest(keywords=tuple(kws8), top_k=10, r_max=4, mode=m,
                       rho=4) for m in P8_MODES]
    print(f"[engine_paths] P 8 deployment SF1 x {args.scale * P8_SCALE}: "
          f"LINEITEM {schema8.fact.rows} rows; generated and fct_star in "
          f"{time.perf_counter() - t0:.3f}s", flush=True)
    p8_lines = []

    def p8():
        answers = {}
        for label, options in P8_ENGINES.items():
            eng = FCTEngine(cache=ExecutableCache(), **options)
            s = FCTSession(schema8, device=dev, n_workers=8, engine=eng)
            t1 = time.perf_counter()
            resps = [s.query(r) for r in reqs] + s.query_batch(reqs)
            for r, resp in zip(reqs + reqs, resps):
                check_answer(np, resp, oracle8, kws8, 10,
                             f"P 8 {label} {r.mode}")
            answers[label] = resps[0]
            p0 = s._plan(reqs[0])
            host = eng.run_plans(p0.plans, s.mesh)
            host = p0.host_freq + host
            host[PAD_ID] = 0
            check(np.array_equal(host, oracle8),
                  f"P 8 {label} storeless run_plans differs from fct_star")
            p8_lines.append(f"{label} {(time.perf_counter() - t1) * 1e3:.3f}"
                            f" ms, batches {eng.stats()['batches_run']}")
        s = FCTSession(schema8, device=dev, n_workers=8,
                       engine=FCTEngine(cache=ExecutableCache(),
                                        reduce_scatter=False),
                       config=SessionConfig(device_topk=True))
        resp = s.query(reqs[0])
        check(resp.finalize == "device_topk", "P 8 psum top-k not on device")
        check_topk(np, resp, oracle8, kws8, 10, "P 8 psum device top-k")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            res = run_fct_query(schema8, kws8, r_max=4, k_terms=10,
                                device=dev, n_workers=8)
        want = answers["rs"]
        for field in ("term_ids", "freqs", "all_freqs"):
            check(np.array_equal(getattr(res, field), getattr(want, field)),
                  f"run_fct_query {field} differs from the session's")
        for field in ("n_cns", "n_joined_cns", "shuffle_rows",
                      "shuffle_bytes", "imbalance"):
            check(getattr(res, field) == getattr(want, field),
                  f"run_fct_query {field} differs from the session's")

    _, launches["p8_modes"] = counted("P 8 modes", p8)
    print(f"[engine_paths] P 8, modes {list(P8_MODES)} by query and "
          f"query_batch, each bit-equal to fct_star: "
          + "; ".join(p8_lines) + "; psum device top-k and run_fct_query "
          "equal", flush=True)
    return launches


# --- LM phases: recurrentgemma-2b prefill, decode and serve ------------------

LM_ARCH = "recurrentgemma-2b"
PREFILL_B, PREFILL_S = 1, 8192      # cut from prefill_32k's B 32 x S 32 768
DECODE_B, DECODE_S = 1, 2304        # > 1 024 (flash), > window 2 048 (ring wraps)
DECODE_TOL = 5e-3                   # max abs logit error, decode vs forward
FLASH_TOL = {"float32": 2e-5, "bfloat16": 4e-2}
# flash at the prefill's own bf16 inputs, whose outputs (mean magnitude
# about 0.06) are no larger than FLASH_TOL's absolute term: both sides
# compute in float32 from the same inputs and round to bf16 once, so they
# may land on adjacent bf16 values, at most 2^-7 |plain| apart; the
# absolute term, 2^-8 mean|plain|, covers float32 summation order near 0
CAPTURED_BF16_REL = 2.0 ** -7
CAPTURED_BF16_ABS_OF_MEAN = 2.0 ** -8
LRU_TOL = 1e-5
# a backward kernel in float32 against the plain version's autograd: flash
# within 1e-4 of each gradient's max |g| (dk and dv sum over every query row
# and head of a group, in another order); lru_scan by LRU_TOL, scaled
FLASH_GRAD_TOL = 1e-4
# the bf16 backward at lm_train's own inputs, its dO scaled by a power of two
# to a max |dO| in [0.5, 1) (the gradients are linear in dO; the loss's own
# dO, about 1e-8, makes any fixed absolute term vacuous), held two ways.
# (1) Against its own formula in dense float32 matrices from the same q, k,
# v, o, lse and dO: the kernel sums in float32 and rounds to bf16 once, so
# 2^-8 |dense| + FLASH_GRAD_TOL max|dense| per tensor; zeros, and the
# formula with the band cut by BAND_CUT keys at its far edge (what a
# backward that dropped a tile there would compute), must break that limit
# in each of dq, dk, dv.  (2) Through the autograd op against the plain
# version's autograd: both round to bf16 once, 2^-7 |plain| apart, but the
# kernel's delta = rowsum(dO o) takes the bf16 o where the plain autograd
# differentiates through its float32 o, which the term 2^-7 max|plain|
# covers (on an H100 at seed 0, dq needed 0.0029 max|plain| of it)
FORMULA_BWD_REL = 2.0 ** -8
CAPTURED_BWD_REL = 2.0 ** -7
CAPTURED_BWD_ABS_OF_MAX = 2.0 ** -7
BAND_CUT = 32
# H100 SXM peak operations/s by input type: dense bf16 tensor cores, and
# float32 outside the tensor cores (set by main() from launch/roofline.py)
PEAK_OPS_PER_S = {}
LM_KERNELS = {  # name -> (source, TPU kernel it replaces)
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:79"),
    "lru_scan": ("src/repro_torch/kernels/lru_scan/csrc/lru_scan.cu",
                 "src/repro/kernels/lru_scan/kernel.py:43"),
    # the backward kernels have no Pallas counterpart: the JAX package's
    # training differentiates these jnp functions instead
    "flash_attention_bwd": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/ref.py:23"),
    "lru_scan_bwd": ("src/repro_torch/kernels/lru_scan/csrc/lru_scan.cu",
                     "src/repro/models/rglru.py:92"),
}
NO_PALLAS = ("no Pallas counterpart: the reference's gradient is JAX's "
             "autodiff of the jnp function named in replaces")
# lm_train: cut from the dry-run's train_4k (B 256 x S 4 096) to B 1, which
# one card's memory forces (float32 moments alone are 23 GB); S stays 4 096,
# past the 2 048 window
TRAIN_B, TRAIN_S, TRAIN_STEPS = 1, 4096, 6
GRAD_S = 2304                       # lm_grad: past the window, one unit
LM_GRAD_TOL = 1e-4                  # of each leaf's max |g|, float32
LOOP_S, LOOP_STEPS, LOOP_FAIL, LOOP_EVERY = 2304, 8, 4, 4
LOOP_TOL = 1e-5                     # relative, resumed vs uninterrupted
DP_P, DP_B, DP_S, DP_STEPS, DP_TOL = 4, 4, 1024, 12, 0.1
DP_CHECK_CALL = 2      # the compressed_psum call held to the plain one: step
# 1's, the first whose residuals are not all 0


def count_modules():
    """(every kernel library, every op module): the libraries count
    launches (each LM op's backward is a second kernel of its library), the
    ops the path each call took."""
    from repro_torch.kernels.fct_count import kernel as fct_kernel
    from repro_torch.kernels.fct_count import ops as fct_ops
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.lru_scan import kernel as lru_kernel
    from repro_torch.kernels.lru_scan import ops as lru_ops
    return ((fct_kernel.LIB, flash_kernel.LIB, lru_kernel.LIB),
            (fct_ops, flash_ops, lru_ops))


def reset_all_counts() -> None:
    """Every kernel's launch count and every op's path count to 0."""
    libs, opses = count_modules()
    for lib in libs:
        lib.reset_launches()
    for m in opses:
        m.reset_path_counts()


def read_counts():
    """(launches by kernel name, path counts by op) as they stand."""
    libs, opses = count_modules()
    launches = {k: v for lib in libs for k, v in lib.launches.items()}
    paths = {m.__name__.split(".")[-2]: dict(m.PATH_COUNTS) for m in opses}
    return launches, paths


def counted(label, fn, kernels=("fct_count_exact_int32",)):
    """Runs one path with every count set to 0 just before it and read just
    after.  Fails unless each of ``kernels`` launched in that run and no op
    took its plain version; returns (fn's result, the run's launches by
    kernel, those above 0 only)."""
    reset_all_counts()
    out = fn()
    launches, paths = read_counts()
    for name in kernels:
        check(launches[name] > 0, f"{label}: {name} never launched")
    check(all(p["ref"] == 0 for p in paths.values()),
          f"{label}: the plain version ran: {paths}")
    return out, {k: v for k, v in launches.items() if v}


def flash_cases(torch, np, dev):
    """(label, q, k, v, causal, window): every row of what goes wrong in a
    port of flash attention, in float32 and bfloat16."""
    rng = np.random.default_rng(4321)
    shapes = [  # b, s, h, hkv, d, dv, causal, window
        ("GQA causal D32", 2, 128, 4, 2, 32, 32, True, None),
        ("MQA window 64 ragged S200 D16", 1, 200, 6, 1, 16, 16, True, 64),
        ("encoder Dv16 != D32", 2, 96, 4, 4, 32, 16, False, None),
        ("causal D128", 1, 64, 2, 2, 128, 128, True, None),
        ("GQA D64 S1100 > window 100", 1, 1100, 4, 2, 64, 64, True, 100),
        ("MQA D256 ragged S1000 > window 300", 1, 1000, 10, 1, 256, 256,
         True, 300),
        ("encoder D256 Dv128 ragged S333", 1, 333, 2, 1, 256, 128, False,
         None),
        # the head dims and groupings of the nine other architectures
        ("encoder D80 (HuBERT) S1100", 1, 1100, 4, 4, 80, 80, False, None),
        ("MLA D192 Dv128 causal S1100", 1, 1100, 4, 4, 192, 128, True,
         None),
        ("reduced MLA D16 Dv8 causal ragged S300", 2, 300, 4, 4, 16, 8, True,
         None),
        ("GQA 15/5 (SmolLM) causal S1100", 1, 1100, 15, 5, 64, 64, True,
         None),
    ]
    for label, b, s, h, hkv, d, dv, causal, window in shapes:
        base = [rng.normal(size=shape).astype(np.float32) for shape in
                ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, dv))]
        for dtype in ("float32", "bfloat16"):
            q, k, v = (torch.from_numpy(x).to(dev, getattr(torch, dtype))
                       for x in base)
            yield f"{label} {dtype}", q, k, v, causal, window


def lru_cases(torch, np, dev):
    """(label, a, b): the earlier shapes, then the kernel's chunk (128
    steps) and tile (64 float32 / 128 bf16 channels) edges in both dtypes,
    views one element off a 16-byte boundary, and a long-memory input (x
    scaled by sqrt(1 - a²) as the gates scale it)."""
    rng = np.random.default_rng(8765)
    edges = [(1, 1, 5), (3, 127, 127), (1, 128, 129), (3, 129, 2560),
             (1, 8192 + 37, 129), (3, 8192 + 37, 2560)]
    shapes = [(2, 64, 32, "float32"), (1, 300, 700, "float32"),
              (3, 17, 5, "float32"), (2, 1000, 2560, "float32"),
              (2, 300, 700, "bfloat16")]
    shapes += [(b, s, w, d) for b, s, w in edges
               for d in ("float32", "bfloat16")]
    for b, s, w, dtype in shapes:
        a = rng.uniform(0.8, 1.0, (b, s, w)).astype(np.float32)
        x = rng.normal(size=(b, s, w)).astype(np.float32)
        yield (f"[{b},{s},{w}] {dtype}",
               *(torch.from_numpy(t).to(dev, getattr(torch, dtype))
                 for t in (a, x)))
    for dtype in ("float32", "bfloat16"):
        n = 3 * 200 * 2560
        a, x = (torch.from_numpy(t).to(dev, getattr(torch, dtype))[1:]
                .view(3, 200, 2560) for t in (
                    rng.uniform(0.8, 1.0, n + 1).astype(np.float32),
                    rng.normal(size=n + 1).astype(np.float32)))
        check(a.data_ptr() % 16 != 0, "the unaligned view is aligned")
        yield f"[3,200,2560] {dtype} off 16-byte alignment", a, x
    a = rng.uniform(0.999, 1.0, (1, 8192, 2560)).astype(np.float32)
    x = (rng.normal(size=(1, 8192, 2560))
         * np.sqrt(1.0 - a.astype(np.float64) ** 2)).astype(np.float32)
    yield ("[1,8192,2560] float32 long memory",
           torch.from_numpy(a).to(dev), torch.from_numpy(x).to(dev))


def flash_pair(torch, flash_ops, q, k, v, causal, window):
    """(kernel output, plain output) on one input, as float32."""
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     block_q=64, block_k=32, backend="ref")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "flash kernel: non-finite output")
    return got.float(), want.float()


def flash_err(torch, flash_ops, q, k, v, causal, window):
    """(max abs error, tolerance, within it) of the kernel against the
    plain version on one input, by the reference's assert_allclose rule:
    |got - want| <= tol + tol |want|."""
    got, want = flash_pair(torch, flash_ops, q, k, v, causal, window)
    tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
    diff = (got - want).abs()
    ok = bool((diff <= tol + tol * want.abs()).all())
    return float(diff.max()), tol, ok


def lru_err(torch, lru_ops, a, b):
    """(max abs error, tolerance, worst error over its limit) of the kernel
    against the plain loop, |kernel - plain| <= tol + tol |plain|: within
    it when the last is at most 1."""
    got = lru_ops.lru_scan(a, b)
    want = lru_ops.lru_scan(a, b, backend="ref")
    torch.cuda.synchronize()
    tol = LRU_TOL if a.dtype == torch.float32 else FLASH_TOL["bfloat16"]
    diff = (got.float() - want.float()).abs()
    share = float((diff / (tol + tol * want.float().abs())).max())
    return float(diff.max()), tol, share


def grads_of(fn, tensors, g):
    """The gradients of ``(fn(*tensors) * g).sum()`` with respect to each
    of ``tensors``, from fresh leaf copies."""
    ins = [t.detach().clone().requires_grad_(True) for t in tensors]
    fn(*ins).backward(g)
    return [t.grad for t in ins]


def grad_err(torch, got, again, want, rule):
    """(max abs error, worst error over its limit, bit-equal repeat) of the
    kernels' gradients ``got`` (and a second call's ``again``) against the
    plain version's autograd ``want``, tensor by tensor; ``rule(w)`` is the
    limit of each element of a plain gradient ``w`` (float32)."""
    torch.cuda.synchronize()
    err = share = 0.0
    for a, w in zip(got, want):
        check(bool(torch.isfinite(a).all()), "non-finite gradient")
        a, w = a.detach().float(), w.detach().float()
        d = (a - w).abs()
        err = max(err, float(d.max()))
        share = max(share, float((d / rule(w)).max()))
    return err, share, all(torch.equal(a, b) for a, b in zip(got, again))


def flash_grad_err(torch, flash_ops, q, k, v, causal, window, g):
    """The backward kernel against the plain version's autograd on one
    input: float32 within 1e-4 of each gradient's max |g|, bfloat16 by the
    forward's rule, 4e-2 + 4e-2 |g|."""
    kw = dict(causal=causal, window=window)
    got, again = (grads_of(lambda *t: flash_ops.flash_attention(*t, **kw),
                           (q, k, v), g) for _ in range(2))
    want = grads_of(lambda *t: flash_ops.flash_attention(
        *t, block_q=64, block_k=32, backend="ref", **kw), (q, k, v), g)
    if q.dtype == torch.float32:
        def rule(w):
            return FLASH_GRAD_TOL * w.abs().max()
    else:
        tol = FLASH_TOL["bfloat16"]

        def rule(w):
            return tol + tol * w.abs()
    return grad_err(torch, got, again, want, rule)


def lru_grad_err(torch, lru_ops, a, b, g):
    """The reverse-scan kernel against the plain loop's autograd on one
    input: float32 within 1e-5 max|g| + 1e-5 |g| (the forward's rule, its
    absolute term scaled by the gradient, which sums dh over many steps),
    bfloat16 4e-2 + 4e-2 |g|."""
    got, again = (grads_of(lru_ops.lru_scan, (a, b), g) for _ in range(2))
    want = grads_of(lambda *t: lru_ops.lru_scan(*t, backend="ref"), (a, b),
                    g)
    if a.dtype == torch.float32:
        def rule(w):
            return LRU_TOL * w.abs().max() + LRU_TOL * w.abs()
    else:
        tol = FLASH_TOL["bfloat16"]

        def rule(w):
            return tol + tol * w.abs()
    return grad_err(torch, got, again, want, rule)


def run_lm_kernel_cases(torch, np, dev):
    """Each LM kernel and each backward kernel against its plain version
    on the case lists above."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.lru_scan import ops as lru_ops
    errs = {"flash_attention": 0.0, "lru_scan": 0.0,
            "flash_attention_bwd": 0.0, "lru_scan_bwd": 0.0}
    lines = []
    gen = torch.Generator(device=dev).manual_seed(99)
    for label, q, k, v, causal, window in flash_cases(torch, np, dev):
        err, tol, ok = flash_err(torch, flash_ops, q, k, v, causal, window)
        check(ok, f"flash {label}: kernel != plain (max abs err {err}, "
                  f"tolerance {tol})")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        lines.append(f"flash {label}: {err:.3g} <= {tol}")
        g = torch.randn((*q.shape[:3], v.shape[-1]), generator=gen,
                        device=dev).to(q.dtype)
        err, share, equal = flash_grad_err(torch, flash_ops, q, k, v, causal,
                                           window, g)
        check(share <= 1.0 and equal,
              f"flash backward {label}: kernel != plain autograd (max abs "
              f"err {err}, worst error {share} x its limit, two calls "
              f"bit-equal {equal})")
        errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], err)
        lines.append(f"flash backward {label}: {err:.3g} (worst {share:.3f} "
                     f"of its limit, repeat bit-equal)")
    for label, a, b in lru_cases(torch, np, dev):
        err, tol, share = lru_err(torch, lru_ops, a, b)
        check(share <= 1.0, f"lru_scan {label}: kernel != plain (max abs err "
                            f"{err}, tolerance {tol}, worst error {share} x "
                            f"its limit)")
        errs["lru_scan"] = max(errs["lru_scan"], err)
        lines.append(f"lru_scan {label}: {err:.3g} (worst {share:.3f} of "
                     f"the {tol} limit)")
        g = torch.randn(a.shape, generator=gen, device=dev).to(a.dtype)
        err, share, equal = lru_grad_err(torch, lru_ops, a, b, g)
        check(share <= 1.0 and equal,
              f"lru_scan backward {label}: kernel != plain autograd (max abs "
              f"err {err}, worst error {share} x its limit, two calls "
              f"bit-equal {equal})")
        errs["lru_scan_bwd"] = max(errs["lru_scan_bwd"], err)
        lines.append(f"lru_scan backward {label}: {err:.3g} (worst "
                     f"{share:.3f} of its limit, repeat bit-equal)")
    return errs, lines


class FirstCall:
    """Wraps a kernel entry point during a run to keep the inputs of its
    first call (the first local layer's attention, the first rglru layer's
    scan).  Launch counting stays in the wrapped function."""

    def __init__(self, fn):
        self.fn = fn
        self.args = None

    def __call__(self, *args, **kwargs):
        if self.args is None:
            self.args = (args, kwargs)
        return self.fn(*args, **kwargs)


def lm_config(dtype):
    import dataclasses

    from repro_torch.configs.base import get_arch
    cfg = get_arch(LM_ARCH)
    return dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)


def run_lm_prefill(torch, args, dev):
    """One full-width bf16 prefill ``forward`` of B x S tokens with every
    count reset just before and read just after; returns the captured first
    inputs of each LM kernel and its launches."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.lru_scan import kernel as lru_kernel
    from repro_torch.models import model as M

    cfg = lm_config(torch.bfloat16)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, dev, generator=gen)
    batch = M.make_dummy_batch(cfg, PREFILL_B, PREFILL_S, gen, dev)
    torch.cuda.synchronize(dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[lm_prefill] {cfg.name} full width and depth: {cfg.n_layers} "
          f"layers {[m for m, _ in cfg.blocks()]}, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {n_params} parameters in bf16 "
          f"({n_params * 2} bytes), random from seed {args.seed}, made in "
          f"{time.perf_counter() - t0:.3f}s; batch {PREFILL_B} x seq "
          f"{PREFILL_S}", flush=True)

    flash_rec = FirstCall(flash_kernel.flash_attention)
    lru_rec = FirstCall(lru_kernel.lru_scan)
    flash_kernel.flash_attention, lru_kernel.lru_scan = flash_rec, lru_rec
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_counts()
    try:
        t1 = time.perf_counter()
        with torch.inference_mode():
            logits, _ = M.forward(params, batch, cfg)
        torch.cuda.synchronize(dev)
        cold_ms = (time.perf_counter() - t1) * 1e3
    finally:
        flash_kernel.flash_attention = flash_rec.fn
        lru_kernel.lru_scan = lru_rec.fn
    launches, paths = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    check(tuple(logits.shape) == (PREFILL_B, PREFILL_S, cfg.vocab_size),
          f"prefill logits shape {tuple(logits.shape)}")
    check(logits.dtype == torch.float32, f"logits dtype {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    check(float(logits.abs().max()) <= cfg.logit_softcap,
          "logits exceed the softcap")
    n_local = sum(m == "local" for m, _ in cfg.blocks())
    n_rglru = sum(m == "rglru" for m, _ in cfg.blocks())
    check(launches["flash_attention"] == n_local,
          f"flash launches {launches['flash_attention']} != {n_local}")
    check(launches["lru_scan"] == n_rglru,
          f"lru_scan launches {launches['lru_scan']} != {n_rglru}")
    check(paths["flash_attention"]["ref"] == 0 and paths["lru_scan"]["ref"]
          == 0, f"a plain version ran on the prefill path: {paths}")
    del logits
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    with torch.inference_mode():
        logits, _ = M.forward(params, batch, cfg)
    torch.cuda.synchronize(dev)
    warm_ms = (time.perf_counter() - t1) * 1e3
    del logits

    def prefill():
        with torch.inference_mode():
            M.forward(params, batch, cfg)
    profile = profile_device(
        torch, prefill,
        {"flash_attention": "flash_attention",
         "lru_scan": "lru_scan_kernel"})
    print(f"[lm_prefill] forward cold {cold_ms:.3f} ms, warm {warm_ms:.3f} "
          f"ms ({PREFILL_B * PREFILL_S / warm_ms * 1e3:.1f} tokens/s); "
          f"device_peak_bytes {peak}; launches {launches}; paths {paths}",
          flush=True)
    print(f"[lm_prefill] profile of one more forward: {profile}",
          flush=True)
    del params
    torch.cuda.empty_cache()
    return {"flash_attention": (flash_rec.args, launches["flash_attention"]),
            "lru_scan": (lru_rec.args, launches["lru_scan"])}


def run_lm_decode(torch, args, dev) -> str:
    """Full-width float32 ``forward`` (both kernels) against token-by-token
    ``decode_step`` (``_sdpa`` on the ring buffer, one-step recurrence)."""
    from repro_torch.models import model as M
    cfg = lm_config(torch.float32)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    params = M.init_params(cfg, dev, generator=gen)
    tokens = M.make_dummy_batch(cfg, DECODE_B, DECODE_S, gen, dev)["tokens"]
    reset_all_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        fwd, _ = M.forward(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize(dev)
    fwd_ms = (time.perf_counter() - t0) * 1e3
    launches, paths = read_counts()
    check(launches["flash_attention"] > 0 and launches["lru_scan"] > 0,
          f"fp32 forward missed a kernel: {launches}")
    check(paths["flash_attention"]["ref"] == paths["lru_scan"]["ref"] == 0,
          f"fp32 forward ran a plain version: {paths}")
    top2 = torch.topk(fwd, 2, dim=-1)
    margin = top2.values[..., 0] - top2.values[..., 1]
    cache = M.init_cache(cfg, DECODE_B, DECODE_S, dev)
    err = torch.zeros((), device=dev)
    clear = torch.zeros((), dtype=torch.int64, device=dev)
    flips = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for t in range(DECODE_S):
        lg, cache = M.decode_step(params, cache, tokens[:, t:t + 1], t, cfg)
        err = torch.maximum(err, (lg[:, 0] - fwd[:, t]).abs().max())
        sure = margin[:, t] > 2 * DECODE_TOL
        clear += sure.sum()
        flips += (sure & (lg[:, 0].argmax(-1) != top2.indices[:, t, 0])).sum()
    torch.cuda.synchronize(dev)
    dec_ms = (time.perf_counter() - t0) * 1e3
    err, clear, flips = float(err), int(clear), int(flips)
    check(err < DECODE_TOL, f"decode vs forward: max abs logit error {err} "
                            f">= {DECODE_TOL}")
    check(flips == 0, f"{flips} top-1 ids differ where the forward's top-2 "
                      f"margin exceeds {2 * DECODE_TOL}")
    del params, cache, fwd, top2, margin
    torch.cuda.empty_cache()
    return (f"{cfg.name} float32 full width, B {DECODE_B} x S {DECODE_S} "
            f"(ring buffer {min(DECODE_S, cfg.local_window)} wraps): forward "
            f"{fwd_ms:.3f} ms with {launches['flash_attention']} flash and "
            f"{launches['lru_scan']} lru_scan launches; {DECODE_S} "
            f"decode_steps in {dec_ms:.3f} ms; max abs logit error {err:.6g} "
            f"< {DECODE_TOL}; top-1 equal at all {clear} positions whose "
            f"top-2 margin > {2 * DECODE_TOL}")


def run_lm_serve(torch, args) -> str:
    import contextlib
    import io

    from repro_torch.launch import serve
    out = io.StringIO()
    argv = ["--arch", LM_ARCH, "--full", "--batch", "4", "--prompt-len",
            "12", "--gen-len", "24", "--seed", str(args.seed)]
    with contextlib.redirect_stdout(out):
        toks = serve.main(argv)
    check(tuple(toks.shape) == (4, 24), f"serve tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < 256000)).all()), "token ids out of "
                                                       "the vocab")
    torch.cuda.empty_cache()
    return (f"python -m repro_torch.launch.serve {' '.join(argv)}: "
            + " / ".join(out.getvalue().strip().splitlines()))


# --- training: lm_train, lm_grad, train_loop ------------------------------------

def train_step_launches(cfg, layout):
    """The launches one train step must make of each LM kernel: under
    remat "full" each repetition of the layout's unit runs its forward
    twice (the recompute), the prefix and suffix layers once, and every
    layer its backward once.  Flash serves every attention and MLA mixer,
    lru_scan every rglru."""
    n_pre, n_body = len(layout.prefix), len(layout.unit) * layout.reps
    blocks = cfg.blocks()
    body = blocks[n_pre:n_pre + n_body]
    rest = blocks[:n_pre] + blocks[n_pre + n_body:]

    def n(bs, mixers):
        return sum(m in mixers for m, _ in bs)
    twice = 2 if cfg.remat != "none" else 1
    return {"flash_attention": (twice * n(body, ATTENTION_MIXERS)
                                + n(rest, ATTENTION_MIXERS)),
            "flash_attention_bwd": n(blocks, ATTENTION_MIXERS),
            "lru_scan": twice * n(body, ("rglru",)) + n(rest, ("rglru",)),
            "lru_scan_bwd": n(blocks, ("rglru",))}


# the flash backward's device time in a profile, all of it and by kernel
FLASH_BWD_PROFILE = {"flash_attention_bwd": "flash_bwd",
                     "flash_bwd_dkdv": "flash_bwd_dkdv",
                     "flash_bwd_dq": "flash_bwd_dq",
                     "flash_bwd_reduce": "flash_bwd_reduce",
                     "flash_bwd_delta": "flash_bwd_delta"}


def run_lm_train(torch, args, dev):
    """recurrentgemma-2b at full width and depth, bf16, remat "full": 6
    ``make_train_step`` steps of B x S from ``data_stream(--seed)``, every
    count reset just before each step and read just after it; one more
    step under the profiler.  Keeps the first backward inputs of each
    backward kernel (for lm_timing)."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.lru_scan import kernel as lru_kernel
    from repro_torch.models import model as M
    from repro_torch.train.loop import data_stream
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = lm_config(torch.bfloat16)
    check(cfg.remat == "full", f"remat {cfg.remat}")
    t0 = time.perf_counter()
    params, opt = init_train_state(cfg, dev, seed=args.seed)
    torch.cuda.synchronize(dev)
    n_params = sum(p.numel() for p in params.parameters())
    layout = M.decompose(cfg.blocks())
    want = train_step_launches(cfg, layout)
    print(f"[lm_train] {cfg.name} full width and depth, {n_params} "
          f"parameters bf16, float32 moments, remat {cfg.remat} over "
          f"{layout.reps} x {[m for m, _ in layout.unit]} (suffix "
          f"{[m for m, _ in layout.suffix]}), batch {TRAIN_B} x seq "
          f"{TRAIN_S}; made in {time.perf_counter() - t0:.3f}s; launches a "
          f"step must make: {want}", flush=True)
    stream = data_stream(cfg, TRAIN_B, TRAIN_S, seed=args.seed, device=dev)
    step = make_train_step(cfg)
    flash_rec = FirstCall(flash_kernel.flash_attention_bwd)
    lru_rec = FirstCall(lru_kernel.lru_scan_bwd)
    flash_kernel.flash_attention_bwd = flash_rec
    lru_kernel.lru_scan_bwd = lru_rec
    torch.cuda.reset_peak_memory_stats(dev)
    losses, norms, times = [], [], []
    try:
        for i in range(TRAIN_STEPS):
            batch = next(stream)
            reset_all_counts()
            t1 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t1) * 1e3)
            launches, paths = read_counts()
            got = {k: launches[k] for k in want}
            check(got == want, f"train step {i}: launches {got} != {want}")
            check(all(p["ref"] == 0 for p in paths.values()),
                  f"train step {i}: a plain version ran: {paths}")
            losses.append(loss)
            norms.append(gnorm)
    finally:
        flash_kernel.flash_attention_bwd = flash_rec.fn
        lru_kernel.lru_scan_bwd = lru_rec.fn
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(x) for x in losses + norms),
          f"non-finite loss or grad_norm: {losses} {norms}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    profile = profile_device(
        torch, lambda: step(params, opt, next(stream)),
        {**FLASH_BWD_PROFILE, "flash_attention": "flash_attention",
         "lru_scan_bwd": "lru_scan_bwd_kernel",
         "lru_scan": "lru_scan_kernel"})
    print(f"[lm_train] losses {losses}; grad_norms {norms}; step ms "
          f"{[round(t, 3) for t in times]} (median of steps 1-"
          f"{TRAIN_STEPS - 1}: {steady:.3f} ms, "
          f"{TRAIN_B * TRAIN_S / steady * 1e3:.1f} tokens/s); "
          f"device_peak_bytes {peak}; launches a step {want}, 0 "
          f"plain-version calls", flush=True)
    print(f"[lm_train] profile of one more step: {profile}", flush=True)
    del params, opt, metrics
    torch.cuda.empty_cache()
    return {"flash_attention_bwd": (flash_rec.args,
                                    want["flash_attention_bwd"]),
            "lru_scan_bwd": (lru_rec.args, want["lru_scan_bwd"])}, {
        "step_ms": steady, "tokens_per_s": TRAIN_B * TRAIN_S / steady * 1e3,
        "device_peak_bytes": peak, "losses": losses}


class plain_versions:
    """Within it the model's attention and scan take the plain versions
    (``backend="ref"``), on any device: the comparison side of lm_grad."""

    def __enter__(self):
        import functools

        from repro_torch.models import attention, rglru
        self.saved = (attention.flash_attention, rglru.lru_scan)
        attention.flash_attention = functools.partial(self.saved[0],
                                                      backend="ref")
        rglru.lru_scan = functools.partial(self.saved[1], backend="ref")

    def __exit__(self, *exc):
        from repro_torch.models import attention, rglru
        attention.flash_attention, rglru.lru_scan = self.saved


def run_lm_grad(torch, args, dev) -> str:
    """Full width in float32, depth cut to one unit (rglru, rglru, local):
    the loss and every gradient leaf through the kernels against the same
    with the plain versions."""
    import dataclasses

    from repro_torch.models import model as M
    from repro_torch.train.loop import data_stream
    cfg = lm_config(torch.float32)
    unit = M.decompose(cfg.blocks()).unit
    cfg = dataclasses.replace(cfg, n_layers=len(unit))
    params = M.init_params(cfg, dev, seed=args.seed + 2).requires_grad_(True)
    batch = next(data_stream(cfg, 1, GRAD_S, seed=args.seed, device=dev))
    want = train_step_launches(cfg, M.decompose(cfg.blocks()))
    reset_all_counts()
    t0 = time.perf_counter()
    total, _ = M.loss_fn(params, batch, cfg)
    total.backward()
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    launches, paths = read_counts()
    check({k: launches[k] for k in want} == want,
          f"lm_grad launches {launches} != {want}")
    check(all(p["ref"] == 0 for p in paths.values()), f"plain ran: {paths}")
    got = {n: p.grad for n, p in params.named_parameters()}
    params.zero_grad(set_to_none=True)
    with plain_versions():
        ref_total, _ = M.loss_fn(params, batch, cfg)
        ref_total.backward()
    torch.cuda.synchronize(dev)
    launches, paths = read_counts()
    check(paths["flash_attention"]["ref"] > 0 and paths["lru_scan"]["ref"]
          > 0, f"the plain side missed a plain version: {paths}")
    loss, ref_loss = float(total.detach()), float(ref_total.detach())
    check(abs(loss - ref_loss) <= LOOP_TOL * abs(ref_loss),
          f"lm_grad losses {loss} != {ref_loss}")
    worst, worst_name = 0.0, None
    for name, p in params.named_parameters():
        scale = float(p.grad.abs().max())
        share = float((got[name] - p.grad).abs().max()) / (LM_GRAD_TOL *
                                                           scale)
        if share > worst:
            worst, worst_name = share, name
    check(worst <= 1.0, f"lm_grad: {worst_name} off by {worst} x its limit")
    n_leaves = len(got)
    del params, got, total, ref_total
    torch.cuda.empty_cache()
    return (f"{cfg.name} float32 full width, {cfg.n_layers} layers "
            f"{[m for m, _ in unit]} (remat {cfg.remat}), B 1 x S {GRAD_S}: "
            f"loss {loss!r} through the kernels, {ref_loss!r} through the "
            f"plain versions (difference {loss - ref_loss:.3g}, limit "
            f"{LOOP_TOL} relative); every one of {n_leaves} gradient leaves "
            f"within {LM_GRAD_TOL} of its max |g| (worst {worst:.4f} of the "
            f"limit, {worst_name}); loss + backward through the kernels "
            f"{ms:.3f} ms with launches {want}")


def plain_compressed_psum_check(torch, grads, before, mean, after):
    """Holds one ``compressed_psum`` call on the card to a plain
    recomputation of its definition, leaf by leaf, bit for bit: with x =
    g + e (float32) of every worker, one shared scale s = max|x| / 127
    (the float32 reciprocal of 127, as the reference compiles it), q =
    round-half-even(x / s) clipped to +-127, the mean sum_w q * s / P and
    each worker's residual x - q s computed exactly and rounded once.
    ``before`` holds the residuals the call was given, ``after`` those it
    left.  Returns (leaves, elements, max |residual|, max |mean|)."""
    inv127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))
    chunk = 1 << 26
    elements, res_max, mean_max = 0, 0.0, 0.0
    for name, g in grads.items():
        n = g.shape[0]
        top = max(float((g[w].float() + before[name][w]).abs().max())
                  for w in range(n))
        scale = torch.clamp(torch.tensor(top, dtype=torch.float32,
                                         device=g.device) * inv127,
                            min=1e-30)
        flat = g.reshape(n, -1)
        qsum = torch.zeros(flat.shape[1], dtype=torch.int32, device=g.device)
        for w in range(n):
            e0, e1 = before[name][w].reshape(-1), after[name][w].reshape(-1)
            for i in range(0, flat.shape[1], chunk):
                j = slice(i, i + chunk)
                x = flat[w, j].float() + e0[j]
                q = torch.round(x / scale).clamp_(-127, 127)
                qsum[j] += q.to(torch.int32)
                res = (x.double() - q.double() * scale.double()).float()
                check(torch.equal(res, e1[j]), f"compressed_psum {name}: "
                      f"worker {w}'s residual != the plain recomputation")
                res_max = max(res_max, float(res.abs().max()))
        want = (qsum.float() * scale / n).view(mean[name].shape)
        check(torch.equal(want, mean[name]), f"compressed_psum {name}: the "
              f"mean != the plain recomputation (max abs difference "
              f"{float((want - mean[name]).abs().max())})")
        elements += g.numel()
        mean_max = max(mean_max, float(want.abs().max()))
    return len(grads), elements, res_max, mean_max


class CheckedPsum:
    """Wraps ``compressed_psum`` during a run: call number ``at`` keeps a
    copy of the residuals it is given and is held to
    ``plain_compressed_psum_check``; the other calls pass through."""

    def __init__(self, torch, fn, at):
        self.torch, self.fn, self.at = torch, fn, at
        self.calls, self.report = 0, None

    def __call__(self, grads, error):
        self.calls += 1
        if self.calls != self.at:
            return self.fn(grads, error)
        before = {n: e.clone() for n, e in error.items()}
        mean, error = self.fn(grads, error)
        self.report = plain_compressed_psum_check(self.torch, grads, before,
                                                  mean, error)
        return mean, error


def run_train_loop(torch, args, dev) -> str:
    """``launch/train.py`` at full width, depth cut to one unit: an
    uninterrupted run, a run that checkpoints and fails at step 4, and its
    resume to step 8; then the compressed data-parallel trainer at P 4
    against the exact one."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    from repro_torch.configs.base import get_arch
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.models import model as M
    from repro_torch.train import dp_trainer
    from repro_torch.train.dp_trainer import init_error, make_compressed_dp_step
    from repro_torch.train.loop import data_stream
    from repro_torch.train.step import init_train_state
    unit = M.decompose(get_arch(LM_ARCH).blocks()).unit
    argv = ["--arch", LM_ARCH, "--full", "--layers", str(len(unit)),
            "--batch", "1", "--seq", str(LOOP_S), "--steps",
            str(LOOP_STEPS), "--device", str(dev), "--seed", str(args.seed)]
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(
            out):
        t0 = time.perf_counter()
        whole = launcher.main(argv)["losses"]
        torch.cuda.empty_cache()
        ckpt = ["--ckpt-dir", tmp, "--ckpt-every", str(LOOP_EVERY)]
        t1 = time.perf_counter()
        try:
            launcher.main(argv + ckpt + ["--fail-at", str(LOOP_FAIL)])
            failed = False
        except RuntimeError as exc:
            failed = f"injected failure at step {LOOP_FAIL}" in str(exc)
        torch.cuda.empty_cache()
        ckpt_bytes = sum(f.stat().st_size for f in Path(tmp).rglob("*")
                         if f.is_file())
        free = shutil.disk_usage(tmp).free
        t2 = time.perf_counter()
        resumed = launcher.main(argv + ckpt)["losses"]
        t3 = time.perf_counter()
        torch.cuda.empty_cache()
    check(failed, "the run with --fail-at did not fail as injected")
    check(f"resumed from step {LOOP_FAIL}" in out.getvalue(),
          "the resumed run did not resume from its checkpoint")
    check(len(resumed) == LOOP_STEPS - LOOP_FAIL,
          f"resumed run took {len(resumed)} steps")
    check(all(math.isfinite(x) for x in whole + resumed), "non-finite loss")
    worst = max(abs(a - b) / abs(b) for a, b in zip(resumed,
                                                    whole[LOOP_FAIL:]))
    check(worst <= LOOP_TOL, f"resumed losses {resumed} != uninterrupted "
                             f"{whole[LOOP_FAIL:]}")
    bit_equal = resumed == whole[LOOP_FAIL:]

    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=len(unit))
    mesh = make_worker_mesh(DP_P, dev)
    dp = {}
    psum = CheckedPsum(torch, dp_trainer.compressed_psum, DP_CHECK_CALL)
    t4 = time.perf_counter()
    dp_trainer.compressed_psum = psum
    try:
        for compress in (True, False):
            params, opt = init_train_state(cfg, dev, seed=args.seed)
            err = init_error(params, mesh)
            step = make_compressed_dp_step(cfg, mesh, compress=compress)
            stream = data_stream(cfg, DP_B, DP_S, seed=args.seed, device=dev)
            losses = []
            for _ in range(DP_STEPS):
                params, opt, err, metrics = step(params, opt, err,
                                                 next(stream))
                losses.append(float(metrics["loss"]))
            dp["compressed" if compress else "exact"] = losses
            del params, opt, err, metrics
            torch.cuda.empty_cache()
    finally:
        dp_trainer.compressed_psum = psum.fn
    t5 = time.perf_counter()
    check(psum.calls == DP_STEPS and psum.report is not None,
          f"compressed_psum ran {psum.calls} times in {DP_STEPS} compressed "
          f"steps, none held to the plain recomputation")
    leaves, elements, res_max, mean_max = psum.report
    for label, losses in dp.items():
        check(all(math.isfinite(x) for x in losses) and losses[-1] <
              losses[0], f"DP {label} did not train: {losses}")
    gap = abs(dp["compressed"][-1] - dp["exact"][-1])
    check(gap < DP_TOL, f"compressed DP {dp['compressed'][-1]} vs exact "
                        f"{dp['exact'][-1]}: gap {gap} >= {DP_TOL}")
    gaps = [round(abs(a - b), 6) for a, b in zip(dp["compressed"],
                                                 dp["exact"])]
    return (f"python -m repro_torch.launch.train {' '.join(argv)}: "
            f"uninterrupted losses {whole} in {t1 - t0:.3f}s; with "
            f"--ckpt-every {LOOP_EVERY} --fail-at {LOOP_FAIL} it failed as "
            f"injected after checkpointing {ckpt_bytes} B ({free} B free "
            f"there) in {t2 - t1:.3f}s, and resumed from step {LOOP_FAIL} to "
            f"{LOOP_STEPS} in {t3 - t2:.3f}s: losses {resumed}, within "
            f"{LOOP_TOL} relative of the uninterrupted run (worst {worst:.3g}"
            f", bit-equal {bit_equal}); compressed DP at P {DP_P} (B {DP_B} x "
            f"S {DP_S}, {DP_STEPS} steps) losses {dp['compressed']}, exact "
            f"{dp['exact']}: final gap {gap:.4f} < {DP_TOL} (gap by step "
            f"{gaps}), both in {t5 - t4:.3f}s; compressed_psum call "
            f"{DP_CHECK_CALL} bit-equal to the plain recomputation on all "
            f"{leaves} leaves ({elements} per-worker gradient elements, max "
            f"|residual| {res_max:.6g}, max |mean| {mean_max:.6g})")


# --- the nine other architectures: lm_archs ------------------------------------

# every architecture of configs/base.py but recurrentgemma-2b (phases 10-16),
# at published width, random weights from --seed
ARCHS = ("pixtral-12b", "smollm-360m", "gemma-7b", "granite-20b", "olmo-1b",
         "hubert-xlarge", "deepseek-v2-236b", "deepseek-moe-16b", "rwkv6-1.6b")
ATTENTION_MIXERS = ("attn", "local", "enc", "mla")
# prefill: cut from prefill_32k's B 32 x S 32 768 (as phase 10), S above
# FLASH_MIN_SEQ; at full depth where the bf16 parameters leave this much of
# the card free for the activations and the float32 temporaries of drawing
# the largest parameter (a DeepSeek-V2 MoE layer's w_gate: 5 GB twice)
ARCH_PREFILL_B, ARCH_PREFILL_S = 1, 4096
ARCH_PREFILL_MARGIN = 16e9
ARCH_DECODE_S = 1088                # >= 1 024: the forward takes flash
ARCH_DECODE_CF = 16.0               # MoE capacity with no drops (tests/test_models.py)
# decode against forward through an MoE layer: the router's probabilities on
# the two paths agree within this (float32 summation order), and a token
# whose chosen experts differ must be a tie that such a difference can
# flip: its forward k-th and (k+1)-th probabilities no further apart than
# twice the two paths' difference at that token (at DeepSeek-V2's width one
# token of 1 088 has them exactly equal in float32, where one rounding
# picks the other expert; tests/test_torch_mla_moe.py holds the tie order)
ROUTER_PROB_TOL = 1e-5
# one train step: cut from train_4k to B 1 x S 2 048, and in depth to what
# AdamW allows: bf16 parameters and gradients, float32 m and v (12 B a
# parameter) and the update's float32 temporaries, about 16 B a parameter,
# kept under about 48 GB
ARCH_TRAIN_B, ARCH_TRAIN_S = 1, 2048
ARCH_TRAIN_PARAMS = 3.0e9
# rwkv6's exact WKV recurrence is 2 048 host-launched steps a layer, run
# again under remat and backwards: its depth is cut for the smoke's time
ARCH_TRAIN_MAX_LAYERS = {"rwkv6-1.6b": 4}
# and its prefill makes about 200 000 launches, whose profile takes the
# profiler half a minute to read back: its profiled forward runs the first
# 4 layers (the same steps a layer, so the same idle share)
ARCH_PROFILE_LAYERS = {"rwkv6-1.6b": 4}
# the prefill inputs of the first attention layer kept for lm_timing: the
# new head dims, (80, 80) encoder and (192, 128) causal
ARCH_CAPTURE = ("hubert-xlarge", "deepseek-v2-236b")


def layer_params(torch, cfg):
    """(parameters outside the layers, each layer's), counted on the meta
    device."""
    from repro_torch.models import model as M
    lm = M.LM(cfg, torch.Generator(), torch.device("meta"))
    layers = [sum(p.numel() for p in b.parameters()) for b in lm.blocks]
    return sum(p.numel() for p in lm.parameters()) - sum(layers), layers


def n_attention(blocks) -> int:
    """The attention (flash) layers among ``blocks``."""
    return sum(m in ATTENTION_MIXERS for m, _ in blocks)


def moe_layers(cfg) -> int:
    return sum(f == "moe" for _, f in cfg.blocks())


def run_arch_prefill(torch, name, args, dev):
    """One bf16 prefill ``forward`` of B x S at full width, inside
    ``counted``; then one more under the profiler.  Returns (report,
    captured first flash inputs or None)."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models import model as M

    cfg = get_arch(name)
    torch.cuda.empty_cache()
    rest, layers = layer_params(torch, cfg)
    budget = torch.cuda.mem_get_info(dev)[0] - ARCH_PREFILL_MARGIN
    n, used = 0, 2 * rest
    for p in layers:
        if used + 2 * p > budget:
            break
        used, n = used + 2 * p, n + 1
    if name == "deepseek-v2-236b":
        check(n >= 3, f"{name}: {n} layers fit, fewer than the dense layer "
                      f"and two MoE layers")
    else:
        check(n == cfg.n_layers, f"{name}: only {n} of {cfg.n_layers} layers "
                                 f"fit beside a {ARCH_PREFILL_MARGIN:.0f} B "
                                 f"margin")
    cfg = dataclasses.replace(cfg, n_layers=n)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, dev, generator=gen)
    batch = M.make_dummy_batch(cfg, ARCH_PREFILL_B, ARCH_PREFILL_S, gen, dev)
    torch.cuda.synchronize(dev)
    made_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    n_attn = n_attention(cfg.blocks())

    def fwd():
        with torch.inference_mode():
            out = M.forward(params, batch, cfg)
        torch.cuda.synchronize(dev)
        return out

    rec = FirstCall(flash_kernel.flash_attention)
    flash_kernel.flash_attention = rec
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        t1 = time.perf_counter()
        (logits, aux), launches = counted(
            f"{name} prefill", fwd,
            kernels=("flash_attention",) if n_attn else ())
        cold_ms = (time.perf_counter() - t1) * 1e3
    finally:
        flash_kernel.flash_attention = rec.fn
    peak = torch.cuda.max_memory_allocated(dev)
    text = ARCH_PREFILL_S - (batch["patches"].shape[1]
                             if cfg.frontend == "patch" else 0)
    check(tuple(logits.shape) == (ARCH_PREFILL_B, text, cfg.vocab_size),
          f"{name}: prefill logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{name}: non-finite logits")
    check(launches.get("flash_attention", 0) == n_attn,
          f"{name}: {launches.get('flash_attention', 0)} flash launches for "
          f"{n_attn} attention layers")
    check(math.isfinite(float(aux)) and (float(aux) > 0) == bool(
        moe_layers(cfg)), f"{name}: aux {float(aux)}")
    aux = float(aux)
    del logits
    captured = None
    if name in ARCH_CAPTURE:      # normal tensors, off the inference mode
        (q, k, v), kw = rec.args
        captured = ((q.clone(), k.clone(), v.clone()), dict(kw))
    cut = dataclasses.replace(cfg, n_layers=ARCH_PROFILE_LAYERS.get(
        name, cfg.n_layers))

    def profiled():        # the first cut.n_layers layers of the same model
        with torch.inference_mode():
            M.forward(params, batch, cut)
        torch.cuda.synchronize(dev)
    profile = profile_device(torch, profiled, {"flash_attention":
                                               "flash_attention"},
                             host_ops=False)
    del params, batch
    torch.cuda.empty_cache()
    return {"layers": n, "of_layers": get_arch(name).n_layers,
            "parameters": n_params, "made_s": made_s, "cold_ms": cold_ms,
            "device_peak_bytes": peak, "launches": launches,
            "flash_launches": launches.get("flash_attention", 0),
            "attention_layers": n_attn, "aux": aux,
            "profiled_layers": cut.n_layers, "profile": profile}, captured


def run_arch_decode(torch, name, args, dev):
    """float32 at full width, depth cut to the prefix and one unit of the
    layout: ``forward`` of S 1 088 (flash) against token-by-token
    ``decode_step``; Pixtral prefills its patches through ``embeds=``."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.models import model as M

    cfg = get_arch(name)
    layout = M.decompose(cfg.blocks())
    cfg = dataclasses.replace(
        cfg, n_layers=len(layout.prefix) + len(layout.unit),
        param_dtype=torch.float32, compute_dtype=torch.float32,
        capacity_factor=ARCH_DECODE_CF if cfg.n_experts else
        cfg.capacity_factor)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    params = M.init_params(cfg, dev, generator=gen)
    batch = M.make_dummy_batch(cfg, 1, ARCH_DECODE_S, gen, dev)
    routes = RouteRecorder()

    def fwd():
        with torch.inference_mode():
            return M.forward(params, batch, cfg)[0]
    t0 = time.perf_counter()
    with routes:
        logits, launches = counted(f"{name} float32 forward", fwd,
                                   kernels=("flash_attention",)
                                   if n_attention(cfg.blocks()) else ())
    torch.cuda.synchronize(dev)
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_routes = routes.take()
    check(launches.get("flash_attention", 0) == n_attention(cfg.blocks()),
          f"{name}: float32 forward flash launches {launches}")
    top2 = torch.topk(logits, 2, dim=-1)
    margin = top2.values[..., 0] - top2.values[..., 1]
    cache = M.init_cache(cfg, 1, ARCH_DECODE_S, dev)
    pos = 0
    t0 = time.perf_counter()
    if cfg.frontend == "patch":
        with torch.inference_mode():
            emb = batch["patches"] @ params.frontend_proj.w
        for t in range(emb.shape[1]):
            _, cache = M.decode_step(params, cache, None, pos, cfg,
                                     embeds=emb[:, t:t + 1])
            pos += 1
    tokens = batch["tokens"]
    errs, top1 = [], []
    with routes:
        for i in range(tokens.shape[1]):
            lg, cache = M.decode_step(params, cache, tokens[:, i:i + 1], pos,
                                      cfg)
            pos += 1
            errs.append((lg[:, 0] - logits[:, i]).abs().max())
            top1.append(lg[0, 0].argmax())
    torch.cuda.synchronize(dev)
    dec_ms = (time.perf_counter() - t0) * 1e3
    errs, top1 = torch.stack(errs), torch.stack(top1)
    routing = router_ties(torch, cfg, fwd_routes, routes.take(), name)
    flipped = routing.pop("flipped")
    # the positions whose routing agrees (all of them without MoE)
    ok = ~flipped if flipped is not None else torch.ones_like(
        errs, dtype=torch.bool)
    err = float(errs[ok].max())
    sure = ok & (margin[0] > 2 * DECODE_TOL)
    clear = int(sure.sum())
    flips = int((sure & (top1 != top2.indices[0, :, 0])).sum())
    check(err < DECODE_TOL, f"{name}: decode vs forward max abs logit error "
                            f"{err} >= {DECODE_TOL}")
    check(flips == 0, f"{name}: {flips} top-1 ids differ where the "
                      f"forward's top-2 margin exceeds {2 * DECODE_TOL}")
    del params, cache, logits, top2, margin
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "fwd_ms": fwd_ms, "decode_steps": pos,
            "decode_ms": dec_ms, "max_abs_err": err,
            "max_abs_err_all": float(errs.max()), "top1_checked": clear,
            "capacity_factor": cfg.capacity_factor, **routing}


class RouteRecorder:
    """Within it every MoE routing (``models.moe.route``) keeps its router
    probabilities and chosen experts, in call order."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self.fn = moe.route

        def route(xt, router, k):
            out = self.fn(xt, router, k)
            self.calls.append((out[0].detach(), out[2].detach()))
            return out
        moe.route = route

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self.fn

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def router_ties(torch, cfg, fwd_calls, dec_calls, name):
    """The MoE routing of the forward (one call per MoE layer over every
    token) against decode's (one call per step and layer): the router
    probabilities within ROUTER_PROB_TOL, the forward without drops, and
    every token whose chosen experts differ a tie (see ROUTER_PROB_TOL).
    Returns the readings and ``flipped``, a boolean per position (None
    without MoE layers)."""
    n = len(fwd_calls)
    if n == 0:
        return {"flipped": None}
    k = cfg.moe_top_k
    flipped, worst, ties = None, 0.0, []
    for layer in range(n):
        fp, fi = fwd_calls[layer]
        dp = torch.cat([p for p, _ in dec_calls[layer::n]])
        di = torch.cat([i for _, i in dec_calls[layer::n]])
        t = fp.shape[0]
        cap = math.ceil(t * k / cfg.n_experts * cfg.capacity_factor)
        most = int(torch.bincount(fi.reshape(-1), minlength=cfg.n_experts)
                   .max())
        check(most <= cap, f"{name}: the forward dropped assignments ({most} "
                           f"to one expert, capacity {cap})")
        delta = (fp - dp).abs().max(dim=-1).values
        worst = max(worst, float(delta.max()))
        differ = (fi.sort(-1).values != di.sort(-1).values).any(-1)
        ranked = fp.sort(-1, descending=True).values
        gap = ranked[:, k - 1] - ranked[:, k]
        unexplained = differ & (gap > 2 * delta)
        check(not bool(unexplained.any()),
              f"{name}: layer {layer}: routing differs at positions "
              f"{unexplained.nonzero().flatten().tolist()[:8]} where no "
              f"tie explains it")
        ties += [{"layer": layer, "position": int(i), "gap": float(gap[i]),
                  "prob_delta": float(delta[i])}
                 for i in differ.nonzero().flatten().tolist()]
        flipped = differ if flipped is None else flipped | differ
    check(worst < ROUTER_PROB_TOL, f"{name}: router probabilities differ by "
                                   f"{worst} between forward and decode")
    if ties:   # a flip changes the outputs of the later layers at its token
        check(cfg.blocks()[-1][1] == "moe" and n == 1,
              f"{name}: a routing tie in a layer other than the last")
    return {"flipped": flipped, "router_prob_max_delta": worst,
            "routing_ties": ties}


def run_arch_train(torch, name, args, dev):
    """bf16, remat "full", B 1 x S 2 048: two ``make_train_step`` steps at
    full width and the depth AdamW's state allows, each inside ``counted``.
    DeepSeek-V2, where not one MoE layer fits beside AdamW's state, also
    takes the gradient of its dense layer and one MoE layer (no update)."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.models import model as M
    from repro_torch.train.loop import data_stream
    from repro_torch.train.step import init_train_state, make_train_step

    full = get_arch(name)
    check(full.remat == "full", f"{name}: remat {full.remat}")
    rest, layers = layer_params(torch, full)
    n, used = 0, rest
    for p in layers[:ARCH_TRAIN_MAX_LAYERS.get(name, len(layers))]:
        if used + p > ARCH_TRAIN_PARAMS:
            break
        used, n = used + p, n + 1
    check(n >= 1, f"{name}: no layer fits beside AdamW's state")
    cfg = dataclasses.replace(full, n_layers=n)
    want = train_step_launches(cfg, M.decompose(cfg.blocks()))
    params, opt = init_train_state(cfg, dev, seed=args.seed)
    stream = data_stream(cfg, ARCH_TRAIN_B, ARCH_TRAIN_S, seed=args.seed,
                         device=dev)
    step = make_train_step(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, auxes, times = [], [], []
    for i in range(2):
        batch = next(stream)

        def one():
            out = step(params, opt, batch)
            torch.cuda.synchronize(dev)
            return out
        t1 = time.perf_counter()
        (_, opt, metrics), launches = counted(
            f"{name} train step {i}", one,
            kernels=tuple(k for k, v in want.items() if v))
        times.append((time.perf_counter() - t1) * 1e3)
        got = {k: launches.get(k, 0) for k in want}
        check(got == want, f"{name} train step {i}: launches {got} != {want}")
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["aux"]))
        check(math.isfinite(losses[-1]) and math.isfinite(
            float(metrics["grad_norm"])), f"{name}: non-finite step {i}")
        check((auxes[-1] > 0) == bool(moe_layers(cfg)),
              f"{name}: aux {auxes[-1]} with {moe_layers(cfg)} MoE layers")
    peak = torch.cuda.max_memory_allocated(dev)
    out = {"layers": n, "parameters": sum(p.numel() for p in
                                          params.parameters()),
           "losses": losses, "aux": auxes, "step_ms": times,
           "device_peak_bytes": peak, "launches": want}
    if want["flash_attention_bwd"]:   # one more step, profiled
        batch = next(stream)
        out["profile"] = profile_device(
            torch, lambda: step(params, opt, batch),
            {**FLASH_BWD_PROFILE, "flash_attention": "flash_attention"},
            host_ops=False)
    del params, opt, metrics
    torch.cuda.empty_cache()
    if moe_layers(cfg) == 0 and full.n_experts:
        cfg2 = dataclasses.replace(full, n_layers=full.first_k_dense + 1)
        params = M.init_params(cfg2, dev, seed=args.seed)
        params.requires_grad_(True)
        batch = next(data_stream(cfg2, ARCH_TRAIN_B, ARCH_TRAIN_S,
                                 seed=args.seed, device=dev))

        def grad():
            total, metrics = M.loss_fn(params, batch, cfg2)
            total.backward()
            torch.cuda.synchronize(dev)
            return metrics
        metrics, launches = counted(f"{name} gradient with a MoE layer", grad,
                                    kernels=("flash_attention_bwd",))
        check(launches.get("flash_attention_bwd", 0) == n_attention(cfg2.blocks()),
              f"{name}: gradient launches {launches}")
        finite = all(bool(torch.isfinite(p.grad).all())
                     for p in params.parameters() if p.grad is not None)
        moe_grad = float(params.blocks[-1].ffn.w_gate.grad.float().abs()
                         .max())
        loss, aux = float(metrics["loss"].detach()), float(
            metrics["aux"].detach())
        check(finite and aux > 0 and moe_grad > 0,
              f"{name}: gradient with a MoE layer: finite {finite}, aux "
              f"{aux}, max |dw_gate| {moe_grad}")
        out["moe_gradient"] = {"layers": cfg2.n_layers, "loss": loss,
                               "aux": aux,
                               "max_abs_w_gate_grad": moe_grad,
                               "launches": launches}
        del params
        torch.cuda.empty_cache()
    return out


def run_lm_archs(torch, args, dev):
    """Each of the nine architectures: prefill, decode against forward and a
    train step.  Returns (the flash launches of the prefills and the flash
    backward launches of one train step each, the captured flash inputs by
    architecture)."""
    from repro_torch.configs.base import get_arch
    captured = {}
    launches = {"flash_attention": 0, "flash_attention_bwd": 0}
    for name in ARCHS:
        t0 = time.perf_counter()
        prefill, cap = run_arch_prefill(torch, name, args, dev)
        if cap is not None:
            captured[name] = cap
        launches["flash_attention"] += prefill["flash_launches"]
        print(f"[lm_archs] {name} prefill: {json.dumps(prefill)}",
              flush=True)
        if get_arch(name).has_decode():
            decode = run_arch_decode(torch, name, args, dev)
            print(f"[lm_archs] {name} decode vs forward: "
                  f"{json.dumps(decode)}", flush=True)
        else:
            print(f"[lm_archs] {name} decode: none (encoder-only: no decode "
                  f"step)", flush=True)
        train = run_arch_train(torch, name, args, dev)
        launches["flash_attention_bwd"] += train["launches"][
            "flash_attention_bwd"]
        print(f"[lm_archs] {name} train: {json.dumps(train)}; "
              f"{time.perf_counter() - t0:.3f}s for the architecture",
              flush=True)
    return launches, captured


def time_arch_flash(torch, captured):
    """flash_attention and its backward at a captured prefill input of a new
    head dim: the forward held to its plain version by phase 3's rule and by
    the one-rounding rule, two calls bit-equal, timed (``time_flash``); the
    backward on the kernel's own o and lse with a dO drawn from a fixed
    seed, held and timed as lm_train's (``time_flash_bwd``), the plain
    version in its default 512-row blocks."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ops as flash_ops
    (q, k, v), kw = captured
    causal, window = kw["causal"], kw["window"]
    err, tol, ok = flash_err(torch, flash_ops, q, k, v, causal, window)
    check(ok, f"flash at {list(q.shape)}/{list(v.shape)}: kernel != plain "
              f"by phase 3's rule (max abs err {err}, tolerance {tol})")
    first, again = (flash_kernel.flash_attention(q, k, v, **kw)
                    for _ in range(2))
    check(torch.equal(first, again), "flash: two calls differ")
    del first, again
    err, tol, fwd = time_flash(torch, captured)
    fwd.update({"max_abs_err": err, "tolerance": tol,
                "phase3_rule_held": True, "repeat_equal": True})
    o, lse = flash_kernel.flash_attention(q, k, v, lse=True, **kw)
    gen = torch.Generator(device=q.device).manual_seed(1234)
    do = torch.randn(o.shape, generator=gen, device=q.device).to(q.dtype)
    err_b, tol_b, bwd = time_flash_bwd(
        torch, ((q, k, v, o, lse, do), kw), plain_blocks=(512, 512))
    bwd.update({"max_abs_err": err_b, "tolerance": tol_b,
                "do": "N(0, 1) from seed 1234"})
    return fwd, bwd


def band_mask(torch, sq, skv, causal, window, device):
    """[Sq, Skv] boolean: the pairs the kernels' mask keeps."""
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(skv, device=device)[None, :]
    mask = j < skv
    if causal or window is not None:
        mask = mask & (i - j >= 0)
        if window is not None:
            mask = mask & (i - j < window)
    return mask


def band_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs inside the mask: the work the inputs need."""
    if window is None and not causal:
        return sq * skv
    total = 0
    for i in range(sq):
        hi = min(i, skv - 1)
        lo = 0 if window is None else max(0, i - window + 1)
        total += max(0, hi - lo + 1)
    return total


def time_flash(torch, captured):
    from repro_torch.kernels.flash_attention import ops as flash_ops
    (q, k, v), kw = captured[0], captured[1]
    causal, window = kw["causal"], kw["window"]
    got, want = flash_pair(torch, flash_ops, q, k, v, causal, window)
    diff, mag = (got - want).abs(), want.abs()
    mean_abs = float(mag.mean())
    if q.dtype == torch.bfloat16:
        rel, atol = CAPTURED_BF16_REL, CAPTURED_BF16_ABS_OF_MEAN * mean_abs
    else:
        rel = atol = FLASH_TOL["float32"]
    limit = atol + rel * mag
    err, share = float(diff.max()), float((diff / limit).max())
    tol = {"rule": "|kernel - plain| <= rel |plain| + abs", "rel": rel,
           "abs": atol}
    del got, want, diff, mag, limit
    check(share <= 1.0, f"flash at the prefill's inputs {list(q.shape)}: "
                        f"kernel != plain (max abs err {err}, mean |plain| "
                        f"{mean_abs}, tolerance {tol}, worst error "
                        f"{share} x its limit)")
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = v.shape[1], v.shape[2], v.shape[3]
    ms = median_ms(torch, lambda: flash_ops.flash_attention(
        q, k, v, causal=causal, window=window))
    plain = median_ms(torch, lambda: flash_ops.flash_attention(
        q, k, v, causal=causal, window=window, backend="ref"), iters=5,
        warmup=1)
    # the library yardstick: scaled_dot_product_attention with the same band
    # mask, heads first, kv heads expanded (prepared outside the timing)
    import torch.nn.functional as F
    mask = band_mask(torch, Sq, Skv, causal, window, q.device)
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    lib = median_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
    pairs = band_pairs(Sq, Skv, causal, window)
    ops_ = 2.0 * B * H * pairs * (D + Dv)
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                 + B * Sq * H * Dv)
    dtype = str(q.dtype).split(".")[-1]
    t_ops = ops_ / PEAK_OPS_PER_S[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return err, tol, {
        "mean_abs_plain": mean_abs, "max_err_over_limit": share,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
        "library": "torch.nn.functional.scaled_dot_product_attention with "
                   "the band as a boolean mask",
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "band_flops": ops_, "bytes": nbytes,
        "shape": {"q": list(q.shape), "k": list(k.shape),
                  "v": list(v.shape), "causal": causal, "window": window,
                  "dtype": dtype}}


def lru_bound(a):
    """(bound ms, bound_by, bytes) of one scan of ``a``'s shape: a and b read
    once, h written once, at 3.35 TB/s, against one multiply-add an element
    at the float32 rate."""
    nbytes = 3 * a.numel() * a.element_size()
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2.0 * a.numel() / PEAK_SCALAR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def time_lru(torch, captured):
    """lru_scan at the prefill's first rglru inputs: within 1e-5 of the
    plain version, two calls bit-equal, timed beside its bound (one call, as
    every kernel is timed, and per call of 20 back to back); then the
    kernel on two controls of the same width: B 4 x S 8 192 (four times the
    blocks) and a long-memory input (a in [0.999, 1)); and one ``torch.add``
    of the same inputs, which moves the same bytes.  The chunk, tile,
    tickets and scratch are what the built library reports."""
    from repro_torch.kernels.lru_scan import kernel as lru_kernel
    from repro_torch.kernels.lru_scan import ops as lru_ops
    (a, b), _ = captured
    err, tol, share = lru_err(torch, lru_ops, a, b)
    check(share <= 1.0, f"lru_scan at the prefill's inputs {list(a.shape)}: "
                        f"kernel != plain (max abs err {err}, tolerance "
                        f"{tol}, worst error {share} x its limit)")
    first, second = lru_ops.lru_scan(a, b), lru_ops.lru_scan(a, b)
    torch.cuda.synchronize()
    check(torch.equal(first, second), "lru_scan at the prefill's inputs: "
                                      "two calls differ")
    del first, second
    ms = median_ms(torch, lambda: lru_ops.lru_scan(a, b))
    per_call = median_ms(torch, lambda: lru_ops.lru_scan(a, b), iters=10,
                         calls=20)
    plain = median_ms(torch, lambda: lru_ops.lru_scan(a, b, backend="ref"),
                      iters=5, warmup=1)
    bound, bound_by, nbytes = lru_bound(a)
    B, S, W = a.shape
    gen = torch.Generator(device=a.device).manual_seed(7)
    a4 = torch.rand((4, S, W), generator=gen, device=a.device,
                    dtype=a.dtype) * 0.1 + 0.9
    b4 = torch.randn((4, S, W), generator=gen, device=a.device,
                     dtype=a.dtype)
    b4_ms = median_ms(torch, lambda: lru_ops.lru_scan(a4, b4))
    b4_bound, _, b4_bytes = lru_bound(a4)
    long_a = torch.rand(a.shape, generator=gen, device=a.device,
                        dtype=a.dtype) * 1e-3 + 0.999
    long_ms = median_ms(torch, lambda: lru_ops.lru_scan(long_a, b))
    # what moving the same bytes takes: one elementwise add (reads a and b
    # once, writes one output), a yardstick of the card's rate, not the
    # recurrence
    out = torch.empty_like(a)
    add_ms = median_ms(torch, lambda: torch.add(a, b, out=out))
    add_per_call = median_ms(torch, lambda: torch.add(a, b, out=out),
                             iters=10, calls=20)
    del a4, b4, long_a, out
    torch.cuda.empty_cache()
    geometry = lru_kernel.geometry(a.dtype, B, S, W)
    return err, tol, {
        "max_err_over_limit": share,
        "ms": ms, "kernel_ms": ms, "per_call_ms": per_call,
        "plain_ms": plain, "library_ms": None,
        "library": "none: no single PyTorch call computes the recurrence "
                   "(torch.cumsum/cumprod compute other functions)",
        "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
        "gb_per_s": nbytes / ms / 1e6,
        "per_call_gb_per_s": nbytes / per_call / 1e6,
        "peak_share": nbytes / ms / 1e-3 / PEAK_BYTES_PER_S,
        "per_call_peak_share": nbytes / per_call / 1e-3 / PEAK_BYTES_PER_S,
        "repeat_equal": True,
        **{k: geometry[k] for k in ("chunk_steps", "sub_steps",
                                    "tile_channels", "tickets")},
        "scratch_bytes": 4 * geometry["scratch_words"],
        "b4_ms": b4_ms, "b4_bound_ms": b4_bound,
        "b4_gb_per_s": b4_bytes / b4_ms / 1e6,
        "long_memory_ms": long_ms, "same_bytes_add_ms": add_ms,
        "same_bytes_add_per_call_ms": add_per_call,
        "shape": {"a": list(a.shape), "dtype": str(a.dtype).split(".")[-1]}}


def fwd_bwd_ms(torch, fn, inputs, g, iters=5, warmup=1):
    """(forward + backward ms, forward ms) of ``fn`` on fresh leaf copies
    of ``inputs`` with output gradient ``g``: a backward's time is their
    difference."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]

    def both():
        for t in leaves:
            t.grad = None
        fn(*leaves).backward(g)

    def fwd():
        with torch.no_grad():
            fn(*leaves)
    return (median_ms(torch, both, iters=iters, warmup=warmup),
            median_ms(torch, fwd, iters=iters, warmup=warmup))


def unit_scaled(t):
    """(t times the power of two that brings max |t| into [0.5, 1), that
    power's exponent): exact in float32 and bfloat16."""
    exponent = -math.frexp(float(t.abs().max()))[1]
    return t * 2.0 ** exponent, exponent


def dense_flash_bwd(torch, q, k, v, o, lse, do, causal, window):
    """K3b's formula in dense float32 matrices, every head at once: P =
    exp(scale q.k - lse) inside the mask, delta = rowsum(dO o), dV = P^T
    dO, dS = P (dO v^T - delta), dK = scale dS^T q, dQ = scale dS k; dK and
    dV summed over the heads of each kv group.  Returns (dq, dk, dv) in
    float32, laid out as q, k, v."""
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = v.shape[1], v.shape[2], v.shape[3]
    grp, scale = H // Hkv, 1.0 / math.sqrt(D)

    def heads(t, expand=1):
        return t.float().transpose(1, 2).repeat_interleave(expand, dim=1)
    qf, of, dof = heads(q), heads(o), heads(do)
    kf, vf = heads(k, grp), heads(v, grp)
    mask = band_mask(torch, Sq, Skv, causal, window, q.device)
    p = torch.where(mask, torch.exp(scale * (qf @ kf.transpose(-1, -2))
                                    - lse[..., None]), 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    del p
    dq = scale * (ds @ kf)
    dk = scale * (ds.transpose(-1, -2) @ qf)
    del ds

    def fold(t):
        return t.view(B, Hkv, grp, Skv, -1).sum(2).transpose(1, 2)
    return dq.transpose(1, 2), fold(dk), fold(dv)


def shares(torch, got, want, rel, abs_of_max):
    """Per tensor (dq, dk, dv): the readings of ``got`` against ``want``
    under |got - want| <= rel |want| + abs_of_max max|want|."""
    out = {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = a.float(), w.float()
        check(bool(torch.isfinite(a).all()), f"non-finite {name}")
        top = float(w.abs().max())
        d = (a - w).abs()
        out[name] = {
            "max_abs_want": top, "max_abs_err": float(d.max()),
            # the least absolute term, as a share of max |want|, that this
            # run needs beside the relative one
            "least_abs_of_max": float((d - rel * w.abs()).clamp(min=0).max())
            / top,
            "share": float((d / (rel * w.abs() + abs_of_max * top)).max())}
    return out


def captured_flash_bwd_check(torch, q, k, v, o, lse, g, causal, window,
                             plain_blocks=(64, 32)):
    """The bf16 backward kernel at lm_train's inputs with output gradient
    ``g`` (already unit-scaled), held (1) to its formula in dense float32
    and (2) through the autograd op to the plain version's autograd (see
    FORMULA_BWD_REL and CAPTURED_BWD_REL), two calls bit-equal; zeros and
    the formula with the band cut by BAND_CUT keys must break limit (1) in
    every tensor.  Returns (readings, worst share, bit-equal)."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ops as flash_ops
    kw = dict(causal=causal, window=window)
    got = flash_kernel.flash_attention_bwd(q, k, v, o, lse, g, **kw)
    again = flash_kernel.flash_attention_bwd(q, k, v, o, lse, g, **kw)
    dense = dense_flash_bwd(torch, q, k, v, o, lse, g, causal, window)
    formula = shares(torch, got, dense, FORMULA_BWD_REL, FLASH_GRAD_TOL)
    for name, w in zip(("dq", "dk", "dv"), dense):
        formula[name]["zeros_share"] = float(
            (w.abs() / (FORMULA_BWD_REL * w.abs() + FLASH_GRAD_TOL
                        * w.abs().max())).max())
    equal = all(torch.equal(a, b) for a, b in zip(got, again))
    del got, again
    if window is not None and window > BAND_CUT:
        cut = dense_flash_bwd(torch, q, k, v, o, lse, g, causal,
                              window - BAND_CUT)
        for name, r in shares(torch, cut, dense, FORMULA_BWD_REL,
                              FLASH_GRAD_TOL).items():
            formula[name]["band_cut_share"] = r["share"]
        del cut
    del dense
    op, op_again = (grads_of(lambda *t: flash_ops.flash_attention(*t, **kw),
                             (q, k, v), g) for _ in range(2))
    plain = grads_of(lambda *t: flash_ops.flash_attention(
        *t, block_q=plain_blocks[0], block_k=plain_blocks[1], backend="ref",
        **kw), (q, k, v), g)
    autograd = shares(torch, op, plain, CAPTURED_BWD_REL,
                      CAPTURED_BWD_ABS_OF_MAX)
    equal = equal and all(torch.equal(a, b) for a, b in zip(op, op_again))
    torch.cuda.synchronize()
    for name, r in formula.items():
        check(r["zeros_share"] > 1.0 and r.get("band_cut_share", 2.0) > 1.0,
              f"flash backward at lm_train's inputs: limit (1) cannot fail "
              f"in {name}: {r}")
    share = max(r["share"] for r in (*formula.values(), *autograd.values()))
    return {"formula": formula, "autograd": autograd}, share, equal


def bwd_design(q, v, causal, window) -> dict:
    """K3b's bf16 design at these inputs: its name, what it launches (head
    splits, the dK/dV and dQ grids, threads, shared bytes and blocks an SM
    of each kernel, the partials' scratch) and ptxas's registers and spills
    of the two instantiations it runs, from this run's build."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    D, Dv = q.shape[-1], v.shape[-1]
    plan = flash_kernel.bwd_plan(q, v, causal=causal, window=window)
    ptxas = {}
    for prefix in BF16_BWD_KERNELS:
        name = f"{prefix}<{D},{Dv}>"
        r = PTXAS[name]      # build_report checked every instantiation
        ptxas[name] = {"registers": r[0], "spill_store_bytes": r[1],
                       "spill_load_bytes": r[2]}
    return {"design": plan.pop("design"), "launch": plan, "ptxas": ptxas}


def time_flash_bwd(torch, captured, plain_blocks=(64, 32)):
    """The backward kernel at lm_train's first backward call (the last
    local layer's q, k, v, o, lse and dO), that dO brought to a unit max by
    a power of two: against its dense float32 formula, with the limit shown
    able to fail there, and through autograd against the plain version's
    (``captured_flash_bwd_check``), two calls bit-equal; then timed on the
    dO as captured: the
    kernel, the plain version's backward and
    ``scaled_dot_product_attention``'s backward with the same band mask
    (each forward + backward minus its forward), and the bound: the band's
    backward operations, 2.5 x the forward's, at the bf16 peak."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ops as flash_ops
    (q, k, v, o, lse, do), kw = captured
    causal, window = kw["causal"], kw["window"]
    g, exponent = unit_scaled(do)
    readings, share, equal = captured_flash_bwd_check(
        torch, q, k, v, o, lse, g, causal, window, plain_blocks)
    err = max(r["max_abs_err"] for part in readings.values()
              for r in part.values())
    check(share <= 1.0 and equal,
          f"flash backward at lm_train's inputs {list(q.shape)}: kernel != "
          f"plain (worst {share} x its limit, repeat bit-equal {equal}; "
          f"{readings})")
    print(f"[flash_attention_bwd_check] at lm_train's inputs, dO x 2^"
          f"{exponent}: (1) against its formula in dense float32 within "
          f"{FORMULA_BWD_REL} |dense| + {FLASH_GRAD_TOL} max|dense|, (2) "
          f"through autograd against the plain version's within "
          f"{CAPTURED_BWD_REL} |plain| + {CAPTURED_BWD_ABS_OF_MAX} "
          f"max|plain|; worst {share:.4f} of its limit, repeat bit-equal; "
          f"readings {json.dumps(readings)}", flush=True)
    ms = median_ms(torch, lambda: flash_kernel.flash_attention_bwd(
        q, k, v, o, lse, do, causal=causal, window=window))
    # the CUDA-core design on the same card: the float32 instantiation (the
    # kernels the bf16 path ran before) on float32 copies of the inputs
    f32 = [t.float() for t in (q, k, v, o, do)]
    cuda_core_ms = median_ms(torch, lambda: flash_kernel.flash_attention_bwd(
        *f32[:4], lse, f32[4], causal=causal, window=window), iters=5,
        warmup=1)
    del f32
    both, fwd = fwd_bwd_ms(torch, lambda *t: flash_ops.flash_attention(
        *t, causal=causal, window=window, backend="ref"), (q, k, v), do)
    import torch.nn.functional as F
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = v.shape[1], v.shape[2], v.shape[3]
    mask = band_mask(torch, Sq, Skv, causal, window, q.device)
    heads = [q.transpose(1, 2).contiguous(),
             k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous(),
             v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()]
    lib_both, lib_fwd = fwd_bwd_ms(
        torch, lambda *t: F.scaled_dot_product_attention(*t, attn_mask=mask),
        heads, do.transpose(1, 2).contiguous(), iters=10, warmup=2)
    pairs = band_pairs(Sq, Skv, causal, window)
    ops_ = 2.5 * 2.0 * B * H * pairs * (D + Dv)
    nbytes = (q.element_size() * 2 * (q.numel() + k.numel() + v.numel()
                                      + do.numel()) + 4 * 2 * lse.numel())
    dtype = str(q.dtype).split(".")[-1]
    t_ops = ops_ / PEAK_OPS_PER_S[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return err, {"rule": "per tensor, dO scaled to a unit max: |kernel - "
                         "dense formula| <= rel |dense| + abs_of_max "
                         "max|dense|; |autograd op - plain autograd| <= "
                         "op_rel |plain| + op_abs_of_max max|plain|",
                 "rel": FORMULA_BWD_REL, "abs_of_max": FLASH_GRAD_TOL,
                 "op_rel": CAPTURED_BWD_REL,
                 "op_abs_of_max": CAPTURED_BWD_ABS_OF_MAX}, {
        "max_err_over_limit": share, "repeat_equal": equal,
        "do_scaled_by_pow2": exponent, "check_readings": readings,
        **bwd_design(q, v, causal, window),
        "ms": ms, "kernel_ms": ms,
        "cuda_core_f32_ms": cuda_core_ms,
        "cuda_core_f32": "the float32 instantiation's CUDA-core kernels on "
                         "float32 copies of the same inputs, this run",
        "plain_ms": both - fwd,
        "plain_fwd_bwd_ms": both, "plain_fwd_ms": fwd,
        "library_ms": lib_both - lib_fwd, "library_fwd_bwd_ms": lib_both,
        "library_fwd_ms": lib_fwd,
        "library": "torch.nn.functional.scaled_dot_product_attention "
                   "forward + backward with the band as a boolean mask, "
                   "minus its forward",
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "band_flops": ops_, "bytes": nbytes, "note": NO_PALLAS,
        "launches_per": "train step",
        "shape": {"q": list(q.shape), "k": list(k.shape),
                  "v": list(v.shape), "causal": causal, "window": window,
                  "dtype": dtype}}


def plain_lru_bwd(a, h, dh):
    """The scan's gradient by the plain loop (``lru_scan/ref.py``) run
    backwards: g = the scan of (a[t + 1], dh) from the end, db = g,
    da = g h[t - 1]."""
    import torch

    from repro_torch.kernels.lru_scan import ref
    coef = torch.zeros_like(a)
    coef[:, :-1] = a[:, 1:]
    g = ref.lru_scan(coef.flip(1), dh.flip(1)).flip(1)
    prev = torch.zeros_like(h)
    prev[:, 1:] = h[:, :-1]
    return g * prev, g


def time_lru_bwd(torch, captured):
    """The reverse-scan kernel at lm_train's first backward call (the last
    rglru layer's a, h and dh): against the plain loop run backwards within
    1e-5 max|g| + 1e-5 |g|, two calls bit-equal, then timed beside the
    bound: 5 B*S*W elements (a, h, dh read, da, db written) at 3.35 TB/s."""
    from repro_torch.kernels.lru_scan import kernel as lru_kernel
    (a, h, dh), _ = captured
    got = lru_kernel.lru_scan_bwd(a, h, dh)
    again = lru_kernel.lru_scan_bwd(a, h, dh)
    want = plain_lru_bwd(a, h, dh)
    err, share, equal = grad_err(
        torch, got, again, want,
        lambda w: LRU_TOL * w.abs().max() + LRU_TOL * w.abs())
    check(share <= 1.0 and equal,
          f"lru_scan backward at lm_train's inputs {list(a.shape)}: kernel "
          f"!= plain (max abs err {err}, worst {share} x its limit, repeat "
          f"bit-equal {equal})")
    del got, again, want
    ms = median_ms(torch, lambda: lru_kernel.lru_scan_bwd(a, h, dh))
    plain = median_ms(torch, lambda: plain_lru_bwd(a, h, dh), iters=5,
                      warmup=1)
    nbytes = 5 * a.numel() * a.element_size()
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 3.0 * a.numel() / PEAK_SCALAR_OPS_PER_S * 1e3
    return err, {"rule": "|kernel - plain| <= 1e-5 max|plain| + 1e-5 "
                         "|plain|"}, {
        "max_err_over_limit": share, "repeat_equal": equal,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain, "library_ms": None,
        "library": "none: no single PyTorch call computes the recurrence "
                   "or its gradient",
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "gb_per_s": nbytes / ms / 1e6, "note": NO_PALLAS,
        "launches_per": "train step",
        "shape": {"a": list(a.shape), "dtype": str(a.dtype).split(".")[-1]}}


# K3b's head splits are timed at lm_train's shape and at lm_archs' GQA/MQA
# training shapes (B 1 x S 2 048, causal): (architecture, H, Hkv, D, S,
# window)
SPLIT_SHAPES = (("recurrentgemma-2b", 10, 1, 256, 4096, 2048),
                ("granite-20b", 48, 1, 128, 2048, None),
                ("pixtral-12b", 32, 8, 128, 2048, None),
                ("smollm-360m", 15, 5, 64, 2048, None))


def head_split_sweep(torch, dev) -> list:
    """K3b's bf16 time at every head split (each divisor of the kv group),
    beside the one ``kernel.head_splits`` picks, at each of
    ``SPLIT_SHAPES`` on bf16 N(0, 1) inputs from a seed."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    gen = torch.Generator().manual_seed(1234)
    out = []
    for arch, H, Hkv, D, S, window in SPLIT_SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen).to(dev).bfloat16()
                       for shape in ((1, S, H, D), (1, S, Hkv, D),
                                     (1, S, Hkv, D), (1, S, H, D)))
        o, lse = flash_kernel.flash_attention(q, k, v, causal=True,
                                              window=window, lse=True)
        picked = flash_kernel.bwd_plan(q, v, causal=True,
                                       window=window)["head_splits"]
        group, pick, ms = H // Hkv, flash_kernel.head_splits, {}
        try:
            for n in (n for n in range(1, group + 1) if group % n == 0):
                flash_kernel.head_splits = lambda *_, n=n: n
                ms[n] = median_ms(torch, lambda: flash_kernel.
                                  flash_attention_bwd(q, k, v, o, lse, do,
                                                      causal=True,
                                                      window=window))
        finally:
            flash_kernel.head_splits = pick
        best = min(ms, key=ms.get)
        out.append({"architecture": arch, "q": [1, S, H, D],
                    "kv_heads": Hkv, "window": window, "picked": picked,
                    "picked_ms": ms[picked], "best": best,
                    "best_ms": ms[best], "ms_by_splits": ms})
        print(f"[flash_attention_bwd_head_splits] {arch} q {[1, S, H, D]} "
              f"kv heads {Hkv}: picked {picked} splits, {ms[picked]:.4f} ms;"
              f" fastest {best}, {ms[best]:.4f} ms; by splits "
              f"{ {n: round(t, 4) for n, t in ms.items()} }", flush=True)
        del q, k, v, do, o, lse
    return out


def lm_timing(torch, captured, case_errs):
    report = []
    for name, timer in (("flash_attention", time_flash),
                        ("lru_scan", time_lru),
                        ("flash_attention_bwd", time_flash_bwd),
                        ("lru_scan_bwd", time_lru_bwd)):
        args, launches = captured[name]
        err, tol, timing = timer(torch, args)
        source, replaces = LM_KERNELS[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches,
                 "equal": err == 0.0, "max_abs_err": err,
                 "cases_max_abs_err": case_errs[name], "tolerance": tol}
        entry.update(timing)
        report.append(entry)
        if name == "flash_attention_bwd":
            entry["head_split_sweep"] = head_split_sweep(
                torch, torch.device("cuda", 0))
            print(f"[{name}_design] {entry['design']}; {entry['launch']}; "
                  f"ptxas {entry['ptxas']}; {entry['cuda_core_f32_ms']:.4f} "
                  f"ms on the CUDA-core design (float32, this run)",
                  flush=True)
        if name.endswith("_bwd"):
            print(f"[{name}_timing] at {entry['shape']}: {entry['ms']:.4f} "
                  f"ms a call, bound {entry['bound_ms']:.4f} ms "
                  f"({entry['bound_by']}), plain {entry['plain_ms']:.3f} ms"
                  f", library {entry['library_ms']}, {launches} launches a "
                  f"train step, worst error {entry['max_err_over_limit']:.3f}"
                  f" of its limit, two calls bit-equal", flush=True)
    lru = report[1]
    print(f"[lru_timing] lru_scan at {lru['shape']}: {lru['ms']:.4f} ms a "
          f"call, bound {lru['bound_ms']:.4f} ms, {lru['gb_per_s']:.1f} GB/s "
          f"({lru['peak_share']:.3f} of 3.35 TB/s); {lru['per_call_ms']:.4f} "
          f"ms a call of 20 back to back, {lru['per_call_gb_per_s']:.1f} GB/s "
          f"({lru['per_call_peak_share']:.3f}); chunk "
          f"{lru['chunk_steps']} steps ({lru['sub_steps']} a thread) x tile "
          f"{lru['tile_channels']} channels, {lru['tickets']} tickets, "
          f"scratch {lru['scratch_bytes']} B; worst error "
          f"{lru['max_err_over_limit']:.3f} of the 1e-5 limit; two calls "
          f"bit-equal; controls (a call): "
          f"B 4 {lru['b4_ms']:.4f} ms (bound {lru['b4_bound_ms']:.4f}, "
          f"{lru['b4_gb_per_s']:.1f} GB/s), long memory "
          f"{lru['long_memory_ms']:.4f} ms; the same bytes through "
          f"torch.add {lru['same_bytes_add_ms']:.4f} ms a call, "
          f"{lru['same_bytes_add_per_call_ms']:.4f} back to back", flush=True)
    return report


# --- phase 18: the dry-run and roofline layer ----------------------------------

DRYRUN_ARCHS = ("recurrentgemma-2b", "pixtral-12b", "smollm-360m", "gemma-7b",
                "granite-20b", "olmo-1b", "hubert-xlarge", "deepseek-v2-236b",
                "deepseek-moe-16b", "rwkv6-1.6b")
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# the measured cells: M1 at its full shape; M2 cut as lm_prefill is (the
# float32 logits of prefill_32k's B 32 x S 32 768 alone take 1.07 TB)
DRYRUN_MEASURED = (("M1", "decode_32k", None, None, {}),
                   ("M2", "prefill_32k", PREFILL_B, PREFILL_S,
                    {"flash_attention": 8, "lru_scan": 18}))


def run_dryrun(torch, args, dev):
    """Phase 18: the meta records of every (architecture x shape) cell,
    then M1 and M2 on the card held to their meta records, then
    ``examples/serve_lm_torch.py`` as a user runs it.  Returns (the phase's
    note, M2's launches counted from 0 around its run)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import dryrun, sweep
    out_dir = ROOT / "results" / "dryrun_torch" / sweep.device_dir_name("cuda")
    out_dir.mkdir(parents=True, exist_ok=True)
    status, slowest = {}, (0.0, "")
    t0 = time.perf_counter()
    with open(out_dir / "smoke_all.jsonl", "w") as f:
        for arch in DRYRUN_ARCHS:
            for shape in DRYRUN_SHAPES:
                rec = dryrun.run_cell(arch, shape, "meta", verbose=False)
                f.write(json.dumps(rec) + "\n")
                check(rec["status"] in ("ok", "skip"),
                      f"dryrun {arch} {shape}: {rec['status']} "
                      f"{rec.get('reason')}")
                status[rec["status"]] = status.get(rec["status"], 0) + 1
                if rec["status"] == "skip":
                    print(f"[dryrun] {arch} {shape} skip: {rec['reason']}",
                          flush=True)
                    continue
                rf = rec["roofline"]
                slowest = max(slowest, (rec["record_s"], f"{arch} {shape}"))
                print(f"[dryrun] {arch} {shape} flops {rf['flops']:.4e} "
                      f"bytes {rf['hbm_bytes']:.4e} peak "
                      f"{rec['counts']['peak_bytes']:.4e} args "
                      f"{rec['arg_bytes']:.4e} {rf['bottleneck']} frac "
                      f"{rec['roofline_fraction']:.4f} fits "
                      f"{rec['fits_one_card']} collectives "
                      f"{sum(rec['counts']['collectives'].values())} "
                      f"{rec['record_s']:.2f}s", flush=True)
                check(sum(rec["counts"]["collectives"].values()) == 0,
                      f"dryrun {arch} {shape}: collectives on one card")
    meta_s = time.perf_counter() - t0
    notes, m2_launches = [], {}
    with open(out_dir / "smoke_measured.jsonl", "w") as f:
        for label, shape, b, s, per_call in DRYRUN_MEASURED:
            torch.cuda.empty_cache()
            # the meta record first (its plain versions run on meta), then
            # the card's run alone inside counted
            rec = dryrun.run_cell(LM_ARCH, shape, "meta", batch=b, seq=s,
                                  verbose=False)
            check(rec["status"] == "ok" and rec["fits_one_card"],
                  f"dryrun {label}: {rec['status']} {rec.get('fits_reason')}")
            cut, _ = dryrun.cell_shape(shape, b, s)
            m, launches = counted(
                f"dryrun {label}",
                lambda: dryrun.measure(get_arch(LM_ARCH), cut, rec, dev,
                                       args.seed),
                kernels=tuple(per_call))
            rec["measured"] = m
            rec["device"] = m["device"]
            f.write(json.dumps(rec) + "\n")
            check(m["arg_bytes_equal"], f"dryrun {label}: argument bytes "
                                        f"{m['arg_bytes']} on the card vs "
                                        f"{rec['arg_bytes']} on meta")
            check(m["flops_equal"], f"dryrun {label}: FLOPs {m['flops']} on "
                                    f"the card vs {m['meta_flops']} on meta")
            check(m["launches"] == per_call,
                  f"dryrun {label}: launches a call {m['launches']}")
            check(launches == {k: 2 * v for k, v in per_call.items()},
                  f"dryrun {label}: launches {launches} over its two calls")
            if label == "M2":
                m2_launches = launches
            print(f"[dryrun_measured] {label} {LM_ARCH} {shape} "
                  f"{', '.join(rec['reduced']) or 'full shape'}: wall "
                  f"{m['wall_ms']:.3f} ms, max_memory_allocated "
                  f"{m['max_memory_allocated']} above "
                  f"{m['allocated_before']} held before, meta args+peak / card "
                  f"{m['meta_held_over_card']:.4f}, achieved "
                  f"{m['achieved_fraction']:.4f} vs predicted "
                  f"{m['predicted_fraction']:.4f}, arg bytes "
                  f"{m['arg_bytes']} equal, FLOPs {m['flops']:.6e} equal "
                  f"({m['flops_compared']}), launches a call "
                  f"{m['launches']}", flush=True)
            notes.append(f"{label} wall {m['wall_ms']:.3f} ms, achieved "
                         f"{m['achieved_fraction']:.4f} vs predicted "
                         f"{m['predicted_fraction']:.4f}, meta/card memory "
                         f"{m['meta_held_over_card']:.4f}")
            del rec
    torch.cuda.empty_cache()
    path = ROOT / "examples" / "serve_lm_torch.py"
    proc = subprocess.run(
        [sys.executable, str(path)], cwd=ROOT, capture_output=True,
        text=True, timeout=600, env={**os.environ, "PYTHONPATH": str(SRC)})
    check(proc.returncode == 0,
          f"serve_lm_torch exited {proc.returncode}: {proc.stderr[-2000:]}")
    last = proc.stdout.strip().splitlines()[-1]
    check(last.endswith("end to end on cuda:0"),
          f"serve_lm_torch did not serve on the card: {last}")
    return (f"{status.get('ok', 0)} ok and {status.get('skip', 0)} skip "
            f"meta records in {meta_s:.3f} s (slowest {slowest[1]} "
            f"{slowest[0]:.2f} s), no collective in any; "
            + "; ".join(notes) + f"; examples/serve_lm_torch.py: {last}",
            m2_launches)


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
    global PEAK_BYTES_PER_S, PEAK_SCALAR_OPS_PER_S
    from repro_torch.launch import roofline
    PEAK_BYTES_PER_S = roofline.HBM_BYTES_PER_S
    PEAK_SCALAR_OPS_PER_S = roofline.PEAK_F32_FLOPS
    PEAK_OPS_PER_S.update(bfloat16=roofline.PEAK_BF16_FLOPS,
                          float32=roofline.PEAK_F32_FLOPS)
    from repro_torch.kernels import _build
    from repro_torch.kernels.fct_count import kernel, ops
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.lru_scan import kernel as lru_kernel
    dev = torch.device("cuda", 0)
    # float32 comparisons on the card run in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    phase("card", t0, f"{torch.cuda.get_device_name(0)}, torch "
                      f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = [kernel.LIB, flash_kernel.LIB, lru_kernel.LIB]
    for lib in libs:    # build here, so ptxas reports every kernel
        lib.path.unlink(missing_ok=True)
    _build.build_all(libs)
    phase("build", t0, "; ".join(
        f"{lib.source.relative_to(ROOT)} -> {lib.path.name}, nvcc "
        f"{lib.build_seconds:.3f}s" for lib in libs) + " (started together)")
    t0 = time.perf_counter()
    phase("build_report", t0, build_report(libs))

    t0 = time.perf_counter()
    errs, lines = run_kernel_cases(torch, np, dev, ops, kernel)
    lm_errs, lm_lines = run_lm_kernel_cases(torch, np, dev)
    phase("kernels", t0, f"{len(lines)} fct_count cases bit-equal to the "
                         f"plain version: {'; '.join(lines)}; "
                         f"{len(lm_lines)} LM kernel cases within tolerance "
                         f"of the plain version: {'; '.join(lm_lines)}")

    t0 = time.perf_counter()
    (launches, largest, session, req, schema,
     oracles) = run_main_path(torch, np, args, dev)
    phase("main", t0, "every answer bit-equal to fct_star/topk_terms; "
                      "warm queries built 0 programs and uploaded 0 columns")

    t0 = time.perf_counter()
    phase("profile", t0, profile_device(
        torch, lambda: session.query(req), {"fct_count": "fct_count_kernel"}))

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
        entry.update(time_kernel(torch, ops, tokens, weights, vocab,
                                 args.seed))
        report.append(entry)
        print(f"[fct_timing] {name} at {entry['shape']}: zero-weight rows "
              f"{entry['zero_weight_share']:.4f} of "
              f"{entry['shape'][0] * entry['shape'][1]}; kernel "
              f"{entry['ms']:.4f} ms, uniform tokens "
              f"{entry['uniform_tokens_ms']:.4f} ms; every weight 1 "
              f"{entry['all_rows_ms']:.4f} ms, with uniform tokens "
              f"{entry['all_rows_uniform_tokens_ms']:.4f} ms; bound "
              f"{entry['bound_ms']:.4f} ms on the non-zero rows' bytes, "
              f"{entry['padded_bound_ms']:.4f} ms on every token", flush=True)
    del largest, tokens, weights
    torch.cuda.empty_cache()
    phase("fct_timing", t0, "each fct_count instantiation bit-equal to its "
                            "plain version at the main path's largest call "
                            "per dtype, then the median of 20 CUDA-event "
                            "timings after 3 warm-up calls, and the same on "
                            "uniform tokens")

    t0 = time.perf_counter()
    path_launches, serve_smoke = run_serve(torch, np, args, dev, schema,
                                           oracles, req)
    phase("serve", t0, "every gateway, patched, post-append, re-query and "
                       "device top-k answer bit-equal to fct_star/topk_terms; "
                       "burst 2 all cache hits with 0 launches; the append "
                       "uploaded only its chunk; fct_count int32 launched "
                       "and no plain-version call in each path, counted "
                       f"from 0 around it: {path_launches}; {serve_smoke}")

    t0 = time.perf_counter()
    path_launches["analysis"], note = run_analysis(dev)
    phase("analysis", t0, note)

    t0 = time.perf_counter()
    path_launches["pipeline_submit"] = run_pipeline(
        torch, np, session, req, oracles[req.keywords])
    phase("pipeline", t0, "8 submits resolved in order, every answer "
                          "bit-equal to the oracle; the burst alone launched "
                          f"{path_launches['pipeline_submit']}, 0 "
                          "plain-version calls")

    t0 = time.perf_counter()
    engine_launches = run_engine_paths(torch, np, args, dev, session, req,
                                       oracles[req.keywords])
    path_launches.update(engine_launches)
    del session, schema, oracles
    torch.cuda.empty_cache()
    phase("engine_paths", t0, "storeless run_plans and "
                              "run_plans_individual, the two-job path with "
                              "and without a checkpoint, storeless int64, "
                              "and every mode at P 8 under reduce-scatter, "
                              "psum and unbatched, every answer bit-equal to "
                              "fct_star; fct_count launched and no "
                              "plain-version call in each path, counted from "
                              f"0 around it: {engine_launches}")
    # each serving path's launches of each fct_count kernel, under its name
    for entry in report:
        entry.update({f"{path}_launches": n.get(entry["name"], 0)
                      for path, n in path_launches.items()})

    t0 = time.perf_counter()
    captured = run_lm_prefill(torch, args, dev)
    phase("lm_prefill", t0, "8 flash_attention and 18 lru_scan launches, 0 "
                            "plain-version calls, finite logits")

    t0 = time.perf_counter()
    phase("lm_decode", t0, run_lm_decode(torch, args, dev))

    t0 = time.perf_counter()
    phase("lm_serve", t0, run_lm_serve(torch, args))

    t0 = time.perf_counter()
    bwd_captured, train_stats = run_lm_train(torch, args, dev)
    captured.update(bwd_captured)
    phase("lm_train", t0, f"{TRAIN_STEPS} train steps at full width and "
                          f"depth, B {TRAIN_B} x S {TRAIN_S} bf16, remat "
                          f"full: finite losses {train_stats['losses']}, "
                          f"falling; each step the exact launches of every "
                          f"LM kernel and its backward, 0 plain-version "
                          f"calls; {train_stats['step_ms']:.3f} ms a step, "
                          f"{train_stats['tokens_per_s']:.1f} tokens/s, "
                          f"device_peak_bytes "
                          f"{train_stats['device_peak_bytes']}")

    t0 = time.perf_counter()
    phase("lm_grad", t0, run_lm_grad(torch, args, dev))

    t0 = time.perf_counter()
    phase("train_loop", t0, run_train_loop(torch, args, dev))

    t0 = time.perf_counter()
    arch_launches, arch_captured = run_lm_archs(torch, args, dev)
    phase("lm_archs", t0, f"{len(ARCHS)} architectures at full width: bf16 "
                          f"prefills of B {ARCH_PREFILL_B} x S "
                          f"{ARCH_PREFILL_S}, one flash launch per attention "
                          f"layer and 0 plain-version calls in each; float32 "
                          f"decode within {DECODE_TOL} of forward at S "
                          f"{ARCH_DECODE_S}; bf16 train steps of B "
                          f"{ARCH_TRAIN_B} x S {ARCH_TRAIN_S}, finite, with "
                          f"the exact flash launches; over all: "
                          f"{arch_launches}")

    t0 = time.perf_counter()
    report += lm_timing(torch, captured, lm_errs)
    new_dims = {"flash_attention": [], "flash_attention_bwd": []}
    for name, cap in arch_captured.items():
        fwd, bwd = time_arch_flash(torch, cap)
        for key, part in (("flash_attention", fwd),
                          ("flash_attention_bwd", bwd)):
            part["architecture"] = name
            new_dims[key].append(part)
            print(f"[{key}_new_head_dims] {name} at {part['shape']}: "
                  f"{part['ms']:.4f} ms a call, bound {part['bound_ms']:.4f} "
                  f"ms ({part['bound_by']}), plain {part['plain_ms']:.3f} ms, "
                  f"library {part['library_ms']:.4f} ms, max abs err "
                  f"{part['max_abs_err']:.4g}, worst error "
                  f"{part['max_err_over_limit']:.3f} of its limit, two calls "
                  f"bit-equal", flush=True)
            if key == "flash_attention_bwd":
                print(f"[{key}_design] {name}: {part['launch']}; ptxas "
                      f"{part['ptxas']}; {part['cuda_core_f32_ms']:.4f} ms "
                      f"on the CUDA-core design (float32, this run)",
                      flush=True)
    for entry in report:
        if entry["name"] in new_dims:
            entry["new_head_dims"] = new_dims[entry["name"]]
            entry["lm_archs_launches"] = arch_launches[entry["name"]]
    phase("lm_timing", t0, "flash_attention and lru_scan within tolerance "
                           "of their plain versions on the inputs captured "
                           "from the prefill's first local and first rglru "
                           "layer (lru_scan also bit-equal across two "
                           "calls), then timed: each kernel, its controls "
                           "and scaled_dot_product_attention median of 20 "
                           "CUDA-event timings of one call after 3 warm-up "
                           "calls, lru_scan's per_call_ms median of 10 runs "
                           "of 20 back-to-back calls, plain versions median "
                           "of 5; the backward kernels likewise on lm_train's "
                           "first backward inputs, their plain versions' and "
                           "scaled_dot_product_attention's backward as "
                           "forward + backward minus forward; flash and its "
                           "backward the same way at HuBERT's (80, 80) and "
                           "DeepSeek-V2's (192, 128) first-layer prefill "
                           "inputs")
    t0 = time.perf_counter()
    note, dryrun_launches = run_dryrun(torch, args, dev)
    for entry in report:
        if entry["name"] in dryrun_launches:
            entry["dryrun_launches"] = dryrun_launches[entry["name"]]
    phase("dryrun", t0, note)
    phase("total", t_start, "wall time of the whole smoke, build included")
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
