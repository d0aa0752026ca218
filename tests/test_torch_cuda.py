"""The port on the card: the hand-written CUDA kernels (``fct_count``,
``flash_attention``, ``lru_scan``) against their plain versions, a small FCT
session end to end against the port's numpy ``fct_star`` oracle, and a
reduced recurrentgemma-2b forward through both LM kernels against the plain
path, and reduced DeepSeek-V2 (MLA), DeepSeekMoE and HuBERT forwards through
the flash kernel at its new head dims against the same models on the CPU.
Imports neither JAX nor the JAX package, so it runs on a GPU machine
that has none; every test skips where there is no CUDA device.

Tolerances: flash 2e-5 in float32 and 4e-2 in bfloat16 (the reference's own,
``tests/test_kernels.py``), and at the prefill's statistics the smoke's
one-rounding rule; fct_count bit-equal (integer adds are exact); lru_scan
1e-5 in float32 and 4e-2 in bfloat16 (the kernel's chunked scan rounds its
per-chunk carries where the plain loop does not; the emulation of its
order, ``tests/_lru_kernel_order.py``, stays within 0.13 of the 1e-5 limit
on the CPU, and the float32 kernel equals it bit for bit), and bit-equal
from call to call; the model 1e-4 on logits of
magnitude < 1 (float32; summation order only).

The serving path on the card: the device top-k finalize over a 32 768-bin
histogram of equal counts (the lowest ids first, at P = 1 and 8, equal to
the CPU's answer: ``torch.topk`` promises no order among equal values, the
port's stable sort does), the store's on-device ``_assemble`` bit-equal to
a direct upload, ``submit`` from three threads with the launch and path
counts exact, and a gateway burst that coalesces and then hits its cache,
every answer equal to ``fct_star``.  A warm store-path query, under the
profiler, copies nothing above 4 KB to the card (its plans' send tables are
resident) and answers as a storeless call does.  The runtime
contract checker
(``repro_torch.analysis.contracts``) over every FCT program family at P = 1
and 8 under both policies, through the kernel.

The training path on the card: the backward kernels (flash_attention_bwd,
lru_scan_bwd) against their plain versions' autograd — flash within 1e-4 of
each gradient's max |g| in float32 and 4e-2 + 4e-2 |g| in bfloat16 (the
forward's rule; the plain side computes in float32 from the same bf16
inputs), lru_scan within 1e-5 of max |g| plus 1e-5 |g| in float32 — two
backward calls bit-equal; the bf16 flash backward (tensor cores) at every
head-dim pair at a ragged S, on unaligned strided views, and at MQA with
its heads split over blocks (there also within the smoke's limit (1) of
its dense float32 formula), the float32 lru backward equal to its emulated
order (``tests/_lru_kernel_order_bwd.py``) bit for bit, and a reduced
recurrentgemma-2b train step through both backward kernels against the same
step on the CPU (loss 1e-4, every gradient leaf within 1e-4 of its max
|g|).

The dry-run on the card (``launch/dryrun.py``): a reduced recurrentgemma-2b
prefill (S 1 100: one flash_attention and two lru_scan launches, no
plain-version call) and decode cell measured against their meta records —
the argument bytes of the same tensors equal, the matrix products' FLOPs
under ``FlopCounterMode`` equal with attention and the scan taken out (the
kernels launch through ctypes, which it does not see);
``examples/serve_lm_torch.py`` on the card by default, its greedy tokens
equal to the same parameters' on the CPU; and two reduced forwards on the
card bit-equal, two on the CPU bit-equal (ROADMAP F4).

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import threading

from _lru_kernel_order import kernel_order
from _lru_kernel_order_bwd import kernel_order_bwd
from repro_torch.api import FCTRequest, FCTSession, SessionConfig
from repro_torch.core.accum import INT32_CHECKED
from repro_torch.core.plan import RelationRef
from repro_torch.core.star import fct_star, topk_terms
from repro_torch.data.tpch import TpchConfig, generate, plant_keywords
from repro_torch.configs.base import get_arch
from repro_torch.kernels.fct_count import kernel, ops
from repro_torch.kernels.fct_count.ops import weighted_histogram
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.lru_scan import kernel as lru_kernel
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.models import model as M
from repro_torch.runtime import engine as fct_engine
from repro_torch.runtime.store import RelationStore
from repro_torch.serve import Gateway, GatewayConfig, SchemaRegistry

pytestmark = pytest.mark.cuda

RNG = np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc) to build and launch the "
                    "CUDA kernel")
    return torch.device("cuda")


@pytest.mark.parametrize("wdtype,hi", [(np.int32, 1 << 27), (np.int64, 1 << 62),
                                       (np.float32, 8)])
@pytest.mark.parametrize("B,R,L,V", [(1, 5000, 12, 32768), (3, 700, 5, 100),
                                     (2, 64, 3, 33)])
def test_kernel_matches_plain_on_card(cuda_device, wdtype, hi, B, R, L, V):
    toks = RNG.integers(-1, V + 2, (B, R, L)).astype(np.int32)
    w = RNG.integers(0, hi, (B, R)).astype(wdtype)
    t = torch.from_numpy(toks).to(cuda_device)
    ww = torch.from_numpy(w).to(cuda_device)
    before = dict(kernel.LAUNCHES)
    got = weighted_histogram(t, ww, V)
    want = weighted_histogram(t, ww, V, backend="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert sum(kernel.LAUNCHES.values()) == sum(before.values()) + 1


def _zipf_text(B, R, L, V, pad=0.1):
    """Token text like the generator's: Zipf(1.1) over ids 1.. with PAD."""
    ranks = np.arange(1, V, dtype=np.float64) ** -1.1
    t = RNG.choice(np.arange(1, V), size=(B, R, L), p=ranks / ranks.sum())
    t[RNG.random((B, R, L)) < pad] = 0
    return t.astype(np.int32)


def _held_to_plain(device, toks, w, V):
    t = torch.from_numpy(toks).to(device)
    ww = torch.from_numpy(w).to(device)
    before = sum(kernel.LAUNCHES.values())
    got = kernel.fct_count(t, ww, V)
    want = weighted_histogram(t, ww, V, backend="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert sum(kernel.LAUNCHES.values()) == before + 1
    return got


@pytest.mark.parametrize("L", [16, 12, 5])
@pytest.mark.parametrize("wdtype,hi", [(np.int32, 1 << 20),
                                       (np.int64, 1 << 62)])
def test_fct_count_zipf_hot_text_bit_equal(cuda_device, L, wdtype, hi):
    """Zipf-hot text (id 1 about 14% of the tokens) through the 16-byte
    loads (L 16, 12) and the 4-byte loads (L 5), one and two vocab tiles
    (int32, int64); a third of the rows weigh 0."""
    B, R, V = 2, 40000, 32768
    toks = _zipf_text(B, R, L, V)
    w = RNG.integers(1, hi, (B, R)).astype(wdtype)
    w[RNG.random((B, R)) < 0.33] = 0
    _held_to_plain(cuda_device, toks, w, V)


def test_fct_count_misaligned_tokens_bit_equal(cuda_device):
    """A token view 4 bytes past a 16-byte boundary takes the 4-byte loads,
    L % 4 == 0 notwithstanding."""
    B, R, L, V = 2, 5000, 16, 4096
    flat = torch.from_numpy(_zipf_text(1, 1, B * R * L + 1, V)).reshape(-1)
    flat = flat.to(cuda_device)
    t = flat[1:].view(B, R, L)
    assert t.is_contiguous() and t.data_ptr() % 16 == 4
    w = torch.from_numpy(RNG.integers(0, 1000, (B, R)).astype(np.int32))
    w = w.to(cuda_device)
    got = kernel.fct_count(t, w, V)
    want = weighted_histogram(t, w, V, backend="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("wdtype", [np.int32, np.int64, np.float32])
def test_fct_count_zero_weights_bit_equal(cuda_device, wdtype):
    """All rows at weight 0 give an all-zero histogram; zero rows mixed in
    runs (a padded tail, whole 32-row groups) and singly."""
    B, R, L, V = 3, 9000, 16, 1000
    toks = _zipf_text(B, R, L, V)
    zero = np.zeros((B, R), wdtype)
    got = _held_to_plain(cuda_device, toks, zero, V)
    assert not bool(got.any())
    w = RNG.integers(1, 9, (B, R)).astype(wdtype)
    w[:, 6000:] = 0                       # padded tail
    w[0, 64:1088] = 0                     # whole groups
    w[RNG.random((B, R)) < 0.5] = 0       # single rows
    _held_to_plain(cuda_device, toks, w, V)


def test_fct_count_int32_wraps_and_int64_high_bits_bit_equal(cuda_device):
    """int32 bins past 2^31 wrap modulo 2^32; int64 weights with bits 62
    and 63 set wrap modulo 2^64, through the carry from the low word of
    each bin into its high word."""
    toks = np.tile(np.array([[3, 700, 3, 0]], np.int32), (4096, 1))[None]
    w = np.full((1, 4096), (1 << 20) + 7, np.int32)     # 2^33 a bin
    got = _held_to_plain(cuda_device, toks, w, 1024)
    assert int(got[0, 3]) != 2 * 4096 * ((1 << 20) + 7)  # wrapped
    toks64 = _zipf_text(1, 30000, 8, 512)
    w64 = RNG.integers(-(1 << 63), (1 << 63) - 1, (1, 30000), dtype=np.int64)
    got64 = _held_to_plain(cuda_device, toks64, w64, 512)
    assert bool((got64 < 0).any()) and bool((got64 > 0).any())
    # 2^32 - 1: every add but the first carries out of the low word
    carry = np.full((1, 30000), (1 << 32) - 1, np.int64)
    got = _held_to_plain(cuda_device, toks64, carry, 512)
    assert int(got.max()) > (1 << 40)


@pytest.mark.parametrize("policy", ["int32", "int64"])
def test_session_on_card_equals_oracle(cuda_device, policy):
    cfg = TpchConfig(scale=1.0, fact_rows=3000, part_rows=200, supp_rows=20,
                     order_rows=600, text_len=6, vocab_size=512, seed=3)
    kws = [509, 510, 511]
    schema = plant_keywords(generate(cfg), {
        "PART": [kws[0]], "SUPPLIER": [kws[1]], "ORDERS": [kws[2]],
        "LINEITEM": [kws[0], kws[2]]}, frac=0.3)
    session = FCTSession(schema, device=cuda_device,
                         config=SessionConfig(accum_policy=policy))
    reqs = [FCTRequest(keywords=tuple(k), top_k=10, r_max=4)
            for k in (kws, kws[:2], kws[1:])]
    kernel.LIB.reset_launches()
    ops.reset_path_counts()
    answers = [session.query(reqs[0])] + session.query_batch(reqs)
    assert sum(kernel.LAUNCHES.values()) > 0
    assert ops.PATH_COUNTS["ref"] == 0
    for req, resp in zip(reqs[:1] + reqs, answers):
        oracle = fct_star(schema, list(req.keywords), 4)
        np.testing.assert_array_equal(resp.all_freqs, oracle)
        ids, f = topk_terms(oracle, list(req.keywords), 10)
        np.testing.assert_array_equal(resp.term_ids, ids)
        np.testing.assert_array_equal(resp.freqs, f)


@pytest.mark.parametrize("b,s,h,hkv,d,dv,causal,window", [
    (2, 128, 4, 2, 32, 32, True, None),     # GQA causal
    (1, 200, 6, 1, 16, 16, True, 64),       # MQA + local window, ragged S
    (2, 96, 4, 4, 32, 16, False, None),     # encoder, dv != d
    (1, 64, 2, 2, 128, 128, True, None),
    (1, 300, 2, 1, 256, 256, True, 100),    # S > window, window % 32 != 0
    (1, 1100, 3, 1, 64, 64, True, 1000),    # several q tiles, band skipping
    (1, 300, 2, 2, 80, 80, False, None),    # HuBERT's head dim, encoder
    (1, 300, 2, 2, 192, 128, True, None),   # MLA's D 192, Dv 128
    (1, 1100, 15, 5, 64, 64, True, None),   # SmolLM's GQA 15/5, no window
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_card(cuda_device, b, s, h, hkv, d, dv,
                                            causal, window, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    q = torch.from_numpy(RNG.normal(size=(b, s, h, d))).to(cuda_device, dtype)
    k = torch.from_numpy(RNG.normal(size=(b, s, hkv, d))).to(cuda_device,
                                                             dtype)
    v = torch.from_numpy(RNG.normal(size=(b, s, hkv, dv))).to(cuda_device,
                                                              dtype)
    before = flash_kernel.LAUNCHES["flash_attention"]
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     block_q=64, block_k=32, backend="ref")
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 4e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert flash_kernel.LAUNCHES["flash_attention"] == before + 1


@pytest.mark.parametrize("d,dv", sorted(flash_kernel.HEAD_DIMS))
def test_flash_bf16_every_head_dims_ragged(cuda_device, d, dv):
    """The tensor-core kernel at every (D, Dv) it is built for, ragged S
    (no multiple of its 64-key tile or its q tile), GQA, causal with a
    window and without, within the reference's bf16 tolerance."""
    q = torch.from_numpy(RNG.normal(size=(2, 333, 4, d))).to(cuda_device,
                                                            torch.bfloat16)
    k = torch.from_numpy(RNG.normal(size=(2, 333, 2, d))).to(cuda_device,
                                                            torch.bfloat16)
    v = torch.from_numpy(RNG.normal(size=(2, 333, 2, dv))).to(cuda_device,
                                                             torch.bfloat16)
    for causal, window in ((True, None), (True, 100), (False, None)):
        got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
        want = flash_ops.flash_attention(q, k, v, causal=causal,
                                         window=window, backend="ref")
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=4e-2,
                                   rtol=4e-2)


def test_flash_bf16_within_one_rounding_at_prefill_statistics(cuda_device):
    """S 2 304, MQA, D 256, window 2 048, q/k/v ~ N(0, 1) in bf16: the
    kernel within ``chip_smoke.py``'s rule for the prefill's own inputs,
    |kernel - plain| <= 2^-7 |plain| + 2^-8 mean|plain|."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(cuda_device, torch.bfloat16)
               for shape in ((1, 2304, 2, 256), (1, 2304, 1, 256),
                             (1, 2304, 1, 256)))
    got = flash_ops.flash_attention(q, k, v, causal=True, window=2048).float()
    want = flash_ops.flash_attention(q, k, v, causal=True, window=2048,
                                     block_q=64, block_k=64,
                                     backend="ref").float()
    limit = (smoke.CAPTURED_BF16_ABS_OF_MEAN * float(want.abs().mean())
             + smoke.CAPTURED_BF16_REL * want.abs())
    assert bool(((got - want).abs() <= limit).all())


def test_flash_bf16_reads_unaligned_strided_inputs(cuda_device):
    """bf16 views whose rows are not 16-byte aligned take the plain loads
    of the same kernel."""
    qkv = torch.from_numpy(RNG.normal(size=(1, 150, 3, 2, 72))).to(
        cuda_device, torch.bfloat16)
    q, k, v = (t[..., 1:65] for t in qkv.unbind(2))
    assert q.data_ptr() % 16 != 0 and q.stride(-1) == 1
    got = flash_ops.flash_attention(q, k, v, causal=True)
    want = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=True,
                                     backend="ref")
    torch.testing.assert_close(got.float(), want.float(), atol=4e-2,
                               rtol=4e-2)


def test_flash_kernel_reads_strided_inputs(cuda_device):
    qkv = torch.from_numpy(RNG.normal(size=(2, 70, 3, 4, 32))).float().to(
        cuda_device)
    q, k, v = qkv.unbind(2)          # strided views, last dim contiguous
    got = flash_ops.flash_attention(q, k, v, causal=True)
    want = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=True,
                                     backend="ref")
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# around the kernel's chunk of 128 timesteps and its tiles of 64 float32 /
# 128 bf16 channels (test_lru_scan_follows_its_emulated_order checks them
# against the built library)
LRU_S_EDGES = (1, 127, 128, 129, 8192 + 37)
LRU_W_EDGES = (5, 127, 129, 2560)
LRU_EDGES = [(b, s, w) for b in (1, 3) for s in LRU_S_EDGES
             for w in LRU_W_EDGES]


@pytest.mark.parametrize("b,s,w", [(2, 64, 32), (1, 300, 700), (3, 17, 5),
                                   (1, 8192, 2560)] + LRU_EDGES)
def test_lru_scan_kernel_matches_plain_on_card(cuda_device, b, s, w):
    a = torch.from_numpy(RNG.uniform(0.8, 1.0, (b, s, w))).float().to(
        cuda_device)
    x = torch.from_numpy(RNG.normal(size=(b, s, w))).float().to(cuda_device)
    before = lru_kernel.LAUNCHES["lru_scan"]
    got = lru_ops.lru_scan(a, x)
    want = lru_ops.lru_scan(a, x, backend="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert lru_kernel.LAUNCHES["lru_scan"] == before + 1
    got16 = lru_ops.lru_scan(a.bfloat16(), x.bfloat16())
    want16 = lru_ops.lru_scan(a.bfloat16(), x.bfloat16(), backend="ref")
    torch.testing.assert_close(got16.float(), want16.float(), atol=4e-2,
                               rtol=4e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-2)])
@pytest.mark.parametrize("w", [2560, 129])
def test_lru_scan_unaligned_views(cuda_device, dtype, tol, w):
    """a and b one element off a 16-byte boundary take the kernel's plain
    loads and stores."""
    n = 3 * 200 * w
    raw = [torch.from_numpy(x).to(cuda_device, dtype) for x in (
        RNG.uniform(0.8, 1.0, n + 1), RNG.normal(size=n + 1))]
    a, x = (t[1:].view(3, 200, w) for t in raw)
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    got = lru_ops.lru_scan(a, x)
    want = lru_ops.lru_scan(a, x, backend="ref")
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,w", [(3, 8192 + 37, 129), (1, 1000, 2560)])
def test_lru_scan_follows_its_emulated_order(cuda_device, b, s, w):
    """The float32 kernel equals ``kernel_order`` (its order of arithmetic
    in numpy, with correctly rounded fmaf) bit for bit, at the geometry the
    built library reports; and the edge shapes above straddle that
    geometry."""
    g = lru_kernel.geometry(torch.float32, b, s, w)
    chunk = g["chunk_steps"]
    assert {chunk - 1, chunk, chunk + 1} <= set(LRU_S_EDGES)
    for dtype in lru_kernel.INSTANTIATIONS:
        tile = lru_kernel.geometry(dtype, 1, 1, 1)["tile_channels"]
        assert any(0 < w_ % tile < tile - 1 for w_ in LRU_W_EDGES)
        assert any(w_ % tile == 1 for w_ in LRU_W_EDGES)
    a = RNG.uniform(0.8, 1.0, (b, s, w)).astype(np.float32)
    x = RNG.normal(size=(b, s, w)).astype(np.float32)
    got = lru_ops.lru_scan(torch.from_numpy(a).to(cuda_device),
                           torch.from_numpy(x).to(cuda_device)).cpu().numpy()
    want = kernel_order(a, x, g["sub_steps"], chunk)
    diff = got.view(np.uint32) != want.view(np.uint32)
    assert not diff.any(), (f"{int(diff.sum())} of {diff.size} differ, max "
                            f"abs {np.max(np.abs(got - want))}")


def _loop64(a, x):
    out = torch.empty(a.shape, dtype=torch.float64, device=a.device)
    h = torch.zeros_like(out[:, 0])
    for t in range(a.shape[1]):
        h = a[:, t].double() * h + x[:, t].double()
        out[:, t] = h
    return out


def test_lru_scan_long_memory(cuda_device):
    """a in [0.999, 1): carries live across the whole 8 192 steps, through
    64 chunks.  With x scaled by sqrt(1 - a²), as the gates scale it, within
    1e-5 of the plain loop.  Unscaled, |h| reaches about 100 and float32
    rounding alone passes the 1e-5 rule (the CPU emulation shows the same),
    so there the kernel is held to a float64 loop: no farther from it than
    the plain loop, up to one float32 rounding of |h|."""
    a = torch.from_numpy(RNG.uniform(0.999, 1.0, (1, 8192, 2560))).float()
    x = torch.from_numpy(RNG.normal(size=(1, 8192, 2560))).float()
    a, x = a.to(cuda_device), x.to(cuda_device)
    gated = x * torch.sqrt(1.0 - a * a)
    got = lru_ops.lru_scan(a, gated)
    want = lru_ops.lru_scan(a, gated, backend="ref")
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    got = lru_ops.lru_scan(a, x)
    want = lru_ops.lru_scan(a, x, backend="ref")
    exact = _loop64(a, x)
    ulp = torch.finfo(torch.float32).eps * float(exact.abs().max())
    assert (float((got.double() - exact).abs().max())
            <= float((want.double() - exact).abs().max()) + ulp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lru_scan_is_deterministic(cuda_device, dtype):
    """20 calls on the same inputs give the same bits, also while another
    stream keeps the card busy (so blocks interleave differently)."""
    a = torch.from_numpy(RNG.uniform(0.9, 1.0, (2, 4096 + 17, 2560))).to(
        cuda_device, dtype)
    x = torch.from_numpy(RNG.normal(size=(2, 4096 + 17, 2560))).to(
        cuda_device, dtype)
    first = lru_ops.lru_scan(a, x)
    m = torch.randn(4096, 4096, device=cuda_device)
    other = torch.cuda.Stream()
    other.wait_stream(torch.cuda.current_stream())
    outs = []
    for i in range(20):
        if i >= 10:
            with torch.cuda.stream(other):
                for _ in range(4):
                    m @ m
        outs.append(lru_ops.lru_scan(a, x))
    torch.cuda.synchronize()
    assert all(torch.equal(first, o) for o in outs)


def test_reduced_model_forward_through_kernels(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("recurrentgemma-2b").reduced()
    params = M.init_params(cfg, cuda_device, seed=3)
    tok = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 1100)))
    flash_kernel.LIB.reset_launches()
    lru_kernel.LIB.reset_launches()
    flash_ops.reset_path_counts()
    lru_ops.reset_path_counts()
    got, _ = M.forward(params, {"tokens": tok.to(cuda_device)}, cfg)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES["flash_attention"] == 1
    assert lru_kernel.LAUNCHES["lru_scan"] == 2
    assert flash_ops.PATH_COUNTS["ref"] == lru_ops.PATH_COUNTS["ref"] == 0
    want, _ = M.forward(params.to("cpu"), {"tokens": tok}, cfg)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["deepseek_v2_236b", "deepseek_moe_16b",
                                  "hubert_xlarge"])
def test_reduced_arch_forward_through_kernels(cuda_device, arch):
    """MLA (D 16, Dv 8) with MoE, attention with MoE, and the encoder with
    the frame frontend at S 1 100: every attention layer through the
    kernel, against the same model on the CPU (logits 1e-4, aux 1e-5
    relative)."""
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    # HuBERT's learned positions must cover S 1 100
    cfg = dataclasses.replace(get_arch(arch).reduced(), max_position=2048)
    params = M.init_params(cfg, cuda_device, seed=3)
    gen = torch.Generator().manual_seed(4)
    batch = M.make_dummy_batch(cfg, 2, 1100, gen, "cpu")
    flash_kernel.LIB.reset_launches()
    flash_ops.reset_path_counts()
    with torch.no_grad():
        got, aux = M.forward(params, {k: v.to(cuda_device)
                                      for k, v in batch.items()}, cfg)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES["flash_attention"] == cfg.n_layers
    assert flash_ops.PATH_COUNTS["ref"] == 0
    with torch.no_grad():
        want, want_aux = M.forward(params.to("cpu"), batch, cfg)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=0, rtol=1e-5)
    assert (float(want_aux) > 0) == bool(cfg.n_experts)


# -- the FCT serving path on the card ------------------------------------------

def _serving_schema():
    cfg = TpchConfig(scale=1.0, fact_rows=3000, part_rows=200, supp_rows=20,
                     order_rows=600, text_len=6, vocab_size=512, seed=3)
    kws = [509, 510, 511]
    return plant_keywords(generate(cfg), {
        "PART": [kws[0]], "SUPPLIER": [kws[1]], "ORDERS": [kws[2]],
        "LINEITEM": [kws[0], kws[2]]}, frac=0.3), kws


@pytest.mark.parametrize("P", [1, 8])
def test_device_topk_equal_counts_lowest_ids_first(cuda_device, P):
    vocab, k = 32768, 10
    tsig = fct_engine.topk_signature(vocab, P, INT32_CHECKED, k)
    eng = fct_engine.FCTEngine()
    excl = np.zeros(vocab, np.int8)
    excl[[0, 5]] = 1
    kw = fct_engine.keyword_ids_array([2, 7])
    hist = np.full(vocab, 3, np.int32)
    hist[[100, 20000, 30000]] = 4
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        mesh = make_worker_mesh(P, dev)
        fn = fct_engine._build_topk_fn(tsig, mesh, True)
        counts, ids, wrapped = fn(eng.vocab_device_vector(hist, mesh,
                                                          np.int32), kw,
                                  eng.vocab_device_vector(excl, mesh,
                                                          np.int8))
        out[dev.type] = (counts.cpu().numpy(), ids.cpu().numpy(),
                         int(wrapped))
    counts, ids, wrapped = out["cuda"]
    k_eff = fct_engine.k_effective(tsig)
    want = [100, 20000, 30000] + [i for i in range(1, vocab)
                                  if i not in (5, 2, 7)][:k_eff - 3]
    assert ids.tolist() == want and wrapped == 0
    assert counts.tolist() == [4, 4, 4] + [3] * (k_eff - 3)
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("P", [1, 8])
def test_assemble_on_card_equals_a_direct_upload(cuda_device, P):
    rng = np.random.default_rng(P)
    chunks = (4000, 60, 700)
    n = sum(chunks)
    text = rng.integers(0, 500, (n, 12)).astype(np.int32)
    keys = tuple(rng.integers(0, 99, n).astype(np.int32) for _ in range(3))
    rows = np.sort(rng.choice(n, 3000, replace=False))
    rows[-1] = n - 1
    ref = RelationRef(role="fact", name="F", rows=rows, base_text=text,
                      base_keys=keys, n_devices=P, base_chunks=chunks)
    store = RelationStore(make_worker_mesh(P, cuda_device))
    rows_pad = 1 << (ref.shard_rows - 1).bit_length()
    got = store.columns(ref, rows_pad, 16)
    want_text, want_keys = ref.store_columns(rows_pad, 16)
    assert got.text.is_cuda and store.chunk_assembles == 1
    np.testing.assert_array_equal(got.text.cpu().numpy(), want_text)
    np.testing.assert_array_equal(got.keys.cpu().numpy(), want_keys)


def test_submit_from_threads_counts_exactly(cuda_device):
    schema, kws = _serving_schema()
    session = FCTSession(schema, device=cuda_device)
    req = FCTRequest(keywords=tuple(kws), top_k=10, r_max=4)
    oracle = fct_star(schema, kws, 4)
    kernel.LIB.reset_launches()
    ops.reset_path_counts()
    session.query(req)
    per_query = ops.PATH_COUNTS["cuda_exact"]
    assert per_query > 0
    assert kernel.LAUNCHES["fct_count_exact_int32"] == per_query
    kernel.LIB.reset_launches()
    ops.reset_path_counts()
    results, errors = [], []

    def worker():
        try:
            futs = [session.submit(req) for _ in range(4)]
            results.extend(f.result(timeout=300) for f in futs)
        except BaseException as exc:          # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    session.close()
    assert not errors and len(results) == 12
    for r in results:
        np.testing.assert_array_equal(r.all_freqs, oracle)
    assert ops.PATH_COUNTS["ref"] == 0
    assert ops.PATH_COUNTS["cuda_exact"] == 12 * per_query
    assert kernel.LAUNCHES["fct_count_exact_int32"] == 12 * per_query


def test_gateway_burst_coalesces_on_card(cuda_device):
    schema, kws = _serving_schema()
    reg = SchemaRegistry(device=cuda_device, n_workers=2)
    reg.register("t", schema)
    reqs = [FCTRequest(keywords=tuple(k), top_k=10, r_max=4)
            for k in (kws, kws, kws[:2], kws[:2], list(reversed(kws)))]
    with Gateway(reg, GatewayConfig(batch_window_ms=20.0,
                                    result_cache_ttl_s=3600.0)) as gw:
        ops.reset_path_counts()
        first = [f.result(timeout=300) for f in [gw.submit("t", r)
                                                 for r in reqs]]
        assert sum(r.coalesced for r in first) >= 2
        assert ops.PATH_COUNTS["cuda_exact"] > 0 and \
            ops.PATH_COUNTS["ref"] == 0
        batches = reg.session("t").engine.batches_run
        second = [gw.query("t", r) for r in reqs]
        assert all(r.cache_hit for r in second)
        assert reg.session("t").engine.batches_run == batches
    for req, a, b in zip(reqs, first, second):
        oracle = fct_star(schema, list(req.keywords), 4)
        ids, f = topk_terms(oracle, list(req.keywords), 10)
        for r in (a, b):
            np.testing.assert_array_equal(r.all_freqs, oracle)
            np.testing.assert_array_equal(r.term_ids, ids)
            np.testing.assert_array_equal(r.freqs, f)


def _joined_plans(schema, kws, P, r_max=4):
    from repro_torch.core.candidate_network import (TupleSets,
                                                    enumerate_star_cns,
                                                    prune_empty_cns)
    from repro_torch.core.plan import build_cn_plan
    ts = TupleSets.build(schema, kws)
    cns = prune_empty_cns(enumerate_star_cns(len(kws), schema.m, r_max), ts)
    return [p for p in (build_cn_plan(schema, ts, cn, P) for cn in cns)
            if p is not None]


@pytest.mark.parametrize("rs", [True, False])
@pytest.mark.parametrize("P", [1, 8])
def test_storeless_calls_on_card(cuda_device, P, rs):
    """Without a store the engine uploads the columns to a store of the
    call's own: both families launch the kernel, never the plain version,
    and equal the per-CN path on the CPU, under both policies."""
    from repro_torch.obs import MetricsRegistry
    from repro_torch.core.accum import INT64_EXACT
    from repro_torch.core.fct import run_cn_plan
    schema, kws = _serving_schema()
    plans = _joined_plans(schema, kws, P)
    cpu = make_worker_mesh(P, "cpu")
    mesh = make_worker_mesh(P, cuda_device)
    for accum, name in ((INT32_CHECKED, "fct_count_exact_int32"),
                        (INT64_EXACT, "fct_count_exact_int64")):
        want = sum(run_cn_plan(p, cpu, accum=accum) for p in plans)
        eng = fct_engine.FCTEngine(reduce_scatter=rs,
                                   metrics=MetricsRegistry())
        kernel.LIB.reset_launches()
        ops.reset_path_counts()
        total = eng.run_plans(plans, mesh, accum=accum)
        indiv = eng.run_plans_individual(plans, mesh, accum=accum)
        assert kernel.LAUNCHES[name] > 0 and ops.PATH_COUNTS["ref"] == 0
        np.testing.assert_array_equal(total, want)
        np.testing.assert_array_equal(indiv.sum(axis=0), want)
        snap = eng.metrics.snapshot()
        assert snap["counters"]["store.upload_bytes"] > 0
        assert snap["gauges"]["store.resident_bytes"] == 0


def test_two_jobs_on_card(cuda_device, tmp_path):
    """MR¹, a checkpoint restored onto the card, then MR²: equal to the
    fused path, with the kernel and no plain-version call."""
    from repro_torch.core.fct import run_cn_plan, run_cn_plan_two_jobs
    from repro_torch.distributed.checkpoint import restore_checkpoint
    schema, kws = _serving_schema()
    plan = max((p for p in _joined_plans(schema, kws, 1)
                if len(p.included) == 2), key=lambda p: p.fact.ref.n_rows)
    mesh = make_worker_mesh(1, cuda_device)
    want = run_cn_plan(plan, make_worker_mesh(1, "cpu"))
    kernel.LIB.reset_launches()
    ops.reset_path_counts()
    np.testing.assert_array_equal(run_cn_plan_two_jobs(plan, mesh), want)
    np.testing.assert_array_equal(
        run_cn_plan_two_jobs(plan, mesh, checkpoint_dir=str(tmp_path)), want)
    assert kernel.LAUNCHES["fct_count_exact_int32"] >= 2 * (1 + 2)
    assert ops.PATH_COUNTS["ref"] == 0
    template = {"fact": {"text": torch.zeros(1, device=cuda_device,
                                             dtype=torch.int32)}}
    _, back = restore_checkpoint(str(tmp_path), template)
    assert back["fact"]["text"].is_cuda


# -- the training path on the card ---------------------------------------------

FLASH_GRAD_CASES = [
    (2, 128, 4, 2, 32, 32, True, None),     # GQA causal
    (1, 200, 6, 1, 16, 16, True, 64),       # MQA + local window, ragged S
    (2, 96, 4, 4, 32, 16, False, None),     # encoder, dv != d
    (1, 64, 2, 2, 128, 128, True, None),
    (1, 300, 2, 1, 256, 256, True, 100),    # S > window, window % 32 != 0
    (1, 1100, 3, 1, 64, 64, True, 1000),    # several q tiles, band skipping
    (1, 333, 2, 1, 256, 128, False, None),  # encoder D 256, Dv 128, ragged
    (1, 300, 2, 2, 80, 80, False, None),    # HuBERT's head dim, encoder
    (1, 300, 2, 2, 192, 128, True, None),   # MLA's D 192, Dv 128
    (1, 300, 4, 4, 16, 8, True, None),      # the reduced MLA's D 16, Dv 8
    (1, 1100, 15, 5, 64, 64, True, None),   # SmolLM's GQA 15/5, no window
]


def _grads_of(fn, tensors, g):
    ins = [t.detach().clone().requires_grad_(True) for t in tensors]
    out = fn(*ins)
    out.backward(g)
    return out.detach(), [t.grad for t in ins]


@pytest.mark.parametrize("b,s,h,hkv,d,dv,causal,window", FLASH_GRAD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_matches_plain_autograd(cuda_device, b, s, h, hkv, d,
                                                 dv, causal, window, dtype):
    q, k, v, g = (torch.from_numpy(RNG.normal(size=shape)).to(cuda_device,
                                                              dtype)
                  for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, dv),
                                (b, s, h, dv)))
    kw = dict(causal=causal, window=window)
    before = dict(flash_kernel.LAUNCHES)
    _, got = _grads_of(lambda *t: flash_ops.flash_attention(*t, **kw),
                       (q, k, v), g)
    assert (flash_kernel.LAUNCHES["flash_attention_bwd"]
            == before["flash_attention_bwd"] + 1)
    _, again = _grads_of(lambda *t: flash_ops.flash_attention(*t, **kw),
                         (q, k, v), g)
    _, want = _grads_of(lambda *t: flash_ops.flash_attention(
        *t, backend="ref", block_q=64, block_k=64, **kw), (q, k, v), g)
    torch.cuda.synchronize()
    for a, a2, w in zip(got, again, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert torch.equal(a, a2)
        a, w = a.float(), w.float()
        if dtype == torch.float32:
            assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())
        else:
            assert bool(((a - w).abs() <= 4e-2 + 4e-2 * w.abs()).all())


def _bf16_bwd_against_plain(q, k, v, g, **kw):
    """The bf16 backward kernel through autograd against the plain version's
    autograd by the forward's rule, 4e-2 + 4e-2 |g|, two calls bit-equal."""
    before = flash_kernel.LAUNCHES["flash_attention_bwd"]
    got, again = (_grads_of(lambda *t: flash_ops.flash_attention(*t, **kw),
                            (q, k, v), g)[1] for _ in range(2))
    assert flash_kernel.LAUNCHES["flash_attention_bwd"] == before + 2
    _, want = _grads_of(lambda *t: flash_ops.flash_attention(
        *t, backend="ref", block_q=64, block_k=64, **kw),
        [t.contiguous() for t in (q, k, v)], g)
    torch.cuda.synchronize()
    for a, a2, w in zip(got, again, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        assert torch.equal(a, a2)
        a, w = a.float(), w.float()
        assert bool(((a - w).abs() <= 4e-2 + 4e-2 * w.abs()).all())


@pytest.mark.parametrize("d,dv", sorted(flash_kernel.HEAD_DIMS))
def test_flash_bwd_bf16_every_head_dims_ragged(cuda_device, d, dv):
    """The tensor-core backward at every (D, Dv) it is built for, S 333 (no
    multiple of its 64-row blocks or 32-row tiles), GQA 4/2, causal with a
    window and without, and the encoder mask."""
    q, k, v, g = (torch.from_numpy(RNG.normal(size=shape)).to(
        cuda_device, torch.bfloat16) for shape in (
            (2, 333, 4, d), (2, 333, 2, d), (2, 333, 2, dv), (2, 333, 4, dv)))
    for causal, window in ((True, None), (True, 100), (False, None)):
        _bf16_bwd_against_plain(q, k, v, g, causal=causal, window=window)


def test_flash_bwd_bf16_reads_unaligned_strided_inputs(cuda_device):
    """bf16 views whose rows are not 16-byte aligned take the plain loads
    of the same backward kernels."""
    qkv = torch.from_numpy(RNG.normal(size=(1, 150, 3, 2, 72))).to(
        cuda_device, torch.bfloat16)
    q, k, v = (t[..., 1:65] for t in qkv.unbind(2))
    assert q.data_ptr() % 16 != 0 and q.stride(-1) == 1
    g = torch.from_numpy(RNG.normal(size=(1, 150, 2, 64))).to(
        cuda_device, torch.bfloat16)
    _bf16_bwd_against_plain(q, k, v, g, causal=True)


def test_flash_bwd_bf16_unit_batch_stride(cuda_device):
    """A batch-1 dO whose batch stride is 1 (as autograd hands the model's
    gradient on) gives the same bits as a fresh contiguous copy: the wrapper
    passes 0 for a size-1 dimension's stride."""
    q, k, v = (torch.from_numpy(RNG.normal(size=shape)).to(
        cuda_device, torch.bfloat16) for shape in (
            (1, 300, 4, 64), (1, 300, 1, 64), (1, 300, 1, 64)))
    o, lse = flash_kernel.flash_attention(q, k, v, causal=True, lse=True)
    g = torch.from_numpy(RNG.normal(size=(1, 300, 4, 64))).to(
        cuda_device, torch.bfloat16)
    odd = torch.empty(g.numel(), dtype=g.dtype, device=cuda_device)
    odd = odd.as_strided(g.shape, (1, 256, 64, 1)).copy_(g)
    assert odd.is_contiguous() and odd.stride(0) == 1
    got = flash_kernel.flash_attention_bwd(q, k, v, o, lse, odd)
    want = flash_kernel.flash_attention_bwd(q, k, v, o, lse, g.clone())
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flash_bwd_bf16_mqa_head_splits(cuda_device):
    """MQA 10/1 at S 2 304 (36 key blocks of one kv head): the group's heads
    split over several dK/dV blocks whose float32 partials one more pass
    sums in order; against the plain autograd, two calls bit-equal, and
    against the backward's dense float32 formula within ``chip_smoke.py``'s
    limit (1), dO at a unit max."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    q, k, v, g = (torch.from_numpy(RNG.normal(size=shape)).to(
        cuda_device, torch.bfloat16) for shape in (
            (1, 2304, 10, 64), (1, 2304, 1, 64), (1, 2304, 1, 64),
            (1, 2304, 10, 64)))
    plan = flash_kernel.bwd_plan(q, v, causal=True, window=2048)
    assert plan["head_splits"] > 1 and plan["dkdv_grid"][2] > 1
    _bf16_bwd_against_plain(q, k, v, g, causal=True, window=2048)
    o, lse = flash_kernel.flash_attention(q, k, v, causal=True, window=2048,
                                          lse=True)
    g, _ = smoke.unit_scaled(g)
    got = flash_kernel.flash_attention_bwd(q, k, v, o, lse, g, causal=True,
                                           window=2048)
    dense = smoke.dense_flash_bwd(torch, q, k, v, o, lse, g, True, 2048)
    readings = smoke.shares(torch, got, dense, smoke.FORMULA_BWD_REL,
                            smoke.FLASH_GRAD_TOL)
    assert all(r["share"] <= 1.0 for r in readings.values()), readings


def test_flash_forward_writes_lse_only_when_asked(cuda_device):
    q = torch.randn(1, 300, 2, 64, device=cuda_device)
    k = torch.randn(1, 300, 1, 64, device=cuda_device)
    v = torch.randn(1, 300, 1, 64, device=cuda_device)
    o, lse = flash_kernel.flash_attention(q, k, v, causal=True, window=50,
                                          lse=True)
    assert torch.equal(o, flash_kernel.flash_attention(q, k, v, causal=True,
                                                       window=50))
    scores = torch.einsum("bqhd,bkd->bhqk", q, k[:, :, 0]) / 8.0
    i = torch.arange(300, device=cuda_device)
    ok = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < 50)
    want = torch.logsumexp(scores.masked_fill(~ok, float("-inf")), -1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-6)
    # no gradient asked: the forward alone, no backward Function
    with torch.inference_mode():
        out = flash_ops.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None


LRU_GRAD_SHAPES = [(1, 1, 5), (3, 127, 127), (1, 128, 129), (3, 129, 2560),
                   (1, 8192 + 37, 129), (2, 1000, 2560)]


@pytest.mark.parametrize("b,s,w", LRU_GRAD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lru_scan_bwd_matches_plain_autograd(cuda_device, b, s, w, dtype):
    a = torch.from_numpy(RNG.uniform(0.8, 1.0, (b, s, w))).to(cuda_device,
                                                              dtype)
    x, g = (torch.from_numpy(RNG.normal(size=(b, s, w))).to(cuda_device,
                                                            dtype)
            for _ in range(2))
    before = lru_kernel.LAUNCHES["lru_scan_bwd"]
    _, got = _grads_of(lru_ops.lru_scan, (a, x), g)
    assert lru_kernel.LAUNCHES["lru_scan_bwd"] == before + 1
    _, again = _grads_of(lru_ops.lru_scan, (a, x), g)
    _, want = _grads_of(lambda *t: lru_ops.lru_scan(*t, backend="ref"),
                        (a, x), g)
    torch.cuda.synchronize()
    for got_, again_, want_ in zip(got, again, want):
        assert torch.equal(got_, again_)
        d, wf = (got_.float() - want_.float()).abs(), want_.float().abs()
        if dtype == torch.float32:
            assert bool((d <= 1e-5 * float(wf.max()) + 1e-5 * wf).all())
        else:
            assert bool((d <= 4e-2 + 4e-2 * wf).all())


@pytest.mark.parametrize("b,s,w", [(3, 8192 + 37, 129), (1, 1000, 2560)])
def test_lru_scan_bwd_follows_its_emulated_order(cuda_device, b, s, w):
    geom = lru_kernel.geometry(torch.float32, b, s, w)
    a = RNG.uniform(0.8, 1.0, (b, s, w)).astype(np.float32)
    h = RNG.normal(size=(b, s, w)).astype(np.float32)
    dh = RNG.normal(size=(b, s, w)).astype(np.float32)
    da, db = lru_kernel.lru_scan_bwd(*(torch.from_numpy(t).to(cuda_device)
                                       for t in (a, h, dh)))
    want_da, want_db = kernel_order_bwd(a, h, dh, geom["sub_steps"],
                                        geom["chunk_steps"])
    for got, want in ((db, want_db), (da, want_da)):
        got = got.cpu().numpy()
        diff = got.view(np.uint32) != want.view(np.uint32)
        assert not diff.any(), (f"{int(diff.sum())} of {diff.size} differ, "
                                f"max abs {np.max(np.abs(got - want))}")


def test_reduced_model_train_step_through_kernels(cuda_device):
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.step import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("recurrentgemma-2b").reduced()
    tok = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 1100)))
    batch = {"tokens": tok, "labels": tok}
    on_card = M.init_params(cfg, cuda_device, seed=3).requires_grad_(True)
    on_cpu = M.init_params(cfg, "cpu", seed=3).requires_grad_(True)
    with torch.no_grad():
        for p, q in zip(on_card.parameters(), on_cpu.parameters()):
            q.copy_(p)
    flash_kernel.LIB.reset_launches()
    lru_kernel.LIB.reset_launches()
    flash_ops.reset_path_counts()
    lru_ops.reset_path_counts()
    total, _ = M.loss_fn(on_card, {k: t.to(cuda_device) for k, t in
                                   batch.items()}, cfg)
    total.backward()
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES["flash_attention_bwd"] == 1
    assert lru_kernel.LAUNCHES["lru_scan_bwd"] == 2
    assert flash_ops.PATH_COUNTS["ref"] == lru_ops.PATH_COUNTS["ref"] == 0
    want, _ = M.loss_fn(on_cpu, batch, cfg)
    want.backward()
    assert abs(float(total.detach()) - float(want.detach())) < 1e-4
    for (name, p), q in zip(on_card.named_parameters(), on_cpu.parameters()):
        scale = float(q.grad.abs().max())
        assert float((p.grad.cpu() - q.grad).abs().max()) <= 1e-4 * scale, \
            name
    step = make_train_step(cfg)
    state = init_opt_state(dict(on_card.named_parameters()))
    _, state, metrics = step(on_card, state, {k: t.to(cuda_device) for k, t
                                              in batch.items()})
    assert int(state["count"]) == 1
    assert bool(torch.isfinite(metrics["grad_norm"]))


def test_contracts_on_card(cuda_device):
    """The runtime contract checker on the card: every family at P 1 and
    8 under both policies, its histograms through the fct_count kernel and
    never the plain version."""
    from repro_torch.analysis.contracts import check_all_contracts
    kernel.LIB.reset_launches()
    ops.reset_path_counts()
    failures, checked = check_all_contracts(device=cuda_device)
    assert failures == [] and checked == 24
    assert kernel.LAUNCHES["fct_count_exact_int32"] > 0
    assert kernel.LAUNCHES["fct_count_exact_int64"] > 0
    assert ops.PATH_COUNTS["ref"] == 0


def test_dryrun_measured_cells_on_card(cuda_device):
    import dataclasses
    from repro_torch.configs.base import SHAPES
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("recurrentgemma-2b").reduced()
    for kind, s, launches in (("prefill_32k", 1100,
                               {"flash_attention": 1, "lru_scan": 2}),
                              ("decode_32k", 40, {})):
        shape = dataclasses.replace(SHAPES[kind], global_batch=2, seq_len=s)
        rec = dryrun.meta_record(cfg, shape)
        flash_ops.reset_path_counts()
        lru_ops.reset_path_counts()
        got = dryrun.measure(cfg, shape, rec, cuda_device)
        assert got["arg_bytes"] == rec["arg_bytes"]
        assert got["flops"] == got["meta_flops"] > 0
        assert got["launches"] == launches
        assert flash_ops.PATH_COUNTS["ref"] == lru_ops.PATH_COUNTS["ref"] == 0
        assert got["max_memory_allocated"] >= got["arg_bytes"]


def test_serve_lm_example_on_card(cuda_device):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "examples" / \
        "serve_lm_torch.py"
    spec = importlib.util.spec_from_file_location("_serve_lm_torch", path)
    port = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(port)
    torch.backends.cuda.matmul.allow_tf32 = False
    prompts, gen = port.main([])
    assert prompts.is_cuda and gen.is_cuda and gen.shape == (4, 20)
    cfg = get_arch("smollm-360m").reduced()
    params = M.init_params(cfg, cuda_device, seed=5)
    want = port.serve(params.to("cpu"), cfg, prompts.cpu(), 20)
    got = port.serve(params.to(cuda_device), cfg, prompts, 20)
    assert torch.equal(got.cpu(), want)


def test_reduced_model_forward_repeatable(cuda_device):
    """ROADMAP F4: which side of test_reduced_model_forward_through_kernels
    can vary from run to run.  Two card forwards on one input are bit-equal
    and two CPU forwards at one thread count are; prints the largest
    card-vs-CPU difference over a few inputs, and the CPU forward's
    difference between one thread and the default count."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("recurrentgemma-2b").reduced()
    params = M.init_params(cfg, cuda_device, seed=3)
    cpu_params = M.init_params(cfg, "cpu")
    cpu_params.load_state_dict({k: v.cpu() for k, v in
                                params.state_dict().items()})
    rng = np.random.default_rng(74)
    worst = 0.0
    threads = torch.get_num_threads()
    for _ in range(4):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1100)))
        card = [M.forward(params, {"tokens": tok.to(cuda_device)}, cfg)[0]
                for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(card[0], card[1])
        cpu = [M.forward(cpu_params, {"tokens": tok}, cfg)[0]
               for _ in range(2)]
        assert torch.equal(cpu[0], cpu[1])
        torch.set_num_threads(1)
        try:
            one = M.forward(cpu_params, {"tokens": tok}, cfg)[0]
        finally:
            torch.set_num_threads(threads)
        worst = max(worst, (card[0].cpu() - cpu[0]).abs().max().item())
        print(f"[F4] card vs CPU max |diff| {worst:.4g}; CPU 1 thread vs "
              f"{threads}: max |diff| "
              f"{(one - cpu[0]).abs().max().item():.4g}, bit-equal "
              f"{torch.equal(one, cpu[0])}")


@pytest.mark.parametrize("device_topk", [False, True])
def test_device_stage_times_on_card(cuda_device, device_topk):
    """The engine's CUDA events give a query's device time of routing, MR¹
    and MR², each positive; a batch's shared groups count on its first
    response alone, and the events return to the engine's pool."""
    schema, kws = _serving_schema()
    session = FCTSession(schema, device=cuda_device,
                         config=SessionConfig(device_topk=device_topk))
    req = FCTRequest(keywords=tuple(kws), top_k=10, r_max=4)
    session.query(req)                            # builds and uploads
    warm = session.query(req)
    assert warm.finalize == ("device_topk" if device_topk else "host")
    for key in fct_engine.DEVICE_STAGES:
        assert warm.timings[key] > 0, key
    lead, follow = session.query_batch([req, FCTRequest(
        keywords=tuple(kws[:2]), top_k=5, r_max=4)])
    assert all(lead.timings[k] > 0 for k in fct_engine.DEVICE_STAGES)
    assert not set(fct_engine.DEVICE_STAGES) & set(follow.timings)
    assert len(session.engine._events) >= 4


def _htod_copies(prof, path):
    """``(name, bytes)`` of every host-to-device copy in a profile, read
    from its Chrome trace (the only place the profiler gives the size)."""
    import json
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], int(e["args"]["bytes"])) for e in events
            if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]


@pytest.mark.parametrize("P", [1, 8])
def test_warm_store_query_copies_nothing_from_the_host(cuda_device, tmp_path,
                                                       P):
    """A memoized plan's send tables stay on the card: under the profiler
    the cold query copies its columns and tables to the card, the warm
    query no host-to-device copy above 4 KB, and the warm answer equals the
    storeless call's (plus the map-only CNs) and ``fct_star``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.schema import PAD_ID
    schema, kws = _serving_schema()
    session = FCTSession(schema, device=cuda_device, n_workers=P)
    req = FCTRequest(keywords=tuple(kws), top_k=10, r_max=4)
    copies = {}
    for name in ("cold", "warm"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            resp = session.query(req)
            torch.cuda.synchronize()
        copies[name] = _htod_copies(prof, tmp_path / f"{name}.json")
    assert max(b for _, b in copies["cold"]) > 4096
    assert [c for c in copies["warm"] if c[1] > 4096] == []
    assert resp.engine_stats["bytes_shipped"] == 0
    assert resp.engine_stats["send_uploads"] == 0
    assert resp.engine_stats["send_hits"] > 0
    planned = session._plan(req)
    host = fct_engine.FCTEngine().run_plans(planned.plans, session.mesh)
    want = planned.host_freq + host
    want[PAD_ID] = 0
    np.testing.assert_array_equal(resp.all_freqs, want)
    np.testing.assert_array_equal(resp.all_freqs, fct_star(schema, kws, 4))
