"""The port on the card: the hand-written CUDA kernels (``fct_count``,
``flash_attention``, ``lru_scan``) against their plain versions, a small FCT
session end to end against the port's numpy ``fct_star`` oracle, and a
reduced recurrentgemma-2b forward through both LM kernels against the plain
path.  Imports neither JAX nor the JAX package, so it runs on a GPU machine
that has none; every test skips where there is no CUDA device.

Tolerances: flash 2e-5 in float32 and 4e-2 in bfloat16 (the reference's own,
``tests/test_kernels.py``); lru_scan 1e-5 (kernel and plain version run the
same float32 loop, up to fused multiply-adds); the model 1e-4 on logits of
magnitude < 1 (float32; summation order only).

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import FCTRequest, FCTSession, SessionConfig
from repro_torch.core.star import fct_star, topk_terms
from repro_torch.data.tpch import TpchConfig, generate, plant_keywords
from repro_torch.configs.base import get_arch
from repro_torch.kernels.fct_count import kernel, ops
from repro_torch.kernels.fct_count.ops import weighted_histogram
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.lru_scan import kernel as lru_kernel
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.models import model as M

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


def test_flash_kernel_reads_strided_inputs(cuda_device):
    qkv = torch.from_numpy(RNG.normal(size=(2, 70, 3, 4, 32))).float().to(
        cuda_device)
    q, k, v = qkv.unbind(2)          # strided views, last dim contiguous
    got = flash_ops.flash_attention(q, k, v, causal=True)
    want = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=True,
                                     backend="ref")
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,s,w", [(2, 64, 32), (1, 300, 700), (3, 17, 5),
                                   (1, 8192, 2560)])
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


def test_reduced_model_forward_through_kernels(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("recurrentgemma-2b").reduced()
    params = M.init_params(cfg, cuda_device, seed=3)
    tok = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 1100)))
    flash_kernel.LIB.reset_launches()
    lru_kernel.LIB.reset_launches()
    flash_ops.reset_path_counts()
    lru_ops.reset_path_counts()
    got = M.forward(params, {"tokens": tok.to(cuda_device)}, cfg)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES["flash_attention"] == 1
    assert lru_kernel.LAUNCHES["lru_scan"] == 2
    assert flash_ops.PATH_COUNTS["ref"] == lru_ops.PATH_COUNTS["ref"] == 0
    want = M.forward(params.to("cpu"), {"tokens": tok}, cfg)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
