"""The port on the card: the hand-written CUDA ``fct_count`` kernel against
its plain version, and a small FCT session end to end against the port's
numpy ``fct_star`` oracle.  Imports neither JAX nor the JAX package, so it
runs on a GPU machine that has none; every test skips where there is no
CUDA device.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import FCTRequest, FCTSession, SessionConfig
from repro_torch.core.star import fct_star, topk_terms
from repro_torch.data.tpch import TpchConfig, generate, plant_keywords
from repro_torch.kernels.fct_count import kernel, ops
from repro_torch.kernels.fct_count.ops import weighted_histogram

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
    kernel.reset_launches()
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
