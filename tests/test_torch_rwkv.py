"""The RWKV6 family of the port against the JAX package on the CPU
(``reduced()``, float32: forward's logits, ``loss_fn`` and every gradient
leaf, decode step by step; tolerances in ``tests/_torch_arch_check.py``),
the WKV recurrence in both its forms, and the performance switches.

  - ``_wkv_scan`` against the reference's within 1e-5 (float32, summation
    order only), and ``_wkv_chunked`` against the scan within the
    reference's own 5e-5 (``tests/test_perf_paths.py``), at its shapes;
  - ``perf_options("rwkv_chunked")`` through the whole model against the
    reference's model under the same option (1e-4 on logits);
  - ``perf_options`` scoping and its option set, and ``remat_dots``, which
    leaves the loss and gradients bit-equal (same arithmetic, recomputed);
  - ``mesh_shares_for_training`` equal to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_arch_check import (check_decode, check_forward,
                               check_loss_and_grads, pair)
from _torch_fixtures import one_torch_thread  # noqa: F401
from repro.core.shares import \
    mesh_shares_for_training as jax_mesh_shares_for_training
from repro.distributed import perf_options as jax_perf_options
from repro.models import model as JM
from repro.models import rwkv6 as jax_rwkv
from repro_torch.core.shares import mesh_shares_for_training
from repro_torch.distributed import perf_options as popts
from repro_torch.distributed.perf_options import (enabled, grid,
                                                  perf_options, virtual_grid)
from repro_torch.models import model as M
from repro_torch.models import rwkv6

ARCH = "rwkv6_1b6"
WKV_SHAPES = [((2, 64, 3, 8), 16), ((1, 128, 2, 16), 32)]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_forward_loss_and_grads_match_reference():
    pr = pair(ARCH)
    _, aux = check_forward(pr, 2, 32)
    assert float(aux) == 0.0
    check_loss_and_grads(pr, 2, 48)


def test_decode_matches_reference():
    check_decode(pair(ARCH), 20)


def _wkv_inputs(shape):
    rng = np.random.default_rng(0)
    b, S, h, d = shape
    r, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.7, 0.999, shape).astype(np.float32)
    u = rng.normal(size=(h, d)).astype(np.float32)
    s0 = (rng.normal(size=(b, h, d, d)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("shape,chunk", WKV_SHAPES)
def test_wkv_scan_and_chunked(shape, chunk):
    arrays = _wkv_inputs(shape)
    t = [torch.from_numpy(a) for a in arrays]
    o1, s1 = rwkv6._wkv_scan(*t)
    o2, s2 = rwkv6._wkv_chunked(*t, chunk=chunk)
    jo, js = jax_rwkv._wkv_scan(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(o1.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(o2.numpy(), o1.numpy(), atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), atol=5e-5, rtol=5e-5)


def test_chunked_option_through_the_model():
    pr = pair(ARCH)
    tok = np.random.default_rng(3).integers(0, pr.cfg.vocab_size, (2, 64))
    with jax_perf_options.perf_options("rwkv_chunked"):
        want, _ = jax.jit(lambda p, x: JM.forward(p, x, pr.jcfg))(
            pr.jparams, {"tokens": jnp.asarray(tok, jnp.int32)})
    with torch.no_grad():
        plain, _ = M.forward(pr.params, {"tokens": torch.from_numpy(tok)},
                             pr.cfg)
        with perf_options("rwkv_chunked"):
            got, _ = M.forward(pr.params, {"tokens": torch.from_numpy(tok)},
                               pr.cfg)
    assert not torch.equal(got, plain)      # the chunked form did run
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_perf_options_scoping():
    assert popts.KNOWN == jax_perf_options.KNOWN
    assert not enabled("bf16_flash")
    with perf_options("bf16_flash", "remat_dots"):
        assert enabled("bf16_flash") and enabled("remat_dots")
        assert not enabled("moe_shardmap")
        with perf_options("moe_shardmap"):
            assert popts.active() == {"bf16_flash", "remat_dots",
                                      "moe_shardmap"}
        assert not enabled("moe_shardmap")
    assert not enabled("bf16_flash") and popts.active() == frozenset()
    with pytest.raises(AssertionError):
        with perf_options("not_a_real_option"):
            pass
    assert grid() is None
    with virtual_grid(2, 4):
        assert grid() == (2, 4)
        with virtual_grid(1, 1):
            assert grid() == (1, 1)
        assert grid() == (2, 4)
    assert grid() is None
    with pytest.raises(ValueError):
        with virtual_grid(0, 4):
            pass


def test_remat_dots_option_keeps_loss_and_gradients():
    pr = pair("smollm_360m")
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, pr.cfg.vocab_size, (2, 32)))
    batch = {"tokens": tok, "labels": tok}

    def run():
        pr.params.requires_grad_(True)
        pr.params.zero_grad(set_to_none=True)
        total, _ = M.loss_fn(pr.params, batch, pr.cfg)
        total.backward()
        grads = [p.grad.clone() for p in pr.params.parameters()]
        pr.params.zero_grad(set_to_none=True)
        pr.params.requires_grad_(False)
        return total.detach(), grads

    plain = run()
    with perf_options("remat_dots"):
        dots = run()
    assert torch.equal(plain[0], dots[0])
    assert all(torch.equal(a, b) for a, b in zip(plain[1], dots[1]))


@pytest.mark.parametrize("batch_comm,model_comm,k", [
    (1e9, 4e8, 8), (3e6, 9e8, 16), (5e8, 5e8, 4), (7e7, 1e6, 12)])
def test_mesh_shares_for_training_matches_reference(batch_comm, model_comm,
                                                    k):
    got = mesh_shares_for_training(batch_comm, model_comm, k)
    want = jax_mesh_shares_for_training(batch_comm, model_comm, k)
    assert tuple(got.shares) == tuple(want.shares)
    assert got.k == want.k and got.cost == pytest.approx(want.cost)
