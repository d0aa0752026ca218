"""The port's plain ``lru_scan`` (the version a CPU tensor takes) against
the JAX package's plain version (``repro.kernels.lru_scan.ref``, an
associative scan) and the numpy loop of ``tests/test_kernels.py``, on the
same numpy-seeded inputs.  Not against the Pallas kernel, which does not run
under the installed JAX (``pl.load`` is gone).

Tolerance rtol = atol = 1e-5 in float32, as the reference's own test: the
associative scan multiplies in another order than the loop.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lru_scan import ref as jax_ref
from repro_torch.kernels.lru_scan import kernel, ops

TOL = 1e-5


def _inputs(seed, b, s, w, lo=0.8):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, 1.0, (b, s, w)).astype(np.float32)
    x = rng.normal(size=(b, s, w)).astype(np.float32)
    return a, x


def _numpy_loop(a, x):
    h = np.zeros(a.shape[::2], np.float32)
    out = np.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + x[:, t]
        out[:, t] = h
    return out


@pytest.mark.parametrize("b,s,w", [(2, 64, 32), (1, 300, 700), (3, 17, 5)])
def test_plain_matches_reference_and_loop(b, s, w):
    a, x = _inputs(b * 1000 + s, b, s, w)
    ops.reset_path_counts()
    got = ops.lru_scan(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    assert ops.PATH_COUNTS == {"ref": 1, "cuda": 0}
    want = np.asarray(jax_ref.lru_scan(jnp.asarray(a), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _numpy_loop(a, x), rtol=TOL, atol=TOL)


def test_plain_matches_sequential_wide_gates():
    a, x = _inputs(7, 1, 37, 3, lo=0.5)
    got = ops.lru_scan(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _numpy_loop(a, x), rtol=2e-5, atol=2e-5)


def test_bfloat16_keeps_a_float32_carry():
    a, x = _inputs(3, 2, 50, 8)
    got = ops.lru_scan(torch.from_numpy(a).bfloat16(),
                       torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    a16 = torch.from_numpy(a).bfloat16().float().numpy()
    x16 = torch.from_numpy(x).bfloat16().float().numpy()
    want = torch.from_numpy(_numpy_loop(a16, x16)).bfloat16()
    # the carry stays float32; only the stored h is rounded, once
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cuda_backend_refuses_cpu_tensors():
    a = torch.ones(1, 4, 2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.lru_scan(a, a, backend="cuda")
    with pytest.raises(ValueError, match="unknown lru_scan backend"):
        ops.lru_scan(a, a, backend="pallas")
    assert kernel.LAUNCHES["lru_scan"] == 0
