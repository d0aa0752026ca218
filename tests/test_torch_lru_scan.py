"""The port's plain ``lru_scan`` (the version a CPU tensor takes) against
the JAX package's plain version (``repro.kernels.lru_scan.ref``, an
associative scan) and the numpy loop of ``tests/test_kernels.py``, on the
same numpy-seeded inputs.  Not against the Pallas kernel, which does not run
under the installed JAX (``pl.load`` is gone).

Tolerance rtol = atol = 1e-5 in float32, as the reference's own test: the
associative scan multiplies in another order than the loop.

The CUDA kernel cannot run here; its order of arithmetic (chunked
aggregates, forward-folded carries, recompute from the carry-in) is
emulated in numpy (``tests/_lru_kernel_order.py``) and held to the same 1e-5
rule against the plain loop, the rule ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the kernel to on the card; there the
kernel is also held to the emulation bit for bit.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lru_kernel_order import fmaf, kernel_order
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


# --- the CUDA kernel's order of arithmetic, emulated --------------------------

#: (timesteps a sub-chunk, timesteps a chunk): the kernel's float32 geometry
#: (``lru_scan_geometry``; the card test reads it from the built library)
#: and a finer one, to show the order's accuracy does not hinge on it
GEOMETRIES = [(8, 128), (4, 64)]


def _round_f32(q):
    """The exact rational ``q`` rounded to float32, to nearest even."""
    c = np.float32(float(q))
    near = [np.nextafter(c, np.float32(-np.inf)), c,
            np.nextafter(c, np.float32(np.inf))]
    return min(near, key=lambda x: (abs(Fraction(float(x)) - q),
                                    int(np.array(x).view(np.uint32)) & 1))


def _ties():
    """(a, h, b) whose float64 sum a·h + b rounds to a point exactly halfway
    between two float32 values while the exact sum lies off it, on either
    side: one float64 rounding then one to float32 goes the wrong way in
    half of them."""
    out = []
    for k in range(-20, 31, 10):
        u = 2.0 ** (k - 23)  # float32 spacing at 2^k
        for sign in (1.0, -1.0):
            # 2^k + u/2 - tiny, and 2^k + u + (-u/2 + tiny) = 2^k + u/2 + tiny
            out.append((1 + 2.0 ** -23, sign * (u / 2) * (1 - 2.0 ** -23),
                        sign * 2.0 ** k))
            out.append((-(1 + 2.0 ** -23), sign * (u / 2) * (1 - 2.0 ** -23),
                        sign * (2.0 ** k + u)))
    return [np.array(v, np.float32) for v in zip(*out)]


@pytest.mark.parametrize("case", ["random", "ties"])
def test_fmaf_is_correctly_rounded(case):
    """The emulation's fmaf against exact rational arithmetic: the exact
    a·h + b rounded once to float32, as the card's fmaf rounds it."""
    if case == "random":
        rng = np.random.default_rng(3)
        a, h, b = ((rng.normal(size=4000) * 2.0 ** rng.integers(-30, 30, 4000))
                   .astype(np.float32) for _ in range(3))
    else:
        a, h, b = _ties()
        assert not np.array_equal(
            fmaf(a, h, b),
            (a.astype(np.float64) * h + b).astype(np.float32))
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y))
                       + Fraction(float(z))) for x, y, z in zip(a, h, b)]
    assert np.array_equal(fmaf(a, h, b).view(np.uint32),
                          np.array(want, np.float32).view(np.uint32))


def _gated_inputs(seed, b, s, w, long_memory=False):
    """a and gated x as ``models/rglru.py::_gates`` makes them at
    initialisation: a = a0^r with a0 in [0.9, 0.999] across channels (the Λ
    init) and r = σ(N(0, 1)); x scaled by sqrt(1 - a²)·σ(N(0, 1)).  With
    ``long_memory`` a is uniform in [0.999, 1)."""
    rng = np.random.default_rng(seed)
    sig = lambda z: 1.0 / (1.0 + np.exp(-z))
    if long_memory:
        a = rng.uniform(0.999, 1.0, (b, s, w))
    else:
        a0 = np.linspace(0.9, 0.999, w)
        a = np.exp(np.log(a0) * sig(rng.normal(size=(b, s, w))))
    a = a.astype(np.float32)
    x = (np.sqrt(np.maximum(1.0 - a.astype(np.float64) ** 2, 1e-12))
         * sig(rng.normal(size=(b, s, w))) * rng.normal(size=(b, s, w)))
    return a, x.astype(np.float32)


@pytest.mark.parametrize("sub,chunk", GEOMETRIES)
@pytest.mark.parametrize("b,s,w,long_memory", [
    (1, 2304, 64, False), (2, 2304 + 37, 48, False), (1, 8192, 16, True)])
def test_kernel_order_within_the_rule_of_the_plain_loop(b, s, w, long_memory,
                                                        sub, chunk):
    """The kernel's order of arithmetic (chunked aggregates, forward-folded
    carries, recompute from the carry-in) against the port's plain loop, by
    the rule the card holds the kernel to: |kernel - plain| <= 1e-5 +
    1e-5 |plain|.  Worst share of that limit on these inputs at the kernel's
    geometry: 0.060 and 0.054 at the gates' statistics, 0.120 at long
    memory (0.074, 0.057, 0.121 at the finer one).  It is also no farther from a float64 loop than the plain loop
    is, up to one float32 rounding of |h|."""
    a, x = _gated_inputs(b * 7919 + s + w, b, s, w, long_memory)
    got = kernel_order(a, x, sub, chunk)
    want = ops.lru_scan(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    share = np.max(np.abs(got - want) / (TOL + TOL * np.abs(want)))
    assert share <= 1.0, f"worst error {share} of the 1e-5 limit"
    exact = _numpy_loop(a.astype(np.float64), x.astype(np.float64))
    err_kernel = np.max(np.abs(got - exact))
    err_plain = np.max(np.abs(want - exact))
    ulp = np.finfo(np.float32).eps * np.max(np.abs(exact))
    assert err_kernel <= err_plain + ulp, (err_kernel, err_plain)


def test_kernel_order_as_accurate_as_the_plain_loop_without_the_gates():
    """a in [0.999, 1) with x ~ N(0, 1), not scaled by sqrt(1 - a²) as the
    gates scale it: |h| reaches about 100, where float32 rounding alone
    moves h by more than the 1e-5 rule allows, so no order of the
    arithmetic, the plain loop's included, meets it against another.  The
    kernel's order is held to a float64 loop instead: no farther from it
    than the plain loop, up to one float32 rounding of |h|."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0.999, 1.0, (1, 8192, 16)).astype(np.float32)
    x = rng.normal(size=(1, 8192, 16)).astype(np.float32)
    got = kernel_order(a, x, *GEOMETRIES[0])
    want = ops.lru_scan(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    exact = _numpy_loop(a.astype(np.float64), x.astype(np.float64))
    assert np.max(np.abs(exact)) > 50
    ulp = np.finfo(np.float32).eps * np.max(np.abs(exact))
    assert (np.max(np.abs(got - exact))
            <= np.max(np.abs(want - exact)) + ulp)
