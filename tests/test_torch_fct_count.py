"""fct_count in the port: the plain PyTorch version against the JAX package's
Pallas kernel (interpret mode) and its jnp oracle on the same numpy-seeded
inputs, numpy oracles for int64, the batch (CN) axis, device dispatch and
the wrapper's checks.  The CUDA kernel itself is held against its plain
version on the card in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fct_count import ref as jax_ref
from repro.kernels.fct_count.ops import weighted_histogram as jax_histogram
from repro_torch.kernels import _build
from repro_torch.kernels.fct_count import kernel, ops
from repro_torch.kernels.fct_count.ops import weighted_histogram

RNG = np.random.default_rng(0)
_TORCH = {np.int32: torch.int32, np.float32: torch.float32,
          np.int64: torch.int64}


def _port(toks, w, vocab):
    return weighted_histogram(torch.from_numpy(toks), torch.from_numpy(w),
                              vocab).numpy()


def _jax(toks, w, vocab, interpret):
    t, ww = jnp.asarray(toks), jnp.asarray(w)
    if interpret:
        return np.asarray(jax_histogram(t, ww, vocab, backend="interpret"))
    return np.asarray(jax_ref.weighted_histogram(t, ww, vocab))


def _np_uint64(toks, w, vocab):
    """Exact histogram modulo 2^64 in numpy uint64, PAD and out-of-range
    ids dropped."""
    flat = toks.reshape(-1).astype(np.int64)
    ww = np.repeat(w.astype(np.int64).view(np.uint64), toks.shape[1])
    keep = (flat != 0) & (flat >= 0) & (flat < vocab)
    out = np.zeros(vocab, np.uint64)
    np.add.at(out, flat[keep], ww[keep])
    return out.view(np.int64)


# --- the shapes and cases of the JAX package's own kernel tests -------------

@pytest.mark.parametrize("n,tl,vocab", [
    (128, 8, 512), (300, 5, 100), (1024, 16, 4096), (7, 3, 33), (1, 1, 2),
])
@pytest.mark.parametrize("wdtype", [np.int32, np.float32])
def test_plain_matches_jax_kernel_and_ref(n, tl, vocab, wdtype):
    toks = RNG.integers(0, vocab, (n, tl)).astype(np.int32)
    w = RNG.integers(0, 9, (n,)).astype(wdtype)
    got = _port(toks, w, vocab)
    assert got.dtype == wdtype
    # float32 totals stay far below 2^24 here, so every path is exact
    np.testing.assert_array_equal(got, _jax(toks, w, vocab, interpret=True))
    np.testing.assert_array_equal(got, _jax(toks, w, vocab, interpret=False))


def test_pad_never_counted():
    toks = np.zeros((16, 4), np.int32)
    w = np.ones((16,), np.int32)
    got = _port(toks, w, 64)
    assert not got.any()
    np.testing.assert_array_equal(got, _jax(toks, w, 64, interpret=True))


def test_exact_across_2_24_boundary():
    toks = RNG.integers(1, 16, (512, 5)).astype(np.int32)
    w = RNG.integers(0, 1 << 19, (512,)).astype(np.int32)
    got = _port(toks, w, 100)
    assert int(got.max()) > (1 << 24)
    np.testing.assert_array_equal(got, _jax(toks, w, 100, interpret=True))
    np.testing.assert_array_equal(got, _jax(toks, w, 100, interpret=False))


def test_int32_wraps_like_the_reference():
    toks = np.full((24, 1), 7, np.int32)
    w = np.full((24,), (1 << 27) + 12345, np.int32)     # total ~3.2e9 > 2^31
    got = _port(toks, w, 64)
    assert int(got[7]) < 0                              # genuinely wrapped
    np.testing.assert_array_equal(got, _jax(toks, w, 64, interpret=True))
    np.testing.assert_array_equal(got, _jax(toks, w, 64, interpret=False))


def test_many_rows_all_weight_bits():
    toks = RNG.integers(1, 8, (1024, 4)).astype(np.int32)
    w = RNG.integers(0, 1 << 14, (1024,)).astype(np.int32)
    got = _port(toks, w, 64)
    np.testing.assert_array_equal(got, _jax(toks, w, 64, interpret=True))
    np.testing.assert_array_equal(got.astype(np.int64),
                                  _np_uint64(toks, w, 64))


@pytest.mark.parametrize("lo,hi,vocab,past", [
    ((1 << 31) - 4, 1 << 35, 128, 1 << 33),   # totals past 2^33
    (1 << 61, 1 << 62, 64, None),             # wraps modulo 2^64
])
def test_int64_exact_against_numpy(lo, hi, vocab, past):
    toks = RNG.integers(1, 50 if vocab > 64 else 30, (300, 3)).astype(np.int32)
    w = RNG.integers(lo, hi, (300,)).astype(np.int64)
    got = _port(toks, w, vocab)
    assert got.dtype == np.int64
    if past is not None:
        assert int(got.max()) > past
    np.testing.assert_array_equal(got, _np_uint64(toks, w, vocab))


def test_negative_and_out_of_vocab_tokens_dropped_like_the_kernel():
    # the JAX package disagrees with itself on negative ids: its jnp oracle
    # wraps -1 into the top bin, its Pallas kernel drops it; the port
    # follows the kernel
    toks = np.array([[-1, 3]], np.int32)
    w = np.array([5], np.int32)
    got = _port(toks, w, 8)
    np.testing.assert_array_equal(got, _jax(toks, w, 8, interpret=True))
    assert got[7] == 0 and got[3] == 5
    assert _jax(toks, w, 8, interpret=False)[7] == 5   # the disagreement
    big = np.array([[8, 9, 100, 2]], np.int32)          # ids >= vocab
    np.testing.assert_array_equal(_port(big, w, 8),
                                  _jax(big, w, 8, interpret=True))


@pytest.mark.parametrize("wdtype", [np.int32, np.int64, np.float32])
def test_batch_axis_equals_per_entry(wdtype):
    B, R, L, V = 3, 40, 5, 33
    toks = RNG.integers(-2, V + 3, (B, R, L)).astype(np.int32)
    w = RNG.integers(-9, 9, (B, R)).astype(wdtype)
    got = weighted_histogram(torch.from_numpy(toks), torch.from_numpy(w), V)
    assert got.shape == (B, V)
    for b in range(B):
        np.testing.assert_array_equal(got[b].numpy(),
                                      _jax(toks[b], w[b], V, interpret=True))


# --- dispatch and the wrapper's checks (CPU) --------------------------------

def test_dispatch_goes_by_device():
    toks = torch.from_numpy(RNG.integers(1, 16, (8, 2)).astype(np.int32))
    w = torch.ones((8,), dtype=torch.int32)
    ops.reset_path_counts()
    weighted_histogram(toks, w, 64)
    assert ops.PATH_COUNTS == {"ref": 1, "cuda_exact": 0, "cuda_float": 0,
                               "cuda_routed": 0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        weighted_histogram(toks, w, 64, backend="cuda")
    with pytest.raises(ValueError, match="unknown fct_count backend"):
        weighted_histogram(toks, w, 64, backend="pallas")
    assert ops.PATH_COUNTS["cuda_exact"] == 0


def test_launch_shape_tiles_the_vocab():
    # int32 bins of a 32 768 vocab fit one 128 KB tile; int64 need two
    tile32, _ = kernel.launch_shape(1, 1 << 20, 16, 32768, 4)
    tile64, _ = kernel.launch_shape(1, 1 << 20, 16, 32768, 8)
    assert tile32 == 32768 and -(-32768 // tile64) == 2
    tile, rows = kernel.launch_shape(4, 10, 3, 33, 4)   # tiny: one chunk
    assert tile == 33 and rows >= 10
    # the main path's largest call: whole steps of 32 warps x 32 rows, and
    # about TARGET_BLOCKS blocks over the batch and both int64 tiles
    for itemsize in (4, 8):
        tile, rows = kernel.launch_shape(4, 1 << 23, 16, 32768, itemsize)
        assert rows % kernel.BLOCK_ROWS == 0
        blocks = 4 * -(-(1 << 23) // rows) * -(-32768 // tile)
        assert kernel.TARGET_BLOCKS <= blocks < 2 * kernel.TARGET_BLOCKS
    assert kernel.TILE_BYTES <= 227 * 1024


def test_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// nothing\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: "false")
    lib = _build.Library("fct_count", src, kernel.SYMBOLS)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        lib.load()


# --- MR² by reference: the routed op (CPU: its plain version) ---------------

def _routed_case(P, S, L, C, N, V, wdtype, shared, rng):
    """N CNs' ``[P, S, L]`` texts (one tensor for all, or one each; PAD
    and ids past the vocab among the tokens), send tables with -1 pads and indices past ``S`` (clamped), and weights with
    zero runs; integer weights reach past 2^31 (int32 wraps) and into the
    high bits (int64)."""
    text = [torch.from_numpy(rng.integers(0, V + 2, (P, S, L))
                             .astype(np.int32))
            for _ in range(1 if shared else N)]
    texts = text * N if shared else text
    send = rng.integers(-1, S + 3, (N, P, P, C)).astype(np.int32)
    hi = {np.int32: 1 << 30, np.int64: 1 << 62}[wdtype]
    w = rng.integers(0, hi, (N, P, P * C)).astype(wdtype)
    w[:, :, : P * C // 2] = 0                     # a zero run
    w[rng.random(w.shape) < 0.3] = 0
    return texts, torch.from_numpy(send), torch.from_numpy(w)


def _materialized(texts, send, weights, vocab):
    """Routed tokens built slot by slot in numpy (source row ``clamp(send,
    0, S-1)`` of source ``src``, delivered to ``dst``), then the plain
    histogram of the port, held to the JAX package's reference (int32) or
    to numpy's modulo-2^64 sum (int64)."""
    N, P, _, C = send.shape
    S, L = texts[0].shape[1:]
    s = send.numpy()
    toks = np.zeros((N, P, P * C, L), np.int32)
    for n in range(N):
        t = texts[n].numpy()
        for dst in range(P):
            for src in range(P):
                for c in range(C):
                    row = min(max(int(s[n, src, dst, c]), 0), S - 1)
                    toks[n, dst, src * C + c] = t[src, row]
    flat = toks.reshape(N, P * P * C, L)
    w = weights.numpy().reshape(N, P * P * C)
    want = weighted_histogram(torch.from_numpy(flat), torch.from_numpy(w),
                              vocab).numpy()
    for n in range(N):
        np.testing.assert_array_equal(
            want[n], _jax(flat[n], w[n], vocab, interpret=False)
            if w.dtype == np.int32 else _np_uint64(flat[n], w[n], vocab))
    return want


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("wdtype", [np.int32, np.int64])
@pytest.mark.parametrize("P", [1, 3, 8])
def test_routed_plain_equals_materialize_then_histogram(P, wdtype, shared):
    rng = np.random.default_rng(P)
    V = 97
    texts, send, w = _routed_case(P, 7, 5, 4, 3, V, wdtype, shared, rng)
    ops.reset_path_counts()
    got = ops.routed_histogram(texts, send, w, V)
    assert ops.PATH_COUNTS["ref"] == 1 and ops.PATH_COUNTS["cuda_routed"] == 0
    assert got.dtype == w.dtype and got.shape == (3, V)
    np.testing.assert_array_equal(got.numpy(),
                                  _materialized(texts, send, w, V))


def test_routed_dispatch_and_checks():
    rng = np.random.default_rng(1)
    texts, send, w = _routed_case(2, 5, 4, 2, 2, 33, np.int32, True, rng)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.routed_histogram(texts, send, w, 33, backend="cuda")
    with pytest.raises(ValueError, match="unknown fct_count backend"):
        ops.routed_histogram(texts, send, w, 33, backend="pallas")
    # the routed kernel has integer instantiations only
    assert set(kernel.ROUTED) == {torch.int32, torch.int64}
    names = {name for _, name in kernel.ROUTED.values()}
    assert all("fct_count" in n for n in names)
    assert names <= set(kernel.LAUNCHES)
