"""The CUDA ``lru_scan`` kernel's order of arithmetic, emulated in numpy.

Shared by ``tests/test_torch_lru_scan.py`` (on the CPU: the order against
the plain loop under the 1e-5 rule) and ``tests/test_torch_cuda.py`` (on the
card: the kernel against this emulation, bit for bit).  Imports neither JAX
nor torch.
"""
import numpy as np


def fmaf(a, h, b):
    """fmaf in float32, correctly rounded, on float32 arrays.

    The product of two float32 values is exact in float64.  The float64 sum
    s = p + b is rounded, but TwoSum gives its exact error e (p + b = s + e
    exactly).  Rounding s to float32 then rounds p + b correctly unless s lies
    exactly halfway between two float32 values and e is not 0: there e says
    which side p + b lies on."""
    p = a.astype(np.float64) * h.astype(np.float64)
    b = b.astype(np.float64)
    s = p + b
    bb = s - p
    e = (p - (s - bb)) + (b - bb)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    lo = np.where(r64 <= s, r, np.nextafter(r, np.float32(-np.inf)))
    hi = np.where(r64 <= s, np.nextafter(r, np.float32(np.inf)), r)
    tie = s == (lo.astype(np.float64) + hi.astype(np.float64)) / 2
    return np.where(tie & (e > 0), hi, np.where(tie & (e < 0), lo, r))


def kernel_order(a, b, sub, chunk):
    """h of the kernel's single-pass scan of float32 ``a, b [B, S, W]`` with
    sub-chunks of ``sub`` steps in chunks of ``chunk`` steps, in its order of
    arithmetic: each sub-chunk gives (prod a, zero-carry end); they combine
    in order into each chunk's (A, H); the chunk carries are the serial chain
    P_c = fmaf(A_c, P_{c-1}, H_c), as the look-back folds them; each
    sub-chunk's carry-in is its chunk's carry folded through the sub-chunks
    before it, and the plain loop runs again from there.  Steps past S load
    as 0, as in the kernel."""
    B, S, W = a.shape
    k = chunk // sub
    n = -(-S // chunk)
    pad = ((0, 0), (0, n * chunk - S), (0, 0))
    ap = np.pad(a, pad).reshape(B, n, k, sub, W)
    bp = np.pad(b, pad).reshape(B, n, k, sub, W)
    pa = np.ones((B, n, k, W), np.float32)
    ph = np.zeros((B, n, k, W), np.float32)
    for i in range(sub):
        pa = pa * ap[:, :, :, i]
        ph = fmaf(ap[:, :, :, i], ph, bp[:, :, :, i])
    ta = np.ones((B, n, W), np.float32)
    th = np.zeros((B, n, W), np.float32)
    for s in range(k):
        ta = ta * pa[:, :, s]
        th = fmaf(pa[:, :, s], th, ph[:, :, s])
    carry_in = np.empty((B, n, W), np.float32)
    p = np.zeros((B, W), np.float32)
    for c in range(n):
        carry_in[:, c] = p
        p = fmaf(ta[:, c], p, th[:, c])
    piece_in = np.empty((B, n, k, W), np.float32)
    q = carry_in
    for s in range(k):
        piece_in[:, :, s] = q
        q = fmaf(pa[:, :, s], q, ph[:, :, s])
    out = np.empty_like(ap)
    h = piece_in
    for i in range(sub):
        h = fmaf(ap[:, :, :, i], h, bp[:, :, :, i])
        out[:, :, :, i] = h
    return out.reshape(B, n * chunk, W)[:, :S]
