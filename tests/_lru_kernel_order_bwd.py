"""The CUDA ``lru_scan`` backward kernel's order of arithmetic, emulated in
numpy: the reverse chunk walk.

Shared by ``tests/test_torch_lru_scan.py`` (on the CPU: the order against
the plain loop's autograd under the 1e-5 rule) and ``tests/test_torch_cuda.py``
(on the card: the kernel against this emulation, bit for bit).  Imports
neither JAX nor torch.
"""
import numpy as np

from _lru_kernel_order import fmaf


def kernel_order_bwd(a, h, dh, sub, chunk):
    """(da, db) of the kernel's reverse scan over float32 ``a, h, dh
    [B, S, W]`` with sub-chunks of ``sub`` steps in chunks of ``chunk``
    steps, in its order of arithmetic.  The coefficient at step t is
    a[t + 1] (0 at t = S - 1 and past S), dh and h[t - 1] are 0 past their
    ends.  Each sub-chunk, from its last step, gives (prod of its
    coefficients, g at its first step with a zero carry); they combine from
    the last into each chunk's (A, H); the chunk carries are the serial
    chain P_c = fmaf(A_c, P_{c+1}, H_c) from the last chunk, as the
    look-back folds them; each sub-chunk's carry-in is its chunk's carry
    folded through the sub-chunks after it, and the loop runs again from
    there backwards: g = fmaf(a[t + 1], g, dh[t]), db = g, da = g * h[t - 1]
    (one float32 product)."""
    B, S, W = a.shape
    k = chunk // sub
    n = -(-S // chunk)
    T = n * chunk
    coef = np.zeros((B, T, W), np.float32)
    coef[:, :S - 1] = a[:, 1:]
    grad = np.zeros((B, T, W), np.float32)
    grad[:, :S] = dh
    cp = coef.reshape(B, n, k, sub, W)
    dp = grad.reshape(B, n, k, sub, W)
    pa = np.ones((B, n, k, W), np.float32)
    pg = np.zeros((B, n, k, W), np.float32)
    for i in reversed(range(sub)):
        pa = pa * cp[:, :, :, i]
        pg = fmaf(cp[:, :, :, i], pg, dp[:, :, :, i])
    ta = np.ones((B, n, W), np.float32)
    th = np.zeros((B, n, W), np.float32)
    for s in reversed(range(k)):
        ta = ta * pa[:, :, s]
        th = fmaf(pa[:, :, s], th, pg[:, :, s])
    carry = np.empty((B, n, W), np.float32)
    p = np.zeros((B, W), np.float32)
    for c in reversed(range(n)):
        carry[:, c] = p
        p = fmaf(ta[:, c], p, th[:, c])
    piece_in = np.empty((B, n, k, W), np.float32)
    q = carry
    for s in reversed(range(k)):
        piece_in[:, :, s] = q
        q = fmaf(pa[:, :, s], q, pg[:, :, s])
    out = np.empty_like(cp)
    g = piece_in
    for i in reversed(range(sub)):
        g = fmaf(cp[:, :, :, i], g, dp[:, :, :, i])
        out[:, :, :, i] = g
    db = out.reshape(B, T, W)[:, :S]
    prev = np.zeros_like(h)
    prev[:, 1:] = h[:, :-1]
    return db * prev, db
