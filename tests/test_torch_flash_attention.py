"""The port's plain ``flash_attention`` (the version a CPU tensor takes)
against the JAX package's ``flash_attention`` with ``backend="ref"`` and
with ``backend="interpret"`` (the Pallas kernel in interpret mode), on the
same numpy-seeded inputs, in the reference's ``[B, S, H, D]`` layout.

Tolerances are the reference's own (``tests/test_kernels.py``): 2e-5 in
float32, 4e-2 in bfloat16 (one bf16 rounding of outputs of magnitude ~1,
taken after float32 math on both sides).

The gradient: ``ops.flash_attention`` under autograd on CPU tensors (the
plain version differentiated) against ``jax.grad`` of the reference's plain
version, float32, over the same cases: every one of dq, dk, dv within 2e-5
of its max |g| plus 2e-5 relative (the forward's 2e-5, scaled by the
gradient's size: dk and dv sum over the query rows and the heads of a
group).  And the backward kernel's formula (``csrc/flash_attention.cu``:
delta = rowsum(dO o), P from the forward's log-sum-exp, dS = P (dO v - delta))
in plain PyTorch against that autograd, within the same rule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import kernel, ops

TOL = {"float32": 2e-5, "bfloat16": 4e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

CASES = [  # b, s, h, hkv, d, dv, causal, window, block_q, block_k
    (2, 128, 4, 2, 32, 32, True, None, 64, 32),    # GQA causal
    (1, 200, 6, 1, 16, 16, True, 64, 64, 32),      # MQA + local window, ragged S
    (2, 96, 4, 4, 32, 16, False, None, 64, 32),    # encoder, dv != d (MLA shape)
    (1, 64, 2, 2, 128, 128, True, None, 64, 32),
    # MQA at D = 256 with S > window, a window that is not a multiple of
    # the block, ragged S: rows whose first visited block lies wholly
    # outside their window
    (1, 300, 2, 1, 256, 256, True, 100, 128, 128),
    # HuBERT's head dim, encoder mask; MLA's (D 192, Dv 128), causal; the
    # reduced MLA's (D 16, Dv 8)
    (1, 96, 2, 2, 80, 80, False, None, 32, 32),
    (1, 96, 2, 2, 192, 128, True, None, 32, 32),
    (1, 96, 4, 4, 16, 8, True, None, 32, 32),
]


def _inputs(case, dtype, seed):
    b, s, h, hkv, d, dv = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, dv)).astype(np.float32)
    # both sides get the same values, rounded to the working dtype once
    return [torch.from_numpy(x).to(TORCH_DT[dtype]) for x in (q, k, v)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference(case, dtype):
    causal, window, bq, bk = case[6:]
    tq, tk, tv = _inputs(case, dtype, seed=sum(case[:6]))
    ops.reset_path_counts()
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              block_q=bq, block_k=bk)
    assert ops.PATH_COUNTS == {"ref": 1, "cuda": 0}
    assert got.dtype == TORCH_DT[dtype]
    assert got.shape == (*tq.shape[:3], tv.shape[-1])
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(JAX_DT[dtype])
                  for t in (tq, tk, tv))
    tol = TOL[dtype]
    for backend in ("ref", "interpret"):
        want = jax_flash(jq, jk, jv, causal=causal, window=window,
                         block_q=bq, block_k=bk, backend=backend)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol, err_msg=backend)


def test_plain_matches_dense_softmax():
    """The blocked plain version against one dense masked softmax."""
    tq, tk, tv = _inputs((1, 77, 4, 2, 16, 16), "float32", seed=5)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=20,
                              block_q=16, block_k=16)
    qg = tq.reshape(1, 77, 2, 2, 16)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, tk) / 4.0
    i = torch.arange(77)
    ok = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < 20)
    w = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    want = torch.einsum("bhgqk,bkhd->bqhgd", w, tv).reshape(1, 77, 4, 16)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_kernel_refuses_what_it_does_not_take():
    q = torch.ones(1, 8, 2, 16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.flash_attention(q, q, q, backend="cuda")
    with pytest.raises(ValueError, match="unknown flash_attention backend"):
        ops.flash_attention(q, q, q, backend="pallas")
    assert (16, 16) in kernel.HEAD_DIMS and (256, 256) in kernel.HEAD_DIMS
    assert {(80, 80), (192, 128), (16, 8)} <= kernel.HEAD_DIMS
    assert kernel.LAUNCHES["flash_attention"] == 0


def test_smoke_bf16_rule_tells_rounding_from_a_window_error():
    """``chip_smoke.py`` holds the kernel at the prefill's own bf16 inputs
    by |got - want| <= 2^-7 |want| + 2^-8 mean|want|, because there the
    outputs (mean magnitude about 0.06) are no larger than the absolute
    term of the 4e-2 rule.  At
    inputs of the same statistics (q, k, v ~ N(0, 1), MQA, D 256, window
    2048, S past the window), two summation orders of the plain version
    stay within the rule, and a window one key too wide, which the 4e-2
    rule lets through, does not."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(torch.bfloat16)
               for shape in ((1, 2304, 2, 256), (1, 2304, 1, 256),
                             (1, 2304, 1, 256)))

    def plain(window, block):
        return ops.flash_attention(q, k, v, causal=True, window=window,
                                   block_q=block, block_k=block).float()

    want = plain(2048, 64)
    limit = (smoke.CAPTURED_BF16_ABS_OF_MEAN * float(want.abs().mean())
             + smoke.CAPTURED_BF16_REL * want.abs())
    reordered = (plain(2048, 512) - want).abs()
    assert float(reordered.max()) > 0          # the orders do differ
    assert bool((reordered <= limit).all())
    wide = (plain(2049, 64) - want).abs()
    tol = TOL["bfloat16"]
    assert bool((wide <= tol + tol * want.abs()).all())
    assert not bool((wide <= limit).all())


def _emulate_mma_kernel(q, k, v, window, split):
    """The bf16 tensor-core kernel's rounding in plain PyTorch: bf16 inputs,
    float32 scores scaled after the product, online softmax over kv tiles of
    64 keys with masked pairs at probability exactly 0, the row sum from the
    float32 P, and P·V from P in bf16: split into P_hi = bf16(P) and
    P_lo = bf16(P - P_hi) when ``split``, one bf16 P otherwise.  bf16 x bf16
    products are exact in float32, so only the summation order differs from
    the card.  Causal with a local window, MQA, B = 1."""
    _, s, h, d = q.shape
    qf = q[0].float().transpose(0, 1)                    # [H, S, D]
    kf, vf = k[0, :, 0].float(), v[0, :, 0].float()      # [S, D]
    pos = torch.arange(s)
    m = torch.full((h, s, 1), -2.0e38)
    l = torch.zeros((h, s, 1))
    acc = torch.zeros((h, s, vf.shape[-1]))
    for k0 in range(0, s, 64):
        kpos = pos[k0:k0 + 64]
        delta = pos[:, None] - kpos[None, :]
        valid = (delta >= 0) & (delta < window)
        x = (qf @ kf[k0:k0 + 64].T) * (1.0 / d ** 0.5)
        x = torch.where(valid, x, torch.tensor(-2.0e38))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(x - m_new), torch.tensor(0.0))
        hi = p.bfloat16().float()
        pv = hi @ vf[k0:k0 + 64]
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vf[k0:k0 + 64]
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.transpose(0, 1)[None].bfloat16().float()


def test_mma_kernel_needs_the_split_p_product():
    """Why the bf16 kernel spends a second P·V product: at inputs of the
    prefill's statistics (S 2 304, MQA, D 256, window 2 048), its rounding
    with P split into bf16 hi + lo stays within ``chip_smoke.py``'s rule
    for the prefill's own inputs (one bf16 rounding of the output), and the
    same arithmetic with P in one bf16 does not."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(torch.bfloat16)
               for shape in ((1, 2304, 2, 256), (1, 2304, 1, 256),
                             (1, 2304, 1, 256)))
    want = ops.flash_attention(q, k, v, causal=True, window=2048,
                               block_q=64, block_k=64).float()
    limit = (smoke.CAPTURED_BF16_ABS_OF_MEAN * float(want.abs().mean())
             + smoke.CAPTURED_BF16_REL * want.abs())
    split = (_emulate_mma_kernel(q, k, v, 2048, split=True) - want).abs()
    assert float(split.max()) > 0
    assert float((split / limit).max()) <= 1.0
    single = (_emulate_mma_kernel(q, k, v, 2048, split=False) - want).abs()
    assert float((single / limit).max()) > 1.0


# --- the gradient ---------------------------------------------------------------
def _grads(tq, tk, tv, g, **kw):
    ins = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    ops.flash_attention(*ins, **kw).backward(g)
    return [t.grad for t in ins]


def _assert_grad_close(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale,
                               err_msg=name)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_gradient_matches_reference(case):
    causal, window, bq, bk = case[6:]
    tq, tk, tv = _inputs(case, "float32", seed=sum(case[:6]) + 1)
    rng = np.random.default_rng(sum(case[:6]))
    g = rng.normal(size=(*tq.shape[:3], tv.shape[-1])).astype(np.float32)
    got = _grads(tq, tk, tv, torch.from_numpy(g), causal=causal,
                 window=window, block_q=bq, block_k=bk)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jax_flash(
        q, k, v, causal=causal, window=window, block_q=bq, block_k=bk,
        backend="ref") * g), argnums=(0, 1, 2)))(
        *(jnp.asarray(t.numpy()) for t in (tq, tk, tv)))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == tuple(b.shape)
        _assert_grad_close(a.numpy(), np.asarray(b), name)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("causal,window", [(True, None), (True, 20),
                                           (False, None)])
def test_backward_kernel_formula(causal, window):
    """The backward kernel's arithmetic, densely: lse of each row's scaled
    scores, delta = rowsum(dO o), P = exp(s - lse) in the mask,
    dS = P (dO v - delta), dV = sum P dO over the group's heads, dK = scale
    sum dS q, dQ = scale sum dS k; GQA, ragged S."""
    b, s, h, hkv, d, dv = 2, 77, 4, 2, 16, 8
    tq, tk, tv = _inputs((b, s, h, hkv, d, dv), "float32", seed=9)
    do = torch.from_numpy(np.random.default_rng(1).normal(
        size=(b, s, h, dv)).astype(np.float32))
    want = _grads(tq, tk, tv, do, causal=causal, window=window, block_q=16,
                  block_k=16)
    o = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    g = h // hkv
    scale = 1.0 / d ** 0.5
    kx = tk.repeat_interleave(g, dim=2)                # [b, s, h, d]
    vx = tv.repeat_interleave(g, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", tq, kx) * scale
    i = torch.arange(s)
    ok = torch.ones(s, s, dtype=torch.bool)
    if causal or window is not None:
        ok = i[:, None] >= i[None, :]
        if window is not None:
            ok &= i[:, None] - i[None, :] < window
    lse = torch.logsumexp(sc.masked_fill(~ok, float("-inf")), dim=-1)
    p = torch.where(ok, torch.exp(sc - lse[..., None]), torch.zeros(()))
    delta = torch.einsum("bqhc,bqhc->bhq", do, o)
    dp = torch.einsum("bqhc,bkhc->bhqk", do, vx)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kx) * scale
    dk = (torch.einsum("bhqk,bqhd->bkhd", ds, tq) * scale).reshape(
        b, s, hkv, g, d).sum(3)
    dvv = torch.einsum("bhqk,bqhc->bkhc", p, do).reshape(
        b, s, hkv, g, dv).sum(3)
    for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dvv), want):
        _assert_grad_close(a.numpy(), w.numpy(), name)


def _smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _emulate_bwd_kernel(q, k, v, o, lse, do, causal, window, split,
                        splits=1):
    """The bf16 tensor-core backward's rounding in plain PyTorch, on the
    values it is given: delta = rowsum(dO o) in float32; S = q k^T and
    dP = dO v^T from the operands as they are (bf16 x bf16 products are
    exact in float32, so only the summation order differs from the card);
    P = exp2(S scale log2 e - lse log2 e) in the mask, 0 outside;
    dS = P (dP - delta); P and dS in bf16, split into hi = bf16(x) and
    lo = bf16(x - hi) when ``split``, one bf16 otherwise.  dK/dV: blocks of
    64 keys, each summing the float32 products of 32-row q tiles from its
    band's first row, over the group's heads in ``splits`` partials that
    one more pass adds in order; dQ: blocks of 64 rows summing the products
    of 32-key tiles from their band's first key.  Returns float32 dq, dk, dv
    before the output's rounding."""
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = v.shape[1:]
    group, scale, log2e = H // Hkv, 1.0 / D ** 0.5, 1.4426950408889634
    causal = causal or window is not None
    i, j = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask = i >= j
        if window is not None:
            mask &= i - j < window

    def parts(x):
        hi = x.bfloat16().float()
        return (hi, (x - hi).bfloat16().float()) if split else (hi,)

    dq = torch.zeros(B, Sq, H, D)
    dk = torch.zeros(B, Skv, Hkv, D)
    dv = torch.zeros(B, Skv, Hkv, Dv)
    for b in range(B):
        qf, of, dof = (t[b].float().transpose(0, 1) for t in (q, o, do))
        kf = k[b].float().transpose(0, 1).repeat_interleave(group, 0)
        vf = v[b].float().transpose(0, 1).repeat_interleave(group, 0)
        delta = (dof * of).sum(-1, keepdim=True)
        l2 = (lse[b] * log2e)[..., None]
        p = torch.where(mask, torch.exp2((qf @ kf.transpose(1, 2))
                                         * (scale * log2e) - l2), 0.0)
        ds = p * (dof @ vf.transpose(1, 2) - delta)
        p_parts, ds_parts = parts(p), parts(ds)
        for r0 in range(0, Skv, 64):
            keys = slice(r0, min(r0 + 64, Skv))
            q_begin = r0 if causal else 0
            q_end = min(Sq, r0 + 63 + window) if window else Sq
            for hk in range(Hkv):
                total_k = total_v = 0.0
                for z in range(splits):
                    acc_k = torch.zeros(keys.stop - r0, D)
                    acc_v = torch.zeros(keys.stop - r0, Dv)
                    per = group // splits
                    for h in range(hk * group + z * per,
                                   hk * group + (z + 1) * per):
                        for q0 in range(q_begin, q_end, 32):
                            rows = slice(q0, min(q0 + 32, Sq))
                            for x in p_parts:
                                acc_v += x[h, rows, keys].T @ dof[h, rows]
                            for x in ds_parts:
                                acc_k += x[h, rows, keys].T @ qf[h, rows]
                    total_k, total_v = total_k + acc_k, total_v + acc_v
                dk[b, keys, hk] = total_k * scale
                dv[b, keys, hk] = total_v
        for r0 in range(0, Sq, 64):
            rows = slice(r0, min(r0 + 64, Sq))
            k_begin = max(0, r0 - window + 1) if window else 0
            k_end = min(Skv, rows.stop) if causal else Skv
            for h in range(H):
                acc = torch.zeros(rows.stop - r0, D)
                for k0 in range(k_begin, k_end, 32):
                    cols = slice(k0, min(k0 + 32, Skv))
                    for x in ds_parts:
                        acc += x[h, rows, cols] @ kf[h, cols]
                dq[b, rows, h] = acc * scale
    return dq, dk, dv


def _formula_inputs(tq, tk, tv, do, causal, window):
    """o from the plain forward and the float32 log-sum-exp of each row's
    scaled scores in the mask, as the forward kernel hands them on."""
    o = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    g = tq.shape[2] // tk.shape[2]
    sc = torch.einsum("bqhd,bkhd->bhqk", tq.float(),
                      tk.float().repeat_interleave(g, dim=2))
    sc = sc / tq.shape[-1] ** 0.5
    i = torch.arange(tq.shape[1])
    ok = torch.ones(tq.shape[1], tk.shape[1], dtype=torch.bool)
    if causal or window is not None:
        ok = i[:, None] >= i[None, :]
        if window is not None:
            ok &= i[:, None] - i[None, :] < window
    return o, torch.logsumexp(sc.masked_fill(~ok, float("-inf")), dim=-1)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("causal,window", [(True, None), (True, 20),
                                           (False, None)])
def test_bwd_emulation_matches_formula(causal, window):
    """The emulation of the bf16 backward's split products, before its
    output rounding, against the float32 formula of
    ``test_backward_kernel_formula`` (GQA, ragged S) on the same bf16
    values, written densely (``chip_smoke.dense_flash_bwd``) and through
    the plain version's autograd, by the same rule: the split leaves each
    P and dS within 2^-16 of itself, so only float32 rounding separates
    them."""
    b, s, h, hkv, d, dv = 2, 77, 4, 2, 16, 8
    tq, tk, tv = _inputs((b, s, h, hkv, d, dv), "bfloat16", seed=9)
    do = torch.from_numpy(np.random.default_rng(1).normal(
        size=(b, s, h, dv)).astype(np.float32)).bfloat16()
    tq, tk, tv, do = (t.float() for t in (tq, tk, tv, do))
    o, lse = _formula_inputs(tq, tk, tv, do, causal, window)
    got = _emulate_bwd_kernel(tq, tk, tv, o, lse, do, causal, window,
                              split=True, splits=2)
    formula = _smoke().dense_flash_bwd(torch, tq, tk, tv, o, lse, do,
                                       causal, window)
    autograd = _grads(tq, tk, tv, do, causal=causal, window=window,
                      block_q=16, block_k=16)
    for want in (formula, autograd):
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            _assert_grad_close(a.numpy(), w.numpy(), name)


@pytest.mark.usefixtures("one_torch_thread")
def test_mma_bwd_needs_the_split_products():
    """Why the bf16 backward spends a second product on each of dV, dK and
    dQ: at inputs of the training statistics (S 2 304, MQA 2/1, D 256,
    window 2 048, q/k/v ~ N(0, 1) in bf16, dO at a unit max), its rounding
    with P and dS split into bf16 hi + lo, then rounded to bf16 once, stays
    within ``chip_smoke.py``'s limit (1) against its dense float32 formula
    (2^-8 |dense| + 1e-4 max|dense| per tensor), and the same arithmetic
    with P and dS in one bf16 breaks it in each of dq, dk and dv."""
    smoke = _smoke()
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .bfloat16()
               for shape in ((1, 2304, 2, 256), (1, 2304, 1, 256),
                             (1, 2304, 1, 256)))
    do, _ = smoke.unit_scaled(torch.from_numpy(
        rng.normal(size=(1, 2304, 2, 256)).astype(np.float32)))
    do = do.bfloat16()
    o, lse = _formula_inputs(q, k, v, do, True, 2048)
    dense = smoke.dense_flash_bwd(torch, q, k, v, o, lse, do, True, 2048)
    splits = kernel.head_splits(
        tuple(kernel.band_tiles(2304, 2304, True, 2048, 64, 32)), 1, 2, 132)
    assert splits == 2
    shares = {}
    for split in (True, False):
        got = [t.bfloat16() for t in _emulate_bwd_kernel(
            q, k, v, o, lse, do, True, 2048, split=split, splits=splits)]
        shares[split] = {name: r["share"] for name, r in smoke.shares(
            torch, got, dense, smoke.FORMULA_BWD_REL,
            smoke.FLASH_GRAD_TOL).items()}
    assert all(0 < x <= 1.0 for x in shares[True].values()), shares
    assert all(x > 1.0 for x in shares[False].values()), shares


@pytest.mark.parametrize("s,causal,window,batch_kv,group,slots,want", [
    # recurrentgemma-2b: MQA 10/1, window 2 048, one block an SM; the
    # band's last key blocks are short, so 5 splits balance where 2 leave
    # the SMs of the short blocks idle
    (4096, True, 2048, 1, 10, 132, 5),
    (4096, True, 2048, 1, 1, 132, 1),      # no group to split
    (4096, True, None, 5, 3, 264, 3),      # SmolLM 15/5, two blocks an SM
    (4096, True, None, 128, 1, 132, 1),    # DeepSeek-V2's MLA: many blocks
    (2304, True, 2048, 1, 2, 132, 2),
    # a full mask: every key block alike, so whole waves decide
    (4096, False, None, 1, 10, 132, 2),
    # lm_archs' training shapes, B 1 x S 2 048, causal, where chip_smoke.py
    # times every divisor beside the pick: Granite-20B's MQA 48/1 and
    # Pixtral-12B's GQA 32/8 (D 128, one block an SM), SmolLM-360M's 15/5
    # (D 64, two blocks an SM)
    (2048, True, None, 1, 48, 132, 48),
    (2048, True, None, 8, 4, 132, 4),
    (2048, True, None, 5, 3, 264, 3),
])
def test_head_splits_picks_the_earliest_finish(s, causal, window, batch_kv,
                                               group, slots, want):
    tiles = tuple(kernel.band_tiles(s, s, causal, window, 64, 32))
    assert kernel.head_splits(tiles, batch_kv, group, slots) == want


def test_band_tiles_follow_the_mask():
    assert kernel.band_tiles(4096, 4096, True, 2048, 64, 32)[:2] == [66, 66]
    assert kernel.band_tiles(4096, 4096, True, 2048, 64, 32)[-1] == 2
    assert kernel.band_tiles(100, 100, False, None, 64, 32) == [4, 4]
    assert kernel.band_tiles(100, 100, True, None, 64, 32) == [4, 2]


def test_strides_of_unit_dims_are_zero():
    """A batch of one keeps whatever batch stride PyTorch left it (the
    gradient reaching the backward at the model's B 1 had batch stride 1,
    which ``contiguous()`` keeps); the kernels get 0 there, so their
    16-byte test sees only the strides they use."""
    do = torch.zeros(4096 * 2560).as_strided((1, 4096, 10, 256),
                                             (1, 2560, 256, 1))
    assert do.is_contiguous() and do.contiguous().stride()[0] == 1
    assert kernel._strides(do) == [0, 2560, 256]
    k = torch.zeros(2, 8, 1, 16)
    assert kernel._strides(k) == [128, 16, 0]


def test_bwd_kernel_refuses_cpu_tensors():
    q = torch.ones(1, 8, 2, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel.flash_attention_bwd(q, q, q, q, lse, q)
    assert kernel.LAUNCHES["flash_attention_bwd"] == 0
