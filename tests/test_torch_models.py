"""The port's recurrentgemma-2b serving path against the JAX package on the
CPU: reduced configuration (3 layers rglru, rglru, local; d 64; window 16;
float32), the reference's ``init_params`` carried across by
``params_from_reference``, the same numpy-seeded tokens on both sides.

Tolerances: port vs reference 1e-4 absolute on logits of magnitude < 1 —
both sides compute in float32 and differ only in summation order; decode vs
forward 5e-3, the reference's own (``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import model as JM
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch.configs.base import ARCH_IDS, get_arch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_reference
from repro_torch.train.step import make_serve_step

TOL = 1e-4
DECODE_TOL = 5e-3
JCFG = jax_get_arch("recurrentgemma_2b").reduced()
CFG = get_arch("recurrentgemma_2b").reduced()


@pytest.fixture(scope="module")
def params():
    jp = JM.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_reference(jax.tree.map(np.asarray, jp), CFG, "cpu")


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (b, s)).astype(np.int32)


def test_config_matches_the_reference():
    full_j, full_t = jax_get_arch("recurrentgemma-2b"), get_arch(
        "recurrentgemma-2b")
    for cj, ct in ((full_j, full_t), (JCFG, CFG)):
        assert ct.blocks() == cj.blocks()
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab_size", "local_window", "lru_width",
                  "logit_softcap", "activation", "embed_scale"):
            assert getattr(ct, f) == getattr(cj, f), f
    assert (dataclasses.asdict(M.decompose(full_t.blocks()))
            == dataclasses.asdict(JM.decompose(full_j.blocks())))
    assert full_t.param_dtype == torch.bfloat16
    assert CFG.compute_dtype == torch.float32


def test_unported_architectures_name_their_roadmap_item():
    for arch in ARCH_IDS:
        if arch != "recurrentgemma_2b":
            with pytest.raises(NotImplementedError, match="ROADMAP Q9c"):
                get_arch(arch)


@pytest.mark.parametrize("b,s", [(2, 32), (1, 1024)],
                         ids=["local_attention", "flash_and_scan"])
def test_forward_matches_reference(params, b, s):
    jp, tp = params
    tok = _tokens(s, b, s)
    want, _ = JM.forward(jp, {"tokens": jnp.asarray(tok)}, JCFG)
    flash_ops.reset_path_counts()
    lru_ops.reset_path_counts()
    got = M.forward(tp, {"tokens": torch.from_numpy(tok).long()}, CFG)
    assert got.dtype == torch.float32 and got.shape == (b, s, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    # the CPU takes each kernel's plain version: flash only at S >= 1024
    assert flash_ops.PATH_COUNTS["ref"] == (1 if s >= 1024 else 0)
    assert lru_ops.PATH_COUNTS["ref"] == 2


def test_decode_matches_reference_past_the_window(params):
    """S = 40 > 2 x window 16: the local layer's ring buffer is reused."""
    jp, tp = params
    S = 40
    tok = _tokens(1, 1, S)
    jcache = JM.init_cache(JCFG, 1, S)
    cache = M.init_cache(CFG, 1, S, "cpu")
    dec = jax.jit(lambda p, c, t, pos: JM.decode_step(p, c, t, pos, JCFG))
    outs = []
    for t in range(S):
        want, jcache = dec(jp, jcache, jnp.asarray(tok[:, t:t + 1]), t)
        got, cache = M.decode_step(tp, cache, torch.from_numpy(
            tok[:, t:t + 1]).long(), t, CFG)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0, err_msg=f"position {t}")
        outs.append(got[:, 0])
    fwd = M.forward(tp, {"tokens": torch.from_numpy(tok).long()}, CFG)
    err = float((torch.stack(outs, 1) - fwd).abs().max())
    assert err < DECODE_TOL, f"decode/forward mismatch: {err}"


def test_decode_matches_forward_on_the_flash_path(params):
    """Forward at S = 1100 (flash and the scan) against token-by-token
    decode (``_sdpa`` on the ring buffer and the one-step recurrence)."""
    _, tp = params
    S = 1100
    tok = torch.from_numpy(_tokens(2, 1, S)).long()
    fwd = M.forward(tp, {"tokens": tok}, CFG)
    cache = M.init_cache(CFG, 1, S, "cpu")
    err = 0.0
    for t in range(S):
        got, cache = M.decode_step(tp, cache, tok[:, t:t + 1], t, CFG)
        err = max(err, float((got[:, 0] - fwd[:, t]).abs().max()))
    assert err < DECODE_TOL, f"decode/forward mismatch: {err}"


def test_serve_step_tokens_match_reference(params):
    jp, tp = params
    B, P, G = 2, 8, 8
    prompts = _tokens(3, B, P)
    jstep = jax.jit(jax_make_serve_step(JCFG))
    step = make_serve_step(CFG)
    jcache = JM.init_cache(JCFG, B, P + G)
    cache = M.init_cache(CFG, B, P + G, "cpu")
    for t in range(P):
        jtok, jcache = jstep(jp, jcache, jnp.asarray(prompts[:, t:t + 1]), t)
        tok, cache = step(tp, cache, torch.from_numpy(
            prompts[:, t:t + 1]).long(), t)
    jgen, gen = [jtok], [tok]
    for t in range(P, P + G - 1):
        jtok, jcache = jstep(jp, jcache, jtok[:, None], t)
        tok, cache = step(tp, cache, tok[:, None], t)
        jgen.append(jtok)
        gen.append(tok)
    assert tok.dtype == torch.int64
    np.testing.assert_array_equal(torch.stack(gen, 1).numpy(),
                                  np.stack([np.asarray(x) for x in jgen], 1))


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "recurrentgemma-2b", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "4", "--gen-len", "5"])
    assert out.shape == (2, 5)
    assert "tok/s on cpu" in capsys.readouterr().out
