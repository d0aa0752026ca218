"""The port's configurations (all ten, against the JAX package's) and its
recurrentgemma-2b serving path against the JAX package on the
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

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import cell_is_runnable as jax_cell_is_runnable
from repro.configs.base import get_arch as jax_get_arch
from repro.models import model as JM
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch.configs.base import (ARCH_IDS, SHAPES, cell_is_runnable,
                                      get_arch)
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


JAX_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_matches_the_reference(arch):
    """Every field of the published and the reduced configuration (dtypes
    mapped to torch's), the derived block pattern and its decomposition,
    and which shape cells run, against the JAX package's."""
    full_j, full_t = jax_get_arch(arch), get_arch(arch.replace("_", "-"))
    for cj, ct in ((full_j, full_t), (full_j.reduced(), full_t.reduced())):
        for f in dataclasses.fields(cj):
            want = getattr(cj, f.name)
            want = JAX_DTYPES.get(want, want)
            assert getattr(ct, f.name) == want, f.name
        assert ct.blocks() == cj.blocks()
        assert (dataclasses.asdict(M.decompose(ct.blocks()))
                == dataclasses.asdict(JM.decompose(cj.blocks())))
        assert (ct.sub_quadratic(), ct.has_decode(), ct.dense_ffn_dim()) \
            == (cj.sub_quadratic(), cj.has_decode(), cj.dense_ffn_dim())
        for name, shape in JSHAPES.items():
            assert cell_is_runnable(ct, SHAPES[name]) == \
                jax_cell_is_runnable(cj, shape)
    assert {n: dataclasses.astuple(s) for n, s in SHAPES.items()} \
        == {n: dataclasses.astuple(s) for n, s in JSHAPES.items()}
    assert full_t.param_dtype == torch.bfloat16
    assert full_t.reduced().compute_dtype == torch.float32


@pytest.mark.parametrize("b,s", [(2, 32), (1, 1024)],
                         ids=["local_attention", "flash_and_scan"])
def test_forward_matches_reference(params, b, s):
    jp, tp = params
    tok = _tokens(s, b, s)
    want, _ = JM.forward(jp, {"tokens": jnp.asarray(tok)}, JCFG)
    flash_ops.reset_path_counts()
    lru_ops.reset_path_counts()
    got, aux = M.forward(tp, {"tokens": torch.from_numpy(tok).long()}, CFG)
    assert got.dtype == torch.float32 and got.shape == (b, s, CFG.vocab_size)
    assert aux.dtype == torch.float32 and float(aux) == 0.0   # no MoE layer
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
    fwd, _ = M.forward(tp, {"tokens": torch.from_numpy(tok).long()}, CFG)
    err = float((torch.stack(outs, 1) - fwd).abs().max())
    assert err < DECODE_TOL, f"decode/forward mismatch: {err}"


def test_decode_matches_forward_on_the_flash_path(params):
    """Forward at S = 1100 (flash and the scan) against token-by-token
    decode (``_sdpa`` on the ring buffer and the one-step recurrence)."""
    _, tp = params
    S = 1100
    tok = torch.from_numpy(_tokens(2, 1, S)).long()
    fwd, _ = M.forward(tp, {"tokens": tok}, CFG)
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


def test_serve_launcher_refuses_an_encoder():
    """hubert-xlarge has no decode step: the launcher says so, in the
    reference's words, before it touches a device."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="encoder-only: no decode step"):
        serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])
