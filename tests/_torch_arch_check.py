"""Checks shared by the architecture tests (not a test module): one reduced
architecture of the port held to the JAX package's on the CPU, float32,
the reference's ``init_params`` carried across by ``params_from_reference``
and the same numpy-seeded batch on both sides.

Tolerances (both sides compute in float32 and differ only in summation
order):
  - logits within 1e-4 absolute (``tests/test_torch_models.py``'s TOL), the
    MoE auxiliary loss within 1e-5 relative plus 1e-7 (the reference counts
    each expert's assignments as a sum of 1/(T k) terms, the port as an
    integer count times 1/(T k));
  - ``loss_fn`` within 1e-4 and every gradient leaf within 2e-5 of that
    leaf's max |g| (``tests/test_torch_train.py``'s rule);
  - decode: each step's logits within 1e-4 of the reference's decode step,
    and the port's decode within 5e-3 of its own forward (the reference's
    ``tests/test_models.py`` limit).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import model as JM
from repro_torch.configs.base import get_arch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import model as M
from repro_torch.models.convert import (named_from_reference,
                                        params_from_reference)

TOL = 1e-4
AUX_RTOL, AUX_ATOL = 1e-5, 1e-7
LOSS_TOL = 1e-4
GRAD_TOL = 2e-5          # of each leaf's max |g|
DECODE_TOL = 5e-3


@dataclasses.dataclass
class Pair:
    """One reduced architecture in both packages, same parameters."""
    jcfg: object
    jparams: dict
    cfg: object
    params: M.LM


@functools.lru_cache(maxsize=None)
def pair(arch: str, **overrides) -> Pair:
    """Built once per test process for each (arch, overrides)."""
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), **overrides)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **overrides)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return Pair(jcfg, jp, cfg, tp)


def batches(cfg, b: int, s: int, seed: int):
    """(port batch, reference batch) of ``s`` positions from one numpy
    generator: tokens and labels int, frames or patches N(0, 1)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "frame":
        arrays = {"frames": rng.normal(size=(b, s, cfg.frontend_dim)),
                  "labels": rng.integers(0, cfg.vocab_size, (b, s))}
    elif cfg.frontend == "patch":
        n_patch = max(1, s // cfg.patch_frac)
        arrays = {"patches": rng.normal(size=(b, n_patch, cfg.frontend_dim)),
                  "tokens": rng.integers(0, cfg.vocab_size, (b, s - n_patch)),
                  "labels": rng.integers(0, cfg.vocab_size, (b, s - n_patch))}
    else:
        arrays = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
                  "labels": rng.integers(0, cfg.vocab_size, (b, s))}
    port, ref = {}, {}
    for k, a in arrays.items():
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
            port[k] = torch.from_numpy(a)
        else:
            a = a.astype(np.int32)
            port[k] = torch.from_numpy(a).long()
        ref[k] = jnp.asarray(a)
    return port, ref


def check_forward(pr: Pair, b: int, s: int, seed: int = 0):
    """Logits and aux against the reference's; returns the port's."""
    batch, jbatch = batches(pr.cfg, b, s, seed)
    want, want_aux = jax.jit(lambda p, x: JM.forward(p, x, pr.jcfg))(
        pr.jparams, jbatch)
    flash_ops.reset_path_counts()
    with torch.no_grad():
        got, aux = M.forward(pr.params, batch, pr.cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=AUX_RTOL,
                               atol=AUX_ATOL)
    return got, aux


def check_loss_and_grads(pr: Pair, b: int, s: int, seed: int = 1):
    """``loss_fn``'s total, loss and aux, and every gradient leaf."""
    batch, jbatch = batches(pr.cfg, b, s, seed)
    (want, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, x: JM.loss_fn(p, x, pr.jcfg), has_aux=True))(
        pr.jparams, jbatch)
    params = pr.params
    params.requires_grad_(True)
    params.zero_grad(set_to_none=True)
    try:
        total, metrics = M.loss_fn(params, batch, pr.cfg)
        total.backward()
        np.testing.assert_allclose(float(total.detach()), float(want),
                                   atol=LOSS_TOL, rtol=0)
        np.testing.assert_allclose(float(metrics["loss"].detach()),
                                   float(jm["loss"]), atol=LOSS_TOL, rtol=0)
        np.testing.assert_allclose(float(metrics["aux"].detach()),
                                   float(jm["aux"]), rtol=AUX_RTOL,
                                   atol=AUX_ATOL)
        wants = named_from_reference(jax.tree.map(np.asarray, jgrads),
                                     pr.cfg, params)
        for name, p in params.named_parameters():
            g = (p.grad if p.grad is not None
                 else torch.zeros_like(p)).numpy()
            w = wants[name]
            assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), name
    finally:
        params.zero_grad(set_to_none=True)
        params.requires_grad_(False)
    return float(total.detach())


def check_decode(pr: Pair, s: int, seed: int = 2):
    """Decode step by step against the reference's decode steps, then
    against the port's own forward.  A ``patch`` architecture prefills its
    patches through ``decode_step(embeds=)`` first."""
    batch, jbatch = batches(pr.cfg, 2, s, seed)
    cfg, jcfg = pr.cfg, pr.jcfg
    cache = M.init_cache(cfg, 2, s, "cpu")
    jcache = JM.init_cache(jcfg, 2, s)
    dec = jax.jit(lambda p, c, t, pos, e: JM.decode_step(p, c, t, pos, jcfg,
                                                         embeds=e))
    steps = []     # (tokens, embeds) per position, both packages
    if cfg.frontend == "patch":
        w = pr.params.frontend_proj.w.to(cfg.compute_dtype)
        emb = batch["patches"].to(cfg.compute_dtype) @ w
        jw = pr.jparams["frontend_proj"]["w"].astype(jcfg.compute_dtype)
        jemb = jbatch["patches"].astype(jcfg.compute_dtype) @ jw
        zeros = torch.zeros((2, 1), dtype=torch.long)
        steps += [((zeros, emb[:, t:t + 1]),
                   (jnp.zeros((2, 1), jnp.int32), jemb[:, t:t + 1]))
                  for t in range(emb.shape[1])]
    tok, jtok = batch["tokens"], jbatch["tokens"]
    steps += [((tok[:, i:i + 1], None), (jtok[:, i:i + 1], None))
              for i in range(tok.shape[1])]
    outs = []
    for pos, ((t, e), (jt, je)) in enumerate(steps):
        want, jcache = dec(pr.jparams, jcache, jt, pos, je)
        got, cache = M.decode_step(pr.params, cache, t, pos, cfg, embeds=e)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0, err_msg=f"position {pos}")
        if e is None:
            outs.append(got[:, 0])
    with torch.no_grad():
        fwd, _ = M.forward(pr.params, batch, cfg)
    err = float((torch.stack(outs, 1) - fwd).abs().max())
    assert err < DECODE_TOL, f"decode/forward mismatch: {err}"
