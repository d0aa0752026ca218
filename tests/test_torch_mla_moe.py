"""The MLA and MoE families of the port against the JAX package on the
CPU, at ``reduced()`` in float32: DeepSeek-V2 (MLA with the absorbed
decode, a dense first layer, then MoE with a shared expert) and
DeepSeekMoE-16B (attention, a dense first layer, then MoE).  Each:
forward's logits and aux, ``loss_fn`` and every gradient leaf at S 32 and
at S 1 024 (the plain flash path, MLA's with Dv = 8 != D = 16), and
decode step by step at ``capacity_factor`` 16, as the reference's own
decode test runs it (no drops in the forward).  Tolerances are stated in
``tests/_torch_arch_check.py``.

The MoE layer alone: the kept assignments and their slots equal the
reference's bit for bit at ``capacity_factor`` 1.25, where assignments are
dropped; ``moe_shardmap`` over a 1 x 1 and a 2 x 4 virtual grid equals the
single-program path within the reference's own limits
(``tests/test_perf_paths.py``: 2e-5 at 1 x 1, 2e-4 at 2 x 4; aux 1e-5
relative and 1e-4); two calls give the same bits.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_arch_check import (check_decode, check_forward,
                               check_loss_and_grads, pair)
from _torch_fixtures import one_torch_thread  # noqa: F401
from repro.models import moe as jax_moe
from repro_torch.distributed.perf_options import perf_options, virtual_grid
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import moe

ARCHS = ["deepseek_v2_236b", "deepseek_moe_16b"]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    pr = pair(arch)
    _, aux = check_forward(pr, 2, 32)
    assert float(aux) > 0.0
    check_loss_and_grads(pr, 2, 32)


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_path_matches_reference(arch):
    pr = pair(arch)
    check_forward(pr, 1, 1024)
    assert flash_ops.PATH_COUNTS["ref"] == pr.cfg.n_layers
    check_loss_and_grads(pr, 1, 1024)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    check_decode(pair(arch, capacity_factor=16.0), 20)


def _tree(module):
    """A module's parameters as the reference's tree (same names)."""
    out = {n: _tree(c) for n, c in module.named_children()}
    out.update({n: jnp.asarray(p.detach().numpy())
                for n, p in module.named_parameters(recurse=False)})
    return out


def _moe_layer(pr):
    """The first MoE layer: (port module, the reference's tree of it)."""
    li = [i for i, (_, f) in enumerate(pr.cfg.blocks()) if f == "moe"][0]
    layer = pr.params.blocks[li].ffn
    return layer, _tree(layer)


def _reference_slots(x, p, cfg):
    """The reference's routing and capacity dispatch (``apply_moe``'s own
    lines, ``src/repro/models/moe.py``), up to the slots."""
    t = x.shape[0] * x.shape[1]
    e, k = cfg.n_experts, cfg.moe_top_k
    xt = x.reshape(t, -1)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    cap = int(math.ceil(t * k / e * cfg.capacity_factor))
    flat_e = gate_idx.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    start = jnp.searchsorted(sorted_e, sorted_e, side="left")
    rank = jnp.zeros((t * k,), jnp.int32).at[order].set(
        (jnp.arange(t * k) - start).astype(jnp.int32))
    keep = rank < cap
    return (np.asarray(gate_idx), np.asarray(keep),
            np.asarray(jnp.where(keep, rank, cap)))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_kept_assignments_bit_equal(arch):
    pr = pair(arch)
    layer, tree = _moe_layer(pr)
    # tokens that share a common direction crowd the same experts, past
    # their capacity
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(4, 64, pr.cfg.d_model))
         + 2.0 * rng.normal(size=pr.cfg.d_model)).astype(np.float32)
    gate_idx, keep, pos = _reference_slots(jnp.asarray(x), tree, pr.jcfg)
    assert not keep.all(), "no assignment dropped: the test shows nothing"
    xt = torch.from_numpy(x).reshape(-1, pr.cfg.d_model)
    _, _, idx = moe.route(xt, layer.router, pr.cfg.moe_top_k)
    cap = int(math.ceil(xt.shape[0] * pr.cfg.moe_top_k / pr.cfg.n_experts
                        * pr.cfg.capacity_factor))
    _, got_keep, got_pos = moe.slots(idx.reshape(-1), cap)
    np.testing.assert_array_equal(idx.numpy(), gate_idx)
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    np.testing.assert_array_equal(got_pos.numpy(), pos)
    # and the layer's output with those drops, against the reference's
    with torch.no_grad():
        y, aux = moe.apply_moe(torch.from_numpy(x), layer, pr.cfg)
    want, want_aux = jax_moe.apply_moe(jnp.asarray(x), tree, pr.jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_topk_ties_go_to_the_lowest_expert():
    """Equal router probabilities: the lowest ids win, as
    ``jax.lax.top_k`` orders them."""
    xt = torch.zeros((3, 8))
    router = torch.zeros((8, 6))
    _, gates, idx = moe.route(xt, router, 4)
    assert idx.tolist() == [[0, 1, 2, 3]] * 3
    torch.testing.assert_close(gates, torch.full((3, 4), 0.25))


@pytest.mark.parametrize("grid,batch,limit", [((1, 1), 2, 2e-5),
                                               ((2, 4), 4, 2e-4)])
def test_moe_shardmap_matches_single_program(grid, batch, limit):
    """The reference's test_moe_shardmap cases: drop-free capacity 16, the
    expert-parallel path over the virtual grid against the single-program
    path; at 2 x 4 each model rank holds 8 / 4 = 2 experts."""
    pr = pair("deepseek_moe_16b", capacity_factor=16.0)
    layer, _ = _moe_layer(pr)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(batch, 16, pr.cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y_ref, aux_ref = moe.apply_moe(x, layer, pr.cfg)
        with perf_options("moe_shardmap"):
            y_alone, _ = moe.apply_moe(x, layer, pr.cfg)   # no grid: single
            with virtual_grid(*grid):
                y_sm, aux_sm = moe.apply_moe(x, layer, pr.cfg)
                y_again, _ = moe.apply_moe(x, layer, pr.cfg)
    assert torch.equal(y_alone, y_ref)
    assert torch.equal(y_sm, y_again)
    assert float((y_sm - y_ref).abs().max()) < limit
    np.testing.assert_allclose(float(aux_sm), float(aux_ref), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "hubert-xlarge",
                                  "pixtral-12b", "rwkv6-1.6b"])
def test_train_launcher_takes_every_family(arch):
    """``launch/train.py`` at reduced() on the CPU for MLA + MoE and the
    families the stream feeds differently (frames, patches) or that have
    no attention: finite losses; the trained model's aux > 0 exactly with
    MoE layers."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import train as launcher
    from repro_torch.models import model as M
    out = launcher.main(["--arch", arch, "--steps", "3", "--batch", "2",
                         "--seq", "32", "--device", "cpu"])
    assert len(out["losses"]) == 3
    assert all(math.isfinite(x) for x in out["losses"])
    cfg = get_arch(arch).reduced()
    batch = M.make_dummy_batch(cfg, 2, 32, torch.Generator(), "cpu")
    with torch.no_grad():
        _, aux = M.forward(out["params"], batch, cfg)
    assert (float(aux) > 0) == bool(cfg.n_experts)
