"""The port's training path against the JAX package on the CPU: the reduced
recurrentgemma-2b (rglru, rglru, local; d 64; window 16; float32; remat
"none"), its parameters from the reference's ``init_params`` through
``params_from_reference``, its batches from the reference's ``data_stream``.

Tolerances, all float32 on both sides, which differ only in summation order
(the port's plain lru loop against the reference's associative scan, blocked
attention's block order, the loss's reductions):
  - ``loss_fn`` within ``tests/test_torch_models.py``'s TOL, 1e-4;
  - every gradient leaf within 2e-5 of that leaf's max |g| (measured: at
    most 2.4e-6 at S 64 and at S 1 040);
  - one ``adamw_update`` (same gradients, parameters and state): m, v within
    1e-6 relative plus 1e-6 of the leaf's max (XLA fuses the update into
    other roundings near 0), parameters within 1e-6 absolute (a step moves them by about
    lr = 3e-4), grad_norm within 1e-6 relative, count equal;
  - an 8-step trajectory (and a JAX run continued in the port from its
    state at step 4): every loss within 1e-4 and grad_norm within 1e-4
    relative.
The remat modes, and a loop resumed after an injected failure, are held bit
for bit: same arithmetic in the same order on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from repro.configs.base import get_arch as jax_get_arch
from repro.models import model as JM
from repro.train.loop import data_stream as jax_data_stream
from repro.train.optimizer import adamw_update as jax_adamw_update
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs.base import get_arch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import model as M
from repro_torch.models.convert import (named_from_reference,
                                        opt_state_from_reference,
                                        params_from_reference)
from repro_torch.train.loop import LoopConfig, data_stream, train
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)
from repro_torch.train.step import make_train_step

LOSS_TOL = 1e-4
GRAD_TOL = 2e-5          # of each leaf's max |g|
JCFG = jax_get_arch("recurrentgemma_2b").reduced()
CFG = get_arch("recurrentgemma_2b").reduced()


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def reference():
    jp = JM.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _port_params(np_params):
    return params_from_reference(np_params, CFG, "cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in
            batch.items()}


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def test_config_remat_matches_the_reference():
    assert get_arch("recurrentgemma-2b").remat == "full"
    assert jax_get_arch("recurrentgemma-2b").remat == "full"
    assert CFG.remat == JCFG.remat == "none"


@pytest.mark.parametrize("b,s", [(4, 64), (1, 1040)],
                         ids=["local_attention", "flash_past_the_window"])
def test_loss_and_every_gradient_match_reference(reference, b, s):
    """S 1 040 is past FLASH_MIN_SEQ (1 024) and the reduced window (16):
    both sides go through their blocked flash attention."""
    jp, np_params = reference
    batch = next(jax_data_stream(JCFG, b, s))
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: JM.loss_fn(p, bt, JCFG), has_aux=True))(jp, batch)
    params = _port_params(np_params).requires_grad_(True)
    flash_ops.reset_path_counts()
    total, metrics = M.loss_fn(params, _torch_batch(batch), CFG)
    total.backward()
    assert flash_ops.PATH_COUNTS["ref"] == (1 if s >= 1024 else 0)
    assert abs(float(metrics["loss"].detach()) - float(jmetrics["loss"])) \
        < LOSS_TOL
    assert abs(float(total.detach()) - float(jtotal)) < LOSS_TOL
    assert float(metrics["aux"]) == float(jmetrics["aux"]) == 0.0
    want = named_from_reference(_numpy(jgrads), CFG, params)
    names = [n for n, _ in params.named_parameters()]
    assert sorted(names) == sorted(want) and len(names) == 41
    for name, p in params.named_parameters():
        scale = float(np.abs(want[name]).max())
        err = float(np.abs(p.grad.numpy() - want[name]).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


def test_masked_labels_are_left_out_of_the_loss(reference):
    jp, np_params = reference
    batch = next(jax_data_stream(JCFG, 2, 40))
    labels = np.asarray(batch["labels"]).copy()
    labels[0, 5:20] = -1
    labels[1, :] = -1
    batch = dict(batch, labels=jnp.asarray(labels))
    want, _ = JM.loss_fn(jp, batch, JCFG)
    got, metrics = M.loss_fn(_port_params(np_params), _torch_batch(batch),
                             CFG)
    assert abs(float(got) - float(want)) < LOSS_TOL
    assert float(metrics["loss"]) > 0


def test_remat_modes_give_bit_equal_gradients():
    """full (each repetition of the unit checkpointed), dots (only the 2-D
    matrix products' outputs kept) and none, on five layers (a unit of four
    and a suffix layer) at S 1 040 (flash and the scan)."""
    base = dataclasses.replace(CFG, n_layers=5)
    layout = M.decompose(base.blocks())
    assert layout.reps == 1 and len(layout.unit) == 4 and layout.suffix
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, CFG.vocab_size, (1, 1040)))
    results = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        params = M.init_params(cfg, "cpu", seed=1).requires_grad_(True)
        total, _ = M.loss_fn(params, {"tokens": tok, "labels": tok}, cfg)
        total.backward()
        results[remat] = (total.detach(), {n: p.grad for n, p in
                                           params.named_parameters()})
    for remat in ("full", "dots"):
        assert torch.equal(results[remat][0], results["none"][0])
        for name, g in results["none"][1].items():
            assert torch.equal(results[remat][1][name], g), (remat, name)
    with pytest.raises(ValueError, match="remat must be"):
        M.loss_fn(M.init_params(dataclasses.replace(base, remat="some"),
                                "cpu").requires_grad_(True),
                  {"tokens": tok, "labels": tok},
                  dataclasses.replace(base, remat="some"))


def test_adamw_update_matches_reference(reference):
    jp, np_params = reference
    batch = next(jax_data_stream(JCFG, 2, 32))
    jgrads = jax.jit(jax.grad(lambda p: JM.loss_fn(p, batch, JCFG)[0]))(jp)
    # a state some steps in, so bias correction and the moments matter
    rng = np.random.default_rng(3)
    jopt = jax_init_opt_state(jp)
    jopt = {"m": jax.tree.map(lambda z: jnp.asarray(
                rng.normal(scale=1e-2, size=z.shape), jnp.float32),
                jopt["m"]),
            "v": jax.tree.map(lambda z: jnp.asarray(
                rng.uniform(0, 1e-4, size=z.shape), jnp.float32),
                jopt["v"]),
            "count": jnp.asarray(4, jnp.int32)}
    from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
    jnew, jstate, jnorm = jax.jit(
        lambda g, o, p: jax_adamw_update(g, o, p, JaxAdamWConfig()))(
            jgrads, jopt, jp)
    params = _port_params(np_params)
    grads = {n: torch.from_numpy(a) for n, a in
             named_from_reference(_numpy(jgrads), CFG, params).items()}
    state = opt_state_from_reference(_numpy(jopt), CFG, params)
    tree = dict(params.named_parameters())
    _, state, gnorm = adamw_update(grads, state, tree, AdamWConfig())
    assert abs(float(gnorm) - float(jnorm)) <= 1e-6 * float(jnorm)
    assert float(jnorm) > 1.0          # the clip is active
    assert state["count"].dtype == torch.int32
    assert int(state["count"]) == int(jstate["count"]) == 5
    want_p = named_from_reference(_numpy(jnew), CFG, params)
    for moment in ("m", "v"):
        want = named_from_reference(_numpy(jstate[moment]), CFG, params)
        for name, t in state[moment].items():
            assert t.dtype == torch.float32
            np.testing.assert_allclose(
                t.numpy(), want[name], rtol=1e-6,
                atol=1e-6 * float(np.abs(want[name]).max()), err_msg=name)
    for name, p in tree.items():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name],
                                   rtol=0, atol=1e-6, err_msg=name)


def test_init_opt_state_shapes():
    params = M.init_params(CFG, "cpu")
    state = init_opt_state(dict(params.named_parameters()))
    assert set(state) == {"m", "v", "count"}
    assert state["count"].dtype == torch.int32 and int(state["count"]) == 0
    for name, p in params.named_parameters():
        assert state["m"][name].shape == p.shape
        assert state["v"][name].dtype == torch.float32


def test_trajectory_and_a_continued_run_match_reference(reference):
    """8 steps on the same batches from the same parameters; then the JAX
    run's state after 4 steps, carried into the port
    (``opt_state_from_reference``), continued there for the last 4."""
    jp, np_params = reference
    jstep = jax.jit(jax_make_train_step(JCFG))
    batches = [b for b, _ in zip(jax_data_stream(JCFG, 4, 64), range(8))]
    jparams, jopt = jp, jax_init_opt_state(jp)
    want, snapshot = [], None
    for i, batch in enumerate(batches):
        if i == 4:
            snapshot = (_numpy(jparams), _numpy(jopt))
        jparams, jopt, jm = jstep(jparams, jopt, batch)
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
    step = make_train_step(CFG)

    def run(params, state, from_step):
        got = []
        for batch in batches[from_step:]:
            params, state, m = step(params, state, _torch_batch(batch))
            assert set(m) == {"loss", "aux", "total", "grad_norm"}
            got.append((float(m["loss"]), float(m["grad_norm"])))
        return got

    params = _port_params(np_params)
    full = run(params, init_opt_state(dict(params.named_parameters())), 0)
    params = _port_params(snapshot[0])
    continued = run(params, opt_state_from_reference(snapshot[1], CFG,
                                                     params), 4)
    for got, ref in ((full, want), (continued, want[4:])):
        for (loss, gn), (jloss, jgn) in zip(got, ref):
            assert abs(loss - jloss) < LOSS_TOL, (got, ref)
            assert abs(gn - jgn) <= 1e-4 * jgn, (got, ref)
    assert full[-1][0] < full[0][0]


def test_data_stream_is_the_reference_stream():
    """Cyclic rows over 1..min(V - 1, 97) with a random phase: the same
    function as the reference's, other random phases."""
    got = next(data_stream(CFG, 3, 200, seed=0, device="cpu"))
    want = np.asarray(next(jax_data_stream(JCFG, 3, 200))["tokens"])
    period = min(CFG.vocab_size - 1, 97)
    for rows in (got["tokens"].numpy(), want):
        assert rows.min() >= 1 and rows.max() <= period
        assert np.all(np.diff(rows, axis=1) % period == 1)
    assert torch.equal(got["tokens"], got["labels"])
    again = next(data_stream(CFG, 3, 200, seed=0, device="cpu"))
    assert torch.equal(got["tokens"], again["tokens"])


def test_loop_resumes_after_an_injected_failure_bit_equal(tmp_path):
    loop = dict(steps=8, ckpt_every=2, log_every=0)
    whole = train(CFG, LoopConfig(**loop), batch=2, seq=32, device="cpu")
    ckpt = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        train(CFG, LoopConfig(ckpt_dir=ckpt, fail_at_step=5, **loop),
              batch=2, seq=32, device="cpu")
    resumed = train(CFG, LoopConfig(ckpt_dir=ckpt, **loop), batch=2, seq=32,
                    device="cpu")
    # saved at step 4, resumed there: steps 4..7 again, bit for bit
    assert resumed["losses"] == whole["losses"][4:]
    for (name, p), (_, q) in zip(whole["params"].named_parameters(),
                                 resumed["params"].named_parameters()):
        assert torch.equal(p, q), name
    assert int(resumed["opt_state"]["count"]) == 8
    assert whole["losses"][-1] < whole["losses"][0]


def test_train_launcher_on_cpu(capsys):
    from repro_torch.launch import train as launcher
    out = launcher.main(["--arch", "recurrentgemma-2b", "--steps", "12",
                         "--device", "cpu"])
    assert len(out["losses"]) == 12
    assert out["losses"][-1] < out["losses"][0]
    assert "final_loss=" in capsys.readouterr().out
