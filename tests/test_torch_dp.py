"""The port's int8 error-feedback data-parallel trainer against the JAX
package on the CPU.

``compressed_psum`` at P 4 is bit-equal to the reference's, which runs under
``shard_map`` over 4 host devices in a subprocess (as
``tests/test_two_jobs_and_dp.py`` runs it), on the same gradient tree and
error state, over three chained calls (the residuals fed back).  The
trainer: 12 steps compressed against 12 exact on the reduced
recurrentgemma-2b, both ending below their first step's loss and below the
reference's 5.45 ceiling (set there for reduced olmo, whose loss starts at
ln 256 = 5.55, as this model's does), within 0.1 of each other, the
reference's bound.  Elastic resume: an exact-DP run saved at P 4 and resumed
at P 8 and at P 4 ends within 5e-3, ``tests/test_elastic.py``'s bound.
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from repro.distributed.compression import dequantize_leaf as jax_dequantize
from repro.distributed.compression import quantize_leaf as jax_quantize
from repro_torch.configs.base import get_arch
from repro_torch.distributed.checkpoint import save_checkpoint
from repro_torch.distributed.compression import (compressed_psum,
                                                 dequantize_leaf,
                                                 init_error_state,
                                                 quantize_leaf)
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.train.dp_trainer import init_error, make_compressed_dp_step
from repro_torch.train.loop import data_stream, restore_into
from repro_torch.train.step import init_train_state

CFG = get_arch("recurrentgemma_2b").reduced()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


pytestmark = pytest.mark.usefixtures("one_torch_thread")

PSUM_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import warnings; warnings.filterwarnings("ignore")
    import numpy as np, jax, jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.distributed.compression import compressed_psum

    data = np.load(sys.argv[1])
    grads = {k[2:]: jnp.asarray(data[k]) for k in data if k[:2] == "g/"}
    grads["bf16"] = grads["bf16"].astype(jnp.bfloat16)
    err = {k[2:]: jnp.asarray(data[k]) for k in data if k[:2] == "e/"}
    mesh = Mesh(np.array(jax.devices()), ("data",))

    def local(g, e):
        g = jax.tree.map(lambda x: x[0], g)
        e = jax.tree.map(lambda x: x[0], e)
        mean, new_e = compressed_psum(g, e, "data")
        return (jax.tree.map(lambda x: x[None], mean),
                jax.tree.map(lambda x: x[None], new_e))

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data")),
                           check_rep=False))
    out = {}
    for call in range(3):
        mean, err = fn(grads, err)
        out.update({f"{call}/m/{k}": np.asarray(v) for k, v in mean.items()})
        out.update({f"{call}/e/{k}": np.asarray(v) for k, v in err.items()})
    np.savez(sys.argv[2], **out)
""")


def _tree(rng, p=4):
    return {"w": rng.normal(size=(p, 33, 17)).astype(np.float32),
            "tiny": (rng.normal(size=(p, 5)) * 1e-6).astype(np.float32),
            "zero": np.zeros((p, 3, 3), np.float32),
            "bf16": rng.normal(size=(p, 64)).astype(np.float32),
            # exact halves of the int8 step: round half to even decides
            "halves": (np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 127.0]] * p,
                                np.float32) * np.float32(1 / 127.0))}


def test_compressed_psum_bit_equal_to_reference_on_4_workers(tmp_path):
    rng = np.random.default_rng(11)
    grads = _tree(rng)
    err = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
           for k, v in grads.items()}
    inputs = tmp_path / "in.npz"
    np.savez(inputs, **{f"g/{k}": v for k, v in grads.items()},
             **{f"e/{k}": v for k, v in err.items()})
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", PSUM_SCRIPT, str(inputs),
                           str(tmp_path / "out.npz")], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = np.load(tmp_path / "out.npz")
    g = {k: torch.from_numpy(v) for k, v in grads.items()}
    g["bf16"] = g["bf16"].bfloat16()
    e = {k: torch.from_numpy(v) for k, v in err.items()}
    for call in range(3):
        mean, e = compressed_psum(g, e)
        for k in grads:
            got_m = mean[k].numpy()
            got_e = e[k].numpy()
            assert got_m.dtype == got_e.dtype == np.float32
            assert got_m.shape == grads[k].shape[1:]
            assert got_e.shape == grads[k].shape
            np.testing.assert_array_equal(
                got_m.view(np.uint32), want[f"{call}/m/{k}"][0].view(
                    np.uint32), err_msg=f"mean {k}, call {call}")
            np.testing.assert_array_equal(
                got_e.view(np.uint32), want[f"{call}/e/{k}"].view(np.uint32),
                err_msg=f"residual {k}, call {call}")


def test_quantize_leaf_matches_reference():
    rng = np.random.default_rng(2)
    for x in (rng.normal(size=(40, 9)).astype(np.float32),
              np.zeros(7, np.float32),
              np.array([0.5, 1.5, -2.5, 127.0], np.float32)):
        q, scale = quantize_leaf(torch.from_numpy(x))
        jq, jscale = jax_quantize(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(scale) == float(jscale)
        np.testing.assert_array_equal(
            dequantize_leaf(q, scale).numpy(),
            np.asarray(jax_dequantize(jq, jscale)))
    err = init_error_state({"a": torch.ones(4, 2, dtype=torch.bfloat16)})
    assert err["a"].dtype == torch.float32 and not err["a"].any()


def _dp_run(compress, steps, p=4, batch=4, seq=32):
    mesh = make_worker_mesh(p, "cpu")
    params, opt = init_train_state(CFG, "cpu", seed=0)
    err = init_error(params, mesh)
    assert all(e.shape == (p, *q.shape)
               for e, (_, q) in zip(err.values(), params.named_parameters()))
    step = make_compressed_dp_step(CFG, mesh, compress=compress)
    stream = data_stream(CFG, batch, seq, seed=0, device="cpu")
    losses = []
    for _ in range(steps):
        params, opt, err, metrics = step(params, opt, err, next(stream))
        assert set(metrics) == {"loss", "aux", "total", "grad_norm"}
        losses.append(float(metrics["loss"]))
    return losses, err


def test_compressed_dp_training_tracks_exact_on_4_workers():
    compressed, err = _dp_run(True, 12)
    exact, err_exact = _dp_run(False, 12)
    assert compressed[-1] < compressed[0] and exact[-1] < exact[0]
    assert compressed[-1] < 5.45 and exact[-1] < 5.45, (compressed, exact)
    assert abs(compressed[-1] - exact[-1]) < 0.1, (compressed, exact)
    assert any(bool(e.any()) for e in err.values())       # residuals kept
    assert not any(bool(e.any()) for e in err_exact.values())


def test_dp_step_refuses_a_batch_that_does_not_split():
    mesh = make_worker_mesh(3, "cpu")
    params, opt = init_train_state(CFG, "cpu")
    step = make_compressed_dp_step(CFG, mesh)
    batch = next(data_stream(CFG, 4, 8, device="cpu"))
    with pytest.raises(ValueError, match="does not split into 3"):
        step(params, opt, init_error(params, mesh), batch)


def _elastic(p, ckpt, phase):
    """Exact DP on ``p`` workers: 6 steps then a checkpoint ("start"), or
    restore and steps 6..11 ("resume"); returns the last loss."""
    mesh = make_worker_mesh(p, "cpu")
    params, opt = init_train_state(CFG, "cpu", seed=0)
    start = restore_into(ckpt, params, opt) if phase == "resume" else 0
    step = make_compressed_dp_step(CFG, mesh, compress=False)
    stream = data_stream(CFG, 8, 32, seed=0, device="cpu")
    for _ in range(start):
        next(stream)
    err = init_error(params, mesh)
    loss = None
    for _ in range(start, 6 if phase == "start" else 12):
        params, opt, err, metrics = step(params, opt, err, next(stream))
        loss = float(metrics["loss"])
    if phase == "start":
        save_checkpoint(ckpt, 6, {"params": dict(params.named_parameters()),
                                  "opt": opt})
    return loss


def test_elastic_restart_4_to_8_workers(tmp_path):
    ckpt = str(tmp_path / "ck")
    _elastic(4, ckpt, "start")
    r8 = _elastic(8, ckpt, "resume")
    r4 = _elastic(4, ckpt, "resume")
    assert r8 < 5.5 and r4 < 5.5
    # same data, same state => same trajectory whatever the worker count
    assert abs(r8 - r4) < 5e-3, (r8, r4)
