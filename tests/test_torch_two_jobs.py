"""The port's split two-job path (``run_cn_plan_two_jobs``: MR¹, an
optional checkpoint, MR²) against the fused path and the JAX package's
two-job path, and the port's checkpoint module (``repro_torch.distributed.
checkpoint``) against the JAX package's layout: the job-1 artifact's
``arrays.npz`` key for key and bit for bit, the manifest, ``keep=3``
pruning, ``latest_step``, the bf16 round trip and placement on restore."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import candidate_network as jax_cn
from repro.core.fct import run_cn_plan_two_jobs as jax_two_jobs
from repro.core.plan import build_cn_plan as jax_build_cn_plan
from repro.data.tpch import TpchConfig, generate, plant_keywords
from repro.distributed import checkpoint as jax_ckpt
from repro.launch.mesh import make_worker_mesh as jax_mesh
from repro.runtime.cache import ExecutableCache as JaxCache
from repro_torch.core import candidate_network as pt_cn
from repro_torch.core.fct import run_cn_plan, run_cn_plan_two_jobs
from repro_torch.core.plan import build_cn_plan
from repro_torch.data.schema import schema_from_reference
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.runtime.cache import ExecutableCache
from test_engine import _crafted_schema
from test_torch_engine import POLICIES, policy  # noqa: F401 (fixture)


def _three_dim_plans(P):
    """``tests/test_two_jobs_and_dp.py``'s plan: the largest three-dimension
    CN, as the reference plans it at P = 1 and the port at ``P``."""
    cfg = TpchConfig(fact_rows=400, part_rows=40, supp_rows=24, order_rows=32,
                     text_len=6, vocab_size=128, seed=5)
    sj = plant_keywords(generate(cfg), {"PART": [100], "SUPPLIER": [101],
                                        "ORDERS": [102]}, frac=0.35)
    return _largest_pair(sj, [100, 101, 102], 4, 3, P)


def _largest_pair(sj, kws, r_max, n_included, P):
    sp = schema_from_reference(sj)
    tj, tp = jax_cn.TupleSets.build(sj, kws), pt_cn.TupleSets.build(sp, kws)
    pairs = zip(jax_cn.prune_empty_cns(
                    jax_cn.enumerate_star_cns(len(kws), sj.m, r_max), tj),
                pt_cn.prune_empty_cns(
                    pt_cn.enumerate_star_cns(len(kws), sp.m, r_max), tp))
    cj, cp = max(((a, b) for a, b in pairs
                  if a.single_dim < 0 and len(a.included) == n_included),
                 key=lambda ab: len(tj.cn_rows(ab[0])[0]))
    return (jax_build_cn_plan(sj, tj, cj, 1),
            build_cn_plan(sp, tp, cp, P))


@pytest.mark.parametrize("policy", list(POLICIES), indirect=True)
@pytest.mark.parametrize("P", [1, 8])
def test_two_job_split_matches_fused(tmp_path, P, policy):
    jplan, plan = _three_dim_plans(P)
    mesh = make_worker_mesh(P, "cpu")
    fused = run_cn_plan(plan, mesh, accum=policy)
    cache = ExecutableCache()
    split = run_cn_plan_two_jobs(plan, mesh, cache=cache, accum=policy)
    np.testing.assert_array_equal(split, fused)
    np.testing.assert_array_equal(
        split, jax_two_jobs(jplan, jax_mesh(1), cache=JaxCache()))
    # with a host checkpoint at the MR¹->MR² boundary (the paper's DFS
    # spill): the same bits, and the same two programs
    ckpted = run_cn_plan_two_jobs(plan, mesh, checkpoint_dir=str(tmp_path),
                                  cache=cache, accum=policy)
    np.testing.assert_array_equal(ckpted, fused)
    assert len(cache) == 2 and ckpt.latest_step(str(tmp_path)) == 1


@pytest.mark.parametrize("policy", list(POLICIES), indirect=True)
def test_checkpoint_equals_the_reference_array_for_array(tmp_path, policy):
    jplan, plan = _three_dim_plans(1)
    ours, theirs = tmp_path / "port", tmp_path / "reference"
    run_cn_plan_two_jobs(plan, make_worker_mesh(1, "cpu"),
                         checkpoint_dir=str(ours), cache=ExecutableCache(),
                         accum=policy)
    jax_two_jobs(jplan, jax_mesh(1), checkpoint_dir=str(theirs),
                 cache=JaxCache())
    step = "step_00000001"
    with np.load(ours / step / "arrays.npz") as a, \
            np.load(theirs / step / "arrays.npz") as b:
        assert list(a.keys()) == list(b.keys())
        assert {"fact/text", "fact/vol", "dims/2/vol"} <= set(a.keys())
        for k in a.keys():
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["fact/vol"].dtype == np.dtype(
            "int64" if policy.bits == 64 else "int32")
    assert json.loads((ours / step / "manifest.json").read_text()) == \
        json.loads((theirs / step / "manifest.json").read_text())


def test_two_jobs_share_the_program_cache():
    """Two plans of one signature (``test_engine.py``'s crafted schemas):
    two programs, built once; the second run builds nothing."""
    mesh = make_worker_mesh(1, "cpu")
    cache = ExecutableCache()
    p1 = _largest_pair(*_crafted_schema(seed=0), 3, 2, 1)[1]
    p2 = _largest_pair(*_crafted_schema(seed=1), 3, 2, 1)[1]
    f1 = run_cn_plan_two_jobs(p1, mesh, cache=cache)
    traces = cache.traces
    assert traces > 0 and len(cache) == 2        # job 1 + job 2
    f2 = run_cn_plan_two_jobs(p2, mesh, cache=cache)
    assert cache.traces == traces, "second two-job run built programs"
    assert cache.stats()["hits"] == 2
    np.testing.assert_array_equal(f1, run_cn_plan(p1, mesh))
    np.testing.assert_array_equal(f2, run_cn_plan(p2, mesh))


def _tree(rng):
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "layers": [{"a": rng.integers(0, 9, (5,)).astype(np.int32),
                        "b": rng.standard_normal((2,)).astype(np.float32)}
                       for _ in range(2)],
            "step": np.int64(7)}


def test_checkpoint_keeps_the_newest_three(tmp_path):
    tree = _tree(np.random.default_rng(0))
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), tree)
    for step in (1, 5, 10, 20):
        ckpt.save_checkpoint(str(tmp_path), step, tree)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_00000005", "step_00000010", "step_00000020"]
    assert ckpt.latest_step(str(tmp_path)) == 20
    # a staging directory without a manifest is no published step
    (tmp_path / "step_00000099").mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 20
    step, back = ckpt.restore_checkpoint(str(tmp_path), tree, step=10)
    assert step == 10
    np.testing.assert_array_equal(back["layers"][1]["a"],
                                  tree["layers"][1]["a"])
    assert back["step"] == 7 and back["step"].dtype == np.int64


def test_checkpoint_bf16_round_trip_onto_cpu(tmp_path):
    """bf16 leaves widen to float32 in the file and come back as bf16, bit
    for bit, on the template's device; the file equals the reference's for
    the same values."""
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((4, 6)).astype(np.float32)
    tree = {"emb": torch.from_numpy(vals).to(torch.bfloat16),
            "ids": [torch.arange(5, dtype=torch.int32)]}
    ckpt.save_checkpoint(str(tmp_path / "port"), 3, tree)
    jtree = {"emb": jnp.asarray(vals, jnp.bfloat16),
             "ids": [jnp.arange(5, dtype=jnp.int32)]}
    jax_ckpt.save_checkpoint(str(tmp_path / "reference"), 3, jtree)
    with np.load(tmp_path / "port/step_00000003/arrays.npz") as a, \
            np.load(tmp_path / "reference/step_00000003/arrays.npz") as b:
        assert list(a.keys()) == list(b.keys()) == ["emb", "ids/0"]
        assert a["emb"].dtype == np.float32
        for k in a.keys():
            np.testing.assert_array_equal(a[k], b[k])
    assert json.loads(
        (tmp_path / "port/step_00000003/manifest.json").read_text()) == \
        json.loads(
            (tmp_path / "reference/step_00000003/manifest.json").read_text())
    template = {"emb": torch.zeros((4, 6), dtype=torch.bfloat16),
                "ids": [torch.zeros(5, dtype=torch.int32)]}
    step, back = ckpt.restore_checkpoint(str(tmp_path / "port"), template)
    assert step == 3
    assert back["emb"].dtype == torch.bfloat16
    assert back["emb"].device.type == "cpu"
    assert torch.equal(back["emb"], tree["emb"])
    assert torch.equal(back["ids"][0], tree["ids"][0])
