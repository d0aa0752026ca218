"""The virtual mesh's named collectives (``repro_torch/launch/mesh.py``:
``all_to_all``, ``psum``, ``psum_scatter``, ``all_gather``): each is bit for
bit the inline tensor operation it replaced, counts itself only inside a
``collective_census``, and every path that runs them — ``run_cn_plan``,
``dispatch_plans`` (summed and per-CN, store and host-stacked) and
``dispatch_topk`` — stays bit-equal to the JAX package at P = 1 and P = 8
under both accumulation policies, with the census the contracts expect."""
import jax
import numpy as np
import pytest
import torch

from repro.core.fct import run_cn_plan as jax_run_cn_plan
from repro.launch.mesh import make_worker_mesh as jax_mesh
from repro.runtime.cache import ExecutableCache as JaxCache
from repro.runtime.engine import FCTEngine as JaxEngine
from repro_torch.core.accum import INT32_CHECKED, INT64_EXACT
from repro_torch.core.fct import run_cn_plan
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import collective_census, make_worker_mesh
from repro_torch.runtime.batch import group_plan_indices
from repro_torch.runtime.cache import ExecutableCache
from repro_torch.runtime.engine import FCTEngine
from repro_torch.runtime.store import RelationStore
from test_engine import _crafted_schema
from test_torch_engine import plan_pairs

POLICIES = {"int32": INT32_CHECKED, "int64": INT64_EXACT}
JAX_CACHE = JaxCache()


@pytest.fixture
def policy(request):
    """The port's policy, with the JAX process's x64 flag set to match."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", request.param == "int64")
    yield POLICIES[request.param]
    jax.config.update("jax_enable_x64", prev)


def _census(**counts):
    out = dict.fromkeys(mesh_mod.COLLECTIVES, 0)
    out.update(counts)
    return out


@pytest.mark.parametrize("P", [1, 3, 8])
def test_each_collective_is_its_inline_operation(P):
    g = torch.Generator().manual_seed(P)
    send = torch.randint(-1, 50, (2, P, P, 4), generator=g, dtype=torch.int32)
    hist = torch.randint(-2 ** 31, 2 ** 31 - 1, (3, 100), generator=g,
                         dtype=torch.int32)
    v = torch.randint(0, 9, (P, 5), generator=g, dtype=torch.int64)
    ids = torch.randint(0, 99, (P, 5), generator=g, dtype=torch.int32)
    with collective_census() as census:
        swapped = mesh_mod.all_to_all(send)
        summed = mesh_mod.psum(hist)
        scattered = mesh_mod.psum_scatter(hist, P)
        all_v, all_ids = mesh_mod.all_gather(v, ids)
    assert census == _census(all_to_all=1, psum=1, psum_scatter=1,
                             all_gather=1)
    assert torch.equal(swapped, send.transpose(1, 2))
    assert summed is hist
    pad = mesh_mod.vocab_padded(100, P) - 100
    assert torch.equal(scattered, torch.nn.functional.pad(hist, (0, pad))
                       if pad else hist)
    assert scattered.dtype == hist.dtype and scattered.shape[-1] % P == 0
    assert torch.equal(all_v, v.reshape(-1))
    assert torch.equal(all_ids, ids.reshape(-1))
    # outside a census nothing is counted, and an inner census leaves the
    # outer one as it was
    mesh_mod.psum(hist)
    with collective_census() as outer:
        with collective_census() as inner:
            mesh_mod.psum(hist)
        mesh_mod.all_gather(v)
    assert (inner["psum"], inner["all_gather"]) == (1, 0)
    assert (outer["psum"], outer["all_gather"]) == (0, 1)


@pytest.mark.parametrize("policy", list(POLICIES), indirect=True)
@pytest.mark.parametrize("P", [1, 8])
def test_paths_through_the_collectives_equal_the_reference(P, policy):
    sj, kws = _crafted_schema(seed=0)
    jplans, pplans, _ = plan_pairs(sj, kws, 3, P=P)
    jmesh, mesh = jax_mesh(1), make_worker_mesh(P, "cpu")
    jeng = JaxEngine(cache=JAX_CACHE)
    reduction = "psum_scatter" if P > 1 else "psum"

    # the per-CN baseline: one psum, one all_to_all per relation
    for pj, pp in zip(jplans, pplans):
        with collective_census() as census:
            got = run_cn_plan(pp, mesh, accum=policy)
        np.testing.assert_array_equal(got, jax_run_cn_plan(pj, jmesh))
        assert census == _census(all_to_all=1 + len(pp.included), psum=1)

    # the engine's families: one reduction per dispatched group, 1 + m
    # all_to_alls each, no gather
    groups = group_plan_indices(pplans, True, policy)
    a2a = sum(1 + sig.m for sig, _ in groups)
    want = {False: jeng.run_plans(jplans, jmesh),
            True: jeng.run_plans_individual(jplans, jmesh)}
    for store in (None, RelationStore(mesh)):
        for individual in (False, True):
            eng = FCTEngine(cache=ExecutableCache())
            with collective_census() as census:
                pending = eng.dispatch_plans(pplans, mesh,
                                             individual=individual,
                                             store=store, accum=policy)
            assert census == _census(all_to_all=a2a,
                                     **{reduction: len(groups)})
            got = (eng.collect_individual(pending, len(pplans), sj.vocab_size)
                   if individual else eng.collect_total(pending,
                                                        sj.vocab_size))
            np.testing.assert_array_equal(got, want[individual])

    # device top-k: the groups' reductions, then one gather under
    # reduce-scatter at P > 1 and none on one shard
    eng = FCTEngine(cache=ExecutableCache())
    with collective_census() as census:
        tp = eng.dispatch_topk(pplans, mesh, 5, keywords=kws, accum=policy,
                               prune="off")
    assert census == _census(all_to_all=a2a, all_gather=int(P > 1),
                             **{reduction: len(groups)})
    ids, counts = eng.collect_topk(tp)
    jids, jcounts = jeng.collect_topk(jeng.dispatch_topk(
        jplans, jmesh, 5, keywords=kws, prune="off"))
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(counts, jcounts)
