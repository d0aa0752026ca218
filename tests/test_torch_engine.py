"""The port's FCTEngine beyond a session's store, against the JAX package's
on the CPU: a storeless call (a store made for the call) bit for bit the
reference's storeless engine and the port's per-CN ``run_cn_plan`` (held to
the reference's in ``test_torch_fct.py``), with the reference's group and
CN counts, under both accumulation policies; its column bytes counted as
store uploads (``store.upload_bytes``) and its send tables as
``bytes_shipped`` at the plans' first dispatch only; a caller's store
uploading the same columns once; the engine options ``batch=``,
``bucket=`` and ``reduce_scatter=`` with the reference's group counts; and
program-cache keys that never alias across families, shapes, aggregation
layouts and the two-job programs."""
import jax
import numpy as np
import pytest

from repro.core import candidate_network as jax_cn
from repro.core.plan import build_cn_plan as jax_build_cn_plan
from repro.launch.mesh import make_worker_mesh as jax_mesh
from repro.runtime import batch as jax_batch
from repro.runtime.cache import ExecutableCache as JaxCache
from repro.runtime.engine import FCTEngine as JaxEngine
from repro_torch.core import candidate_network as pt_cn
from repro_torch.core.accum import INT32_CHECKED, INT64_EXACT
from repro_torch.core.fct import run_cn_plan, run_cn_plan_two_jobs
from repro_torch.core.plan import build_cn_plan
from repro_torch.data.schema import schema_from_reference
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.obs import MetricsRegistry
from repro_torch.runtime import batch
from repro_torch.runtime.batch import group_plan_indices
from repro_torch.runtime.cache import ExecutableCache
from repro_torch.runtime.engine import FCTEngine
from repro_torch.runtime.store import RelationStore
from test_engine import _crafted_schema, _dataset

POLICIES = {"int32": INT32_CHECKED, "int64": INT64_EXACT}
#: one reference program cache for the module: its keys carry the x64 flag,
#: so the two policies never share a program, and the tests compile each
#: reference program once
JAX_CACHE = JaxCache()


@pytest.fixture
def policy(request):
    """The port's policy, with the JAX process's x64 flag set to match (the
    reference engine follows the flag)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", request.param == "int64")
    yield POLICIES[request.param]
    jax.config.update("jax_enable_x64", prev)


def plan_pairs(sj, kws, r_max, P=1):
    """(the reference's joined-CN plans at P = 1, the port's at P, the
    port's schema), CN for CN in the same order."""
    sp = schema_from_reference(sj)
    tj, tp = jax_cn.TupleSets.build(sj, kws), pt_cn.TupleSets.build(sp, kws)
    cj = jax_cn.prune_empty_cns(
        jax_cn.enumerate_star_cns(len(kws), sj.m, r_max), tj)
    cp = pt_cn.prune_empty_cns(
        pt_cn.enumerate_star_cns(len(kws), sp.m, r_max), tp)
    jplans = [p for p in (jax_build_cn_plan(sj, tj, cn, 1) for cn in cj)
              if p is not None]
    pplans = [p for p in (build_cn_plan(sp, tp, cn, P) for cn in cp)
              if p is not None]
    assert len(jplans) == len(pplans) > 1
    return jplans, pplans, sp


DATASETS = {"star_crafted": lambda: _crafted_schema(seed=0),
            "tpch_star": lambda: _dataset("star")}


def _engine(**options):
    """An engine on metrics of its own, so its stores' counters are its
    calls' alone."""
    return FCTEngine(cache=ExecutableCache(), metrics=MetricsRegistry(),
                     **options)


def column_bytes(eng):
    """Column bytes uploaded by the stores on ``eng``'s metrics: those its
    storeless calls made for themselves."""
    return eng.metrics.snapshot()["counters"].get("store.upload_bytes", 0)


def resident_bytes(eng):
    """Bytes still resident in those stores: 0 once their calls ended."""
    return eng.metrics.snapshot()["gauges"].get("store.resident_bytes", 0)


@pytest.mark.parametrize("bucket", [True, False])
def test_signatures_groups_and_stacks_equal_the_reference(bucket):
    """``runtime/batch.py`` on one plan list: the reference's signatures
    (exact dims with ``bucket=False``), groups, and each grouped plan's host
    arrays padded to its group's signature (what the two-job path uploads,
    and the shapes a group's resident columns are stored at), value for
    value and dtype for dtype."""
    sj, kws = _dataset("mix")
    jplans, pplans, _ = plan_pairs(sj, kws, 3)
    jgroups = jax_batch.group_plans(jplans, bucket)
    groups = batch.group_plans(pplans, bucket)
    assert [len(g) for _, g in groups] == [len(g) for _, g in jgroups]
    for (sig, group), (jsig, jgroup) in zip(groups, jgroups):
        assert (sig.n_devices, sig.vocab, sig.m) == \
            (jsig.n_devices, jsig.vocab, jsig.m)
        for a, b in zip((sig.fact, *sig.dims), (jsig.fact, *jsig.dims)):
            assert (a.rows, a.cap, a.text_len, a.domain, a.key_width) == \
                (b.rows, b.cap, b.text_len, b.domain, b.key_width)
        for plan, jplan in zip(group, jgroup):
            fact, dims = batch.pad_plan_arrays(plan, sig)
            jfact, jdims = jax_batch.pad_plan_arrays(jplan, jsig)
            for rel, jrel in zip((fact, *dims), (jfact, *jdims)):
                for k in ("text", "keys", "send"):
                    assert rel[k].dtype == jrel[k].dtype
                    np.testing.assert_array_equal(rel[k], jrel[k])
    if bucket:
        assert all(batch.bucket_pow2(sig.fact.rows) == sig.fact.rows
                   for sig, _ in groups)


@pytest.mark.parametrize("policy", list(POLICIES), indirect=True)
@pytest.mark.parametrize("dataset", list(DATASETS))
def test_storeless_bit_identical_to_reference(dataset, policy):
    sj, kws = DATASETS[dataset]()
    jplans, pplans, _ = plan_pairs(sj, kws, 3)
    jmesh, mesh = jax_mesh(1), make_worker_mesh(1, "cpu")
    jeng = JaxEngine(cache=JAX_CACHE)
    peng = _engine()
    total = peng.run_plans(pplans, mesh, accum=policy)
    np.testing.assert_array_equal(total, jeng.run_plans(jplans, jmesh))
    np.testing.assert_array_equal(
        total, sum(run_cn_plan(p, mesh, accum=policy) for p in pplans))
    first = peng.stats()
    columns = column_bytes(peng)
    indiv = peng.run_plans_individual(pplans, mesh, accum=policy)
    np.testing.assert_array_equal(indiv,
                                  jeng.run_plans_individual(jplans, jmesh))
    st = peng.stats()
    assert (st["batches_run"], st["cns_run"]) == (jeng.batches_run,
                                                  jeng.cns_run)
    # each call uploads the columns to a store of its own, dropped when the
    # call ends; the send tables go up with the plans' first dispatch only
    assert columns > 0 and column_bytes(peng) == 2 * columns
    assert resident_bytes(peng) == 0
    n_routes = sum(1 + len(p.included) for p in pplans)
    assert first["send_uploads"] == n_routes and first["bytes_shipped"] > 0
    assert st["send_uploads"] == n_routes and st["send_hits"] == n_routes
    assert st["bytes_shipped"] == first["bytes_shipped"]
    # a caller's store: bit-equal, the same columns uploaded once, and its
    # per-CN family re-uploads nothing
    seng = _engine()
    store = RelationStore(mesh)
    np.testing.assert_array_equal(
        seng.run_plans(pplans, mesh, store=store, accum=policy), total)
    uploads = store.stats()["store_uploads"]
    np.testing.assert_array_equal(
        seng.run_plans_individual(pplans, mesh, store=store, accum=policy),
        indiv)
    assert uploads > 0 and store.stats()["store_uploads"] == uploads
    assert store.stats()["store_upload_bytes"] == columns
    assert column_bytes(seng) == 0


@pytest.mark.parametrize("batch,bucket", [(False, False), (True, False),
                                          (False, True)])
def test_engine_options_match_reference(batch, bucket):
    """``batch=`` / ``bucket=``: the batched result, the reference's group
    count and bytes (exact ``C`` can differ per CN, so ``bucket=False``
    yields at least as many groups)."""
    sj, kws = _dataset("star")
    jplans, pplans, _ = plan_pairs(sj, kws, 3)
    jmesh, mesh = jax_mesh(1), make_worker_mesh(1, "cpu")
    want = FCTEngine(cache=ExecutableCache()).run_plans_individual(pplans,
                                                                   mesh)
    jeng = JaxEngine(cache=JAX_CACHE, batch=batch, bucket=bucket)
    peng = _engine(batch=batch, bucket=bucket)
    columns, sends = [], []
    for run in ("run_plans", "run_plans_individual"):
        got = getattr(peng, run)(pplans, mesh)
        np.testing.assert_array_equal(got, getattr(jeng, run)(jplans, jmesh))
        np.testing.assert_array_equal(
            got, want.sum(axis=0) if run == "run_plans" else want)
        columns.append(column_bytes(peng))
        st = peng.stats()
        sends.append((st["send_uploads"], st["send_hits"]))
    assert st["batches_run"] == jeng.batches_run
    # both calls upload the same columns to stores of their own; a send
    # table goes up at its route's first dispatch at its cap (``want``'s
    # run uploaded the bucketed caps), so the second call finds them all
    assert columns[0] > 0 and columns[1] == 2 * columns[0]
    n_routes = sum(1 + len(p.included) for p in pplans)
    assert sum(sends[0]) == n_routes
    assert sends[1] == (sends[0][0], sends[0][1] + n_routes)
    n_groups = len(group_plan_indices(pplans, bucket))
    assert jeng.batches_run == 2 * (len(pplans) if not batch else n_groups)
    assert n_groups >= len(group_plan_indices(pplans, True))


def test_cache_keys_never_alias():
    """One cache across every family: each new family, shape lattice,
    aggregation layout or two-job program adds its own entries; a repeat
    builds nothing.  At P = 8, so reduce-scatter and psum differ."""
    sj, kws = _dataset("star")
    _, plans, _ = plan_pairs(sj, kws, 3, P=8)
    mesh = make_worker_mesh(8, "cpu")
    cache = ExecutableCache()
    n_groups = len(group_plan_indices(plans))
    n_exact = len(group_plan_indices(plans, bucket=False))
    rs, psum = FCTEngine(cache=cache), FCTEngine(cache=cache,
                                                 reduce_scatter=False)
    exact = FCTEngine(cache=cache, bucket=False)
    store = RelationStore(mesh)
    want = rs.run_plans(plans, mesh)
    # a storeless call and a caller's store run the same programs
    steps = [(lambda: psum.run_plans(plans, mesh), n_groups),
             (lambda: rs.run_plans(plans, mesh, store=store), 0),
             (lambda: psum.run_plans(plans, mesh, store=store), 0),
             (lambda: exact.run_plans(plans, mesh), n_exact)]
    assert len(cache) == n_groups
    for run, added in steps:
        before = len(cache)
        np.testing.assert_array_equal(run(), want)
        assert len(cache) == before + added
    traces, hits = cache.traces, cache.stats()["hits"]
    np.testing.assert_array_equal(rs.run_plans(plans, mesh), want)
    assert cache.traces == traces
    assert cache.stats()["hits"] == hits + n_groups
    before = len(cache)
    run_cn_plan_two_jobs(plans[0], mesh, cache=cache)
    assert len(cache) == before + 2


@pytest.mark.parametrize("P", [1, 8])
def test_storeless_device_topk_matches_store_path(P):
    """``dispatch_topk`` without a store uploads the columns to a store of
    the call's own and finalizes the same candidates as with a caller's
    store, in both aggregation layouts."""
    sj, kws = _dataset("star")
    _, plans, _ = plan_pairs(sj, kws, 3, P=P)
    mesh = make_worker_mesh(P, "cpu")
    out = []
    for rs in (True, False):
        eng = _engine(reduce_scatter=rs)
        for store in (None, RelationStore(mesh)):
            tp = eng.dispatch_topk(plans, mesh, 10, keywords=kws,
                                   store=store, prune="off")
            out.append(eng.collect_topk(tp))
        assert column_bytes(eng) > 0 and resident_bytes(eng) == 0
    for ids, counts in out[1:]:
        np.testing.assert_array_equal(ids, out[0][0])
        np.testing.assert_array_equal(counts, out[0][1])
