"""The port's FCTSession against the JAX package's, end to end on the CPU:
``query`` and ``query_batch`` at P = 1 and P = 8 must answer bit for bit
what ``repro.api.FCTSession.query`` answers (histograms, top-k ids and
counts, CN counts, shuffle accounting, balance), warm queries must build
and upload nothing, int64 sessions must equal the ``fct_star`` oracle and an
int32 overflow must raise the reference's OverflowError."""
import numpy as np
import pytest

from repro.api import FCTRequest as JaxRequest
from repro.api import FCTSession as JaxSession
from repro.core import candidate_network as jax_cn
from repro.core.plan import build_cn_plan as jax_build_cn_plan
from repro.core.star import fct_star, topk_terms
from repro_torch.api import FCTRequest, FCTSession, SessionConfig
from repro_torch.data.schema import schema_from_reference
from repro_torch.kernels.fct_count import ops
from repro_torch.obs import MetricsRegistry
from test_engine import _dataset
from test_system import small_schema
from test_torch_fct import overflow_schema


def _reference_plan_stats(sj, kws, r_max, P, mode):
    """shuffle_rows/shuffle_bytes/imbalance as the reference session reports
    them for a P-worker mesh (planning is host-only)."""
    ts = jax_cn.TupleSets.build(sj, kws)
    cns = jax_cn.prune_empty_cns(
        jax_cn.enumerate_star_cns(len(kws), sj.m, r_max), ts)
    rows = nbytes = 0
    imbalance, dominant = 1.0, -1.0
    for cn in cns:
        plan = jax_build_cn_plan(sj, ts, cn, P, mode=mode)
        if plan is None:
            continue
        rows += plan.shuffle_rows
        nbytes += plan.shuffle_bytes
        cost = float(plan.schedule.device_cost.sum())
        if cost > dominant:
            dominant, imbalance = cost, plan.schedule.imbalance
    return rows, nbytes, imbalance


CASES = {
    "system": (lambda: small_schema(), 4),
    "star": (lambda: _dataset("star"), 3),
    "chain": (lambda: _dataset("chain"), 3),
    "mix": (lambda: _dataset("mix"), 3),
}


@pytest.fixture(scope="module")
def reference():
    """Each case's schema, keywords, r_max and the JAX session's answers
    (full keywords and two subsets)."""
    out = {}
    for name, (make, r_max) in CASES.items():
        sj, kws = make()
        session = JaxSession(sj)
        reqs = [JaxRequest(keywords=tuple(k), top_k=10, r_max=r_max)
                for k in (kws, kws[:2], kws[1:])]
        out[name] = (sj, kws, r_max, [session.query(r) for r in reqs])
    return out


def _assert_same_answer(got, want, plan_stats=None):
    np.testing.assert_array_equal(got.all_freqs, want.all_freqs)
    np.testing.assert_array_equal(got.term_ids, want.term_ids)
    np.testing.assert_array_equal(got.freqs, want.freqs)
    assert (got.n_cns, got.n_joined_cns) == (want.n_cns, want.n_joined_cns)
    if plan_stats is None:
        plan_stats = (want.shuffle_rows, want.shuffle_bytes, want.imbalance)
    assert (got.shuffle_rows, got.shuffle_bytes, got.imbalance) == plan_stats
    assert got.accum_policy == want.accum_policy == "int32-checked"


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_query_and_batch_match_reference(reference, case, P):
    sj, kws, r_max, answers = reference[case]
    session = FCTSession(schema_from_reference(sj), device="cpu", n_workers=P)
    reqs = [FCTRequest(keywords=tuple(a.request.keywords), top_k=10,
                       r_max=r_max) for a in answers]
    stats = [None if P == 1 else _reference_plan_stats(
        sj, list(r.keywords), r_max, P, "uniform") for r in reqs]
    ops.reset_path_counts()
    for req, want, st in zip(reqs, answers, stats):
        _assert_same_answer(session.query(req), want, st)
    for got, want, st in zip(session.query_batch(reqs), answers, stats):
        _assert_same_answer(got, want, st)
    assert ops.PATH_COUNTS["ref"] > 0          # CPU tensors -> plain version
    assert ops.PATH_COUNTS["cuda_exact"] == 0


def test_warm_query_builds_and_uploads_nothing(reference):
    sj, kws, r_max, answers = reference["star"]
    session = FCTSession(schema_from_reference(sj), device="cpu", n_workers=8,
                         config=SessionConfig(cache_max_entries=16),
                         metrics=MetricsRegistry())
    req = FCTRequest(keywords=tuple(kws), r_max=r_max)
    cold = session.query(req)
    assert cold.cold and cold.engine_stats["store_uploads"] > 0
    for _ in range(2):
        warm = session.query(req)
        assert not warm.cold
        assert warm.engine_stats["traces"] == 0
        assert warm.engine_stats["store_uploads"] == 0
        assert warm.engine_stats["store_hits"] > 0
        assert warm.engine_stats["device_to_host_bytes"] > 0
        np.testing.assert_array_equal(warm.all_freqs, cold.all_freqs)
        assert {"plan", "engine.dispatch_group", "dispatch", "collect",
                "finalize"} <= {s.name for s in warm.trace.spans()}
    st = session.stats()
    assert st["plan_hits"] == 2 and st["store_bytes"] > 0
    # the session's private registry holds exactly this session's counters
    snap = session.metrics.snapshot()
    assert snap["counters"]["session.queries_served"] == 3
    assert snap["counters"]["engine.batches_run"] == st["batches_run"] > 0
    assert snap["gauges"]["store.resident_bytes"] == st["store_bytes"]
    dropped = session.invalidate()
    assert dropped["store_entries"] > 0 and session.store.resident_bytes == 0


@pytest.mark.parametrize("P", [1, 8])
def test_int64_session_equals_oracle(reference, P):
    sj, kws, r_max, _ = reference["mix"]
    session = FCTSession(schema_from_reference(sj), device="cpu", n_workers=P,
                         config=SessionConfig(accum_policy="int64",
                                              adaptive_rho=True))
    resp = session.query(FCTRequest(keywords=tuple(kws), r_max=r_max))
    oracle = fct_star(sj, kws, r_max)
    np.testing.assert_array_equal(resp.all_freqs, oracle)
    ids, f = topk_terms(oracle, kws, 10)
    np.testing.assert_array_equal(resp.term_ids, ids)
    np.testing.assert_array_equal(resp.freqs, f)
    assert resp.accum_policy == "int64-exact"


def test_int32_overflow_raises_the_reference_error():
    sj, kws = overflow_schema()
    with pytest.raises(OverflowError) as want:
        JaxSession(sj).query(JaxRequest(keywords=tuple(kws), r_max=4))
    session = FCTSession(schema_from_reference(sj), device="cpu")
    with pytest.raises(OverflowError) as got:
        session.query(FCTRequest(keywords=tuple(kws), r_max=4))
    assert str(got.value) == str(want.value)
    exact = FCTSession(schema_from_reference(sj), device="cpu",
                       config=SessionConfig(accum_policy="int64"))
    resp = exact.query(FCTRequest(keywords=tuple(kws), r_max=4))
    np.testing.assert_array_equal(resp.all_freqs, fct_star(sj, kws, 4))


@pytest.mark.parametrize("P", [1, 8])
def test_run_plans_families_equal_the_reference(reference, P):
    """``FCTEngine.run_plans`` (summed) and ``run_plans_individual`` (per
    CN) over the same CN plans: bit for bit the reference engine's at
    P = 1 (both are P-invariant)."""
    from repro.launch.mesh import make_worker_mesh as jax_mesh
    from repro.runtime.engine import FCTEngine as JaxEngine
    from repro_torch.core import candidate_network as pt_cn
    from repro_torch.core.plan import build_cn_plan
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.runtime.engine import FCTEngine
    sj, kws, r_max, _ = reference["star"]
    sp = schema_from_reference(sj)
    tj, tp = jax_cn.TupleSets.build(sj, kws), pt_cn.TupleSets.build(sp, kws)
    cj = jax_cn.prune_empty_cns(jax_cn.enumerate_star_cns(len(kws), sj.m,
                                                          r_max), tj)
    cp = pt_cn.prune_empty_cns(pt_cn.enumerate_star_cns(len(kws), sp.m,
                                                        r_max), tp)
    jplans = [p for p in (jax_build_cn_plan(sj, tj, cn, 1) for cn in cj)
              if p is not None]
    pplans = [p for p in (build_cn_plan(sp, tp, cn, P) for cn in cp)
              if p is not None]
    assert len(jplans) == len(pplans) > 1
    jeng, peng, mesh = JaxEngine(), FCTEngine(), make_worker_mesh(P, "cpu")
    np.testing.assert_array_equal(peng.run_plans(pplans, mesh),
                                  jeng.run_plans(jplans, jax_mesh(1)))
    np.testing.assert_array_equal(
        peng.run_plans_individual(pplans, mesh),
        jeng.run_plans_individual(jplans, jax_mesh(1)))
