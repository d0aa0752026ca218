"""The store path keeps each plan's send tables on the device
(``runtime/store.py::store_group_args``, ``RelationRoute.device_tables``),
on the CPU:

* a plan's first store-path dispatch uploads its send tables and key-column
  indices (``send_uploads`` > 0, the bytes in ``bytes_shipped``); a second
  dispatch of the same plans ships 0 bytes, counts only ``send_hits`` and
  answers bit for bit the same;
* those answers equal a storeless call's (a store made for the call), the
  JAX engine's and the per-CN ``run_cn_plan``'s, for ``run_plans`` and for
  ``run_plans_individual`` over two compositions whose groups take
  different numbers of null CN slots, at P = 1 and 8 under both
  accumulation policies, and the caller's store uploads each column once;
  ``dispatch_topk`` gives a storeless call's top-k;
* after ``FCTSession.append`` and after ``invalidate()`` the re-planned
  routes upload their tables anew, no table of the dropped plans is reused,
  and the answers equal the reference's ``fct_star``;
* the store's text address tables (``RelationStore.text_pointers``, which
  the routed MR² kernel reads on CUDA) are made once per group of live
  text tensors, found again at 0 bytes, and dropped with their texts.
"""
import gc

import numpy as np
import pytest
import torch

from repro.core.star import fct_star
from repro.runtime.engine import FCTEngine as JaxEngine
from repro.launch.mesh import make_worker_mesh as jax_mesh
from repro_torch.api import FCTRequest, FCTSession
from repro_torch.core.fct import run_cn_plan
from repro_torch.data.schema import schema_from_reference
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.obs import MetricsRegistry
from repro_torch.runtime.cache import ExecutableCache
from repro_torch.runtime.engine import (CN_BUCKET_MIN, FCTEngine,
                                        keyword_ids_array)
from repro_torch.runtime.store import RelationStore
from test_ingest import KWS, make_batch, make_schema
from test_torch_engine import (DATASETS, JAX_CACHE, POLICIES, plan_pairs,
                               policy)  # noqa: F401  (policy: a fixture)

SEND_KEYS = ("bytes_shipped", "send_uploads", "send_hits")


def _engine():
    return FCTEngine(cache=ExecutableCache(), metrics=MetricsRegistry())


def _sends(eng, before=None):
    st = eng.stats()
    now = {k: st[k] for k in SEND_KEYS}
    if before is None:
        return now
    return {k: now[k] - before[k] for k in SEND_KEYS}


def _routes(plans):
    return [r for p in plans for r in (p.fact, *p.dims.values())]


def _compositions(plans):
    """All plans, and every other plan reversed: two batches of the same
    plans whose signature groups differ in size."""
    return [list(range(len(plans))), list(range(len(plans)))[::-2]]


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("policy", list(POLICIES), indirect=True)
@pytest.mark.parametrize("dataset", list(DATASETS))
def test_second_dispatch_ships_nothing_and_equals_every_family(dataset,
                                                               policy, P):
    sj, kws = DATASETS[dataset]()
    jplans, pplans, _ = plan_pairs(sj, kws, 3, P)
    jeng = JaxEngine(cache=JAX_CACHE)
    mesh = make_worker_mesh(P, "cpu")
    # totals and per-CN histograms do not depend on P: the reference at 1
    want = jeng.run_plans(jplans, jax_mesh(1))
    want_indiv = jeng.run_plans_individual(jplans, jax_mesh(1))
    np.testing.assert_array_equal(
        sum(run_cn_plan(p, mesh, accum=policy) for p in pplans), want)
    eng, store = _engine(), RelationStore(mesh)

    # first dispatch: every route's table goes up once
    first = eng.run_plans(pplans, mesh, store=store, accum=policy)
    up = _sends(eng)
    n_tables = len(_routes(pplans))
    assert up["send_uploads"] == n_tables and up["send_hits"] == 0
    assert up["bytes_shipped"] > 0
    np.testing.assert_array_equal(first, want)
    column_bytes = store.stats()["store_upload_bytes"]
    assert column_bytes > 0

    # second dispatch of the same plans: nothing shipped, all hits
    before = _sends(eng)
    again = eng.run_plans(pplans, mesh, store=store, accum=policy)
    assert _sends(eng, before) == {"bytes_shipped": 0, "send_uploads": 0,
                                   "send_hits": n_tables}
    np.testing.assert_array_equal(again, first)
    # a storeless call: the same answer (after the store path's first
    # dispatch, which the tables' uploads above count)
    storeless = _engine()
    np.testing.assert_array_equal(
        storeless.run_plans(pplans, mesh, accum=policy), want)

    # per-CN family over two compositions, null CN slots included
    padded = False
    for idxs in _compositions(pplans):
        plans = [pplans[i] for i in idxs]
        groups = eng._group(plans, policy)
        padded |= any(len(g) % CN_BUCKET_MIN for _, g in groups)
        before = _sends(eng)
        got = eng.run_plans_individual(plans, mesh, store=store,
                                       accum=policy)
        assert _sends(eng, before) == {"bytes_shipped": 0,
                                       "send_uploads": 0,
                                       "send_hits": len(_routes(plans))}
        np.testing.assert_array_equal(got, want_indiv[idxs])
        np.testing.assert_array_equal(
            got, storeless.run_plans_individual(plans, mesh, accum=policy))
    assert padded
    # the columns went up once, at the first dispatch
    assert store.stats()["store_upload_bytes"] == column_bytes


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("policy", list(POLICIES), indirect=True)
def test_dispatch_topk_from_resident_tables(policy, P):
    sj, kws = DATASETS["tpch_star"]()
    _, pplans, _ = plan_pairs(sj, kws, 3, P)
    mesh = make_worker_mesh(P, "cpu")
    eng, store = _engine(), RelationStore(mesh)
    excl = eng.vocab_device_vector(np.zeros(pplans[0].vocab_size, np.int8),
                                   mesh, np.int8)
    answers = []
    for run in range(2):
        before = _sends(eng)
        answers.append(eng.collect_topk(eng.dispatch_topk(
            pplans, mesh, 10, keywords=kws, excl=excl, store=store,
            accum=policy, prune="off")))
        moved = _sends(eng, before)
        if run == 0:
            assert moved["send_uploads"] == len(_routes(pplans))
        else:
            assert moved["send_uploads"] == 0 and moved["send_hits"] > 0
            # the keyword-id vector is the one argument shipped per call
            assert moved["bytes_shipped"] == keyword_ids_array(kws).nbytes
    storeless = _engine()
    want = storeless.collect_topk(storeless.dispatch_topk(
        pplans, mesh, 10, keywords=kws, accum=policy, prune="off"))
    for got in answers:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _tables(plans):
    return [t for r in _routes(plans) for t in r.device_tables.values()]


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("mutation", ["append", "invalidate"])
def test_replanned_routes_upload_anew(mutation, P):
    ref = make_schema(11, m=2, fact_rows=24)
    # an engine of its own: the process-wide program cache stays as other
    # test modules expect it
    session = FCTSession(schema_from_reference(ref), device="cpu",
                         n_workers=P, engine=_engine())
    req = FCTRequest(keywords=KWS, r_max=3, top_k=5)
    cold = session.query(req)
    assert cold.engine_stats["send_uploads"] > 0
    warm = session.query(req)
    assert warm.engine_stats["send_uploads"] == 0
    assert warm.engine_stats["send_hits"] == cold.engine_stats["send_uploads"]
    assert warm.engine_stats["bytes_shipped"] == 0
    old_plans = session._plan(req).plans
    old_routes = {id(r) for r in _routes(old_plans)}
    old_tables = {id(t) for t in _tables(old_plans)}
    assert old_tables
    if mutation == "append":
        rng = np.random.default_rng(5)
        batch = make_batch(rng, ref, "F", 3)
        session.append("F", batch)
        keys = {c: np.array([r[c] for r in batch], np.int32)
                for c in ref.fact.keys}
        text = np.array([r["text"] for r in batch], np.int32)
        ref = ref.with_appended("F", keys, text)
    else:
        session.invalidate()
    after = session.query(req)
    assert after.engine_stats["send_uploads"] > 0
    assert after.engine_stats["send_hits"] == 0
    new_plans = session._plan(req).plans
    assert not old_routes & {id(r) for r in _routes(new_plans)}
    assert not old_tables & {id(t) for t in _tables(new_plans)}
    freq = fct_star(ref, list(KWS), 3)
    np.testing.assert_array_equal(after.all_freqs, freq)
    again = session.query(req)
    assert again.engine_stats["send_uploads"] == 0
    assert again.engine_stats["bytes_shipped"] == 0
    np.testing.assert_array_equal(again.all_freqs, freq)
    session.close()


def test_text_pointer_tables_follow_their_texts():
    mesh = make_worker_mesh(2, "cpu")
    store = RelationStore(mesh)
    a, b = (torch.zeros((2, 4, 3), dtype=torch.int32) for _ in range(2))
    table, nbytes = store.text_pointers([a, b, a])
    assert table.dtype == torch.int64 and nbytes == 3 * 8
    assert table.tolist() == [a.data_ptr(), b.data_ptr(), a.data_ptr()]
    # the same live tensors: the same table, nothing shipped
    again, nbytes = store.text_pointers([a, b, a])
    assert again is table and nbytes == 0
    # another composition: a table of its own
    other, nbytes = store.text_pointers([b, a])
    assert other is not table and nbytes == 2 * 8
    assert len(store._pointers) == 2
    # a text dies: every table that held it goes
    del b
    gc.collect()
    assert len(store._pointers) == 0
    fresh, nbytes = store.text_pointers([a])
    assert nbytes == 8 and store.text_pointers([a])[0] is fresh
    store.clear()
    assert len(store._pointers) == 0
    assert store.text_pointers([a])[1] == 8
