"""The port's device-side top-k finalize (the ``fct_topk`` family) against
the JAX package's on the CPU: ids, counts and their order, bit for bit, at
P = 1 and P = 8 (a vocab of 100 is no multiple of 8, so reduce-scatter pad
bins exist and must never surface), under both accumulation policies;
crafted ties through the finalize program itself (the lowest term id wins,
at every P); k past the vocab; the device-side wrap flag raising the
reference's OverflowError; the ``zero`` and ``threshold`` prune modes with
the reference's pruning ledger; the O(k) transfer; the ``k_bucket``
program lattice; and the gateway's routing.  (``tests/test_topk.py`` on
the port, without its subprocess cases: the port's P = 8 runs in
process.)"""
import numpy as np
import pytest

from repro.api import FCTRequest as JaxRequest
from repro.api import FCTSession as JaxSession
from repro.api import SessionConfig as JaxConfig
from repro.core.accum import INT32_CHECKED as JAX_INT32
from repro.data.tpch import TpchConfig, generate, plant_keywords
from repro.launch.mesh import make_worker_mesh as jax_mesh
from repro.runtime import engine as jax_engine
from repro.runtime.cache import ExecutableCache as JaxCache
from repro.runtime.engine import FCTEngine as JaxEngine
from repro_torch.api import FCTRequest, FCTSession, SessionConfig
from repro_torch.core.accum import INT32_CHECKED, INT64_EXACT
from repro_torch.core.star import topk_terms
from repro_torch.data.schema import schema_from_reference
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.runtime import engine
from repro_torch.runtime.cache import ExecutableCache
from repro_torch.runtime.engine import FCTEngine


def _dataset(vocab=128, skew=0.0, seed=5, frac=0.3, fact_rows=800):
    cfg = TpchConfig(fact_rows=fact_rows, part_rows=64, supp_rows=48,
                     order_rows=56, text_len=6, vocab_size=vocab,
                     seed=seed, skew=skew)
    kws = [vocab - 3, vocab - 2, vocab - 1]
    schema = plant_keywords(generate(cfg),
                            {"PART": [kws[0]], "SUPPLIER": [kws[1]],
                             "ORDERS": [kws[2]]}, frac=frac)
    return schema, kws


def _jax(sj, **config):
    return JaxSession(sj, engine=JaxEngine(cache=JaxCache()),
                      config=JaxConfig(**config))


def _port(sj, P=1, **config):
    return FCTSession(schema_from_reference(sj), device="cpu", n_workers=P,
                      engine=FCTEngine(cache=ExecutableCache()),
                      config=SessionConfig(**config))


def _same(got, want):
    np.testing.assert_array_equal(got.term_ids, want.term_ids)
    np.testing.assert_array_equal(got.freqs, want.freqs)
    assert got.term_ids.dtype == np.int64 and got.freqs.dtype == np.int64
    assert (got.finalize, got.all_freqs is None) == \
        (want.finalize, want.all_freqs is None)


CASES = {  # name -> (dataset kwargs, request kwargs)
    "uniform": (dict(), dict(top_k=10, r_max=4)),
    "skewed vocab 100": (dict(vocab=100, skew=1.2, seed=5, frac=0.4,
                              fact_rows=600), dict(top_k=7, r_max=3)),
    "k past vocab": (dict(vocab=100), dict(top_k=10_000, r_max=4)),
}


@pytest.fixture(scope="module")
def reference():
    out = {}
    for name, (dkw, rkw) in CASES.items():
        sj, kws = _dataset(**dkw)
        req = JaxRequest(keywords=tuple(kws), **rkw)
        out[name] = (sj, kws, rkw, _jax(sj, device_topk=True).query(req))
    return out


@pytest.mark.parametrize("accum", ["int32", "int64"])
@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_device_topk_equals_the_reference(reference, case, P, accum):
    sj, kws, rkw, want = reference[case]
    session = _port(sj, P, device_topk=True, accum_policy=accum)
    got = session.query(FCTRequest(keywords=tuple(kws), **rkw))
    _same(got, want)
    assert got.accum_policy == ("int64-exact" if accum == "int64"
                                else "int32-checked")
    if accum == "int32":   # the same O(k) transfer: counts, ids, flag
        assert got.engine_stats["device_to_host_bytes"] == \
            want.engine_stats["device_to_host_bytes"]
    if rkw["top_k"] > sj.vocab_size:
        assert len(got.term_ids) == sj.vocab_size
    # warm repeat: same bits, nothing built
    again = session.query(FCTRequest(keywords=tuple(kws), **rkw))
    _same(again, want)
    assert again.engine_stats["traces"] == 0


@pytest.mark.parametrize("P", [1, 8])
def test_tie_break_is_lowest_id_through_the_program(P):
    """Crafted ties straight through the finalize program: the lowest term
    id wins among equal counts, as in the reference's program and in the
    host oracle's stable ``argsort(-f)``, at every P."""
    vocab, k = 50, 8
    tsig = engine.topk_signature(vocab, P, INT32_CHECKED, k)
    fn = engine._build_topk_fn(tsig, make_worker_mesh(P, "cpu"), True)
    rng = np.random.default_rng(0)
    hist = rng.integers(0, 4, vocab).astype(np.int32)   # dense small ties
    hist[[7, 23, 41]] = 9                               # three-way top tie
    kw = engine.keyword_ids_array([23])
    excl = np.zeros(vocab, np.int8)
    excl[0] = 1
    eng = FCTEngine(cache=ExecutableCache())
    mesh = make_worker_mesh(P, "cpu")
    counts, ids, wrapped = (x.numpy() for x in fn(
        eng.vocab_device_vector(hist, mesh, np.int32), kw,
        eng.vocab_device_vector(excl, mesh, np.int8)))
    jsig = jax_engine.topk_signature(vocab, 1, JAX_INT32, k)
    jfn = jax_engine._build_topk_fn(jsig, jax_mesh(1), False, 8)
    jc, ji, jw = (np.asarray(x) for x in jfn(hist, kw, excl))
    oracle_ids, oracle_f = topk_terms(hist.astype(np.int64), [23],
                                      engine.k_effective(tsig),
                                      stop_mask=excl.astype(bool))
    np.testing.assert_array_equal(ids, ji)
    np.testing.assert_array_equal(counts, jc)
    np.testing.assert_array_equal(ids, oracle_ids)
    np.testing.assert_array_equal(counts.astype(np.int64), oracle_f)
    assert int(wrapped) == int(jw) == 0
    assert ids[0] == 7 and 23 not in ids


@pytest.mark.parametrize("P", [1, 8])
def test_all_equal_counts_come_out_in_id_order(P):
    """A histogram of equal counts: the candidates are the lowest ids in
    ascending order (the keyword and PAD excluded), with no pad bin."""
    vocab = 1000                             # 1000 % 8 == 0; 1003 below
    for v in (vocab, vocab + 3):
        tsig = engine.topk_signature(v, P, INT64_EXACT, 20)
        mesh = make_worker_mesh(P, "cpu")
        eng = FCTEngine(cache=ExecutableCache())
        fn = engine._build_topk_fn(tsig, mesh, True)
        excl = np.zeros(v, np.int8)
        excl[0] = 1
        counts, ids, _ = fn(eng.vocab_device_vector(np.full(v, 5), mesh,
                                                    np.int64),
                            engine.keyword_ids_array([3]),
                            eng.vocab_device_vector(excl, mesh, np.int8))
        want = [i for i in range(1, v) if i != 3][:engine.k_effective(tsig)]
        assert ids.tolist() == want and set(counts.tolist()) == {5}


def test_device_wrap_flag_raises_like_the_reference():
    hist = np.ones(50, np.int32)
    hist[13] = -7                              # a wrapped int32 accumulator
    mesh = make_worker_mesh(1, "cpu")
    eng = FCTEngine(cache=ExecutableCache())
    tsig = engine.topk_signature(50, 1, INT32_CHECKED, 5)
    fn = engine._build_topk_fn(tsig, mesh, True)
    counts, ids, wrapped = fn(eng.vocab_device_vector(hist, mesh, np.int32),
                              engine.keyword_ids_array([]),
                              eng.vocab_device_vector(np.zeros(50, np.int8),
                                                      mesh, np.int8))
    assert int(wrapped) == 1
    tp = engine.TopkPending(counts=counts, ids=ids, wrapped=wrapped,
                            k_eff=16, vocab=50, groups_run=1,
                            groups_pruned=0, pruned_rows=0)
    with pytest.raises(OverflowError) as got:
        eng.collect_topk(tp)
    jsig = jax_engine.topk_signature(50, 1, JAX_INT32, 5)
    jfn = jax_engine._build_topk_fn(jsig, jax_mesh(1), False, 8)
    jc, ji, jw = jfn(hist, jax_engine.keyword_ids_array([]),
                     np.zeros(50, np.int8))
    jtp = jax_engine.TopkPending(counts=jc, ids=ji, wrapped=jw, k_eff=16,
                                 vocab=50, groups_run=1, groups_pruned=0,
                                 pruned_rows=0)
    with pytest.raises(OverflowError) as want:
        JaxEngine(cache=JaxCache()).collect_topk(jtp)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("prune", ["off", "zero", "threshold"])
def test_prune_modes_equal_the_reference(prune, P):
    sj, kws = _dataset(skew=1.2, seed=7)
    req = dict(keywords=tuple(kws), top_k=10, r_max=4)
    want = _jax(sj, device_topk=True, topk_prune=prune).query(
        JaxRequest(**req))
    got = _port(sj, P, device_topk=True, topk_prune=prune).query(
        FCTRequest(**req))
    _same(got, want)
    if prune == "off":
        assert got.engine_stats["groups_pruned"] == 0
    if P == 1:   # the reference's ledger (at P = 8 the signature groups,
        #          and so what a group's bound covers, differ)
        for key in ("groups_pruned", "pruned_rows"):
            assert got.engine_stats[key] == want.engine_stats[key]
        assert prune == "off" or got.engine_stats["groups_pruned"] >= 1
    if prune == "threshold":                 # set-exact, counts lower bounds
        full = _port(sj, P).query(FCTRequest(**req))
        assert set(got.term_ids.tolist()) == set(full.term_ids.tolist())
        assert all(f <= full.all_freqs[t]
                   for t, f in zip(got.term_ids, got.freqs))


def test_k_bucket_shares_programs_across_nearby_k():
    sj, kws = _dataset()
    topk = _port(sj, device_topk=True)
    topk.query(FCTRequest(keywords=tuple(kws), top_k=10))
    traces = topk.engine.cache.traces
    r12 = topk.query(FCTRequest(keywords=tuple(kws), top_k=12))
    assert topk.engine.cache.traces == traces and len(r12.term_ids) == 12
    topk.query(FCTRequest(keywords=tuple(kws), top_k=40))
    assert topk.engine.cache.traces == traces + 1   # the finalize program


def test_need_histogram_and_batches_keep_the_host_finalize():
    sj, kws = _dataset()
    session = _port(sj, device_topk=True)
    full = session.query(FCTRequest(keywords=tuple(kws), top_k=5,
                                    need_histogram=True))
    assert full.finalize == "host" and full.all_freqs is not None
    batch = session.query_batch([FCTRequest(keywords=tuple(kws), top_k=5),
                                 FCTRequest(keywords=tuple(kws[:2]))])
    assert all(r.finalize == "host" for r in batch)
    np.testing.assert_array_equal(batch[0].all_freqs, full.all_freqs)


def test_gateway_routes_uncached_topk_to_the_device_path():
    from repro_torch.serve import Gateway, GatewayConfig, SchemaRegistry
    sj, kws = _dataset()
    reg = SchemaRegistry(device="cpu")
    reg.register("t", schema_from_reference(sj),
                 config=SessionConfig(device_topk=True))
    with Gateway(reg, config=GatewayConfig(result_cache_ttl_s=0)) as gw:
        resp = gw.query("t", FCTRequest(keywords=tuple(kws), top_k=5))
        assert resp.finalize == "device_topk"
        assert resp.all_freqs is None and len(resp.term_ids) == 5


def test_gateway_cache_fills_force_histogram_and_reslice_any_k():
    from repro_torch.serve import Gateway, GatewayConfig, SchemaRegistry
    sj, kws = _dataset()
    reg = SchemaRegistry(device="cpu")
    reg.register("t", schema_from_reference(sj),
                 config=SessionConfig(device_topk=True))
    with Gateway(reg, config=GatewayConfig(result_cache_ttl_s=60.0)) as gw:
        r1 = gw.query("t", FCTRequest(keywords=tuple(kws), top_k=5))
        assert r1.finalize == "host" and r1.all_freqs is not None
        r2 = gw.query("t", FCTRequest(keywords=tuple(kws), top_k=20))
        assert r2.cache_hit and len(r2.term_ids) == 20
        ro = _jax(sj).query(JaxRequest(keywords=tuple(kws), top_k=20))
        np.testing.assert_array_equal(r2.term_ids, ro.term_ids)
        np.testing.assert_array_equal(r2.freqs, ro.freqs)
