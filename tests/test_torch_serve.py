"""The port's serving gateway (``repro_torch.serve``) on the CPU: its
answers equal the JAX package's gateway's and the reference's ``fct_star``
bit for bit, at P = 1 and P = 8; then the behaviour of
``tests/test_serve.py`` on the port — lazy tenants with partitioned
budgets, the result cache's TTL, LRU and generation fences, batching
windows and the shared ``FlushPool``, coalescing of identical in-flight
queries, per-tenant and gateway-wide admission, invalidation — and
``python -m repro_torch.launch.fct_serve --smoke --device cpu`` reaching
its ``SMOKE OK``."""
import contextlib
import io
import threading
import time

import numpy as np
import pytest

from repro.api import FCTRequest as JaxRequest
from repro.core.star import fct_star, topk_terms
from repro.serve import Gateway as JaxGateway
from repro.serve import SchemaRegistry as JaxRegistry
from repro_torch.api import FCTRequest, FCTSession, SessionConfig
from repro_torch.data.schema import schema_from_reference
from repro_torch.data.tpch import TpchConfig
from repro_torch.serve import (DynamicBatcher, FlushPool, Gateway,
                               GatewayConfig, ResultCache, SchemaRegistry)
from test_engine import _crafted_schema, _dataset


def _registry(**kw):
    return SchemaRegistry(device="cpu", **kw)


def _session(schema):
    return FCTSession(schema_from_reference(schema), device="cpu")


@pytest.mark.parametrize("P", [1, 8])
def test_gateway_answers_equal_the_reference(P):
    """One burst over two tenants (repeats coalesce, a second burst hits
    the cache, a smaller top_k re-slices): every answer equals the JAX
    gateway's and fct_star + topk_terms."""
    star, kws = _dataset("star")
    crafted, ckws = _crafted_schema(seed=0)
    stream = [("star", dict(keywords=tuple(kws), r_max=3, top_k=10)),
              ("star", dict(keywords=tuple(kws[:2]), r_max=3, top_k=10)),
              ("star", dict(keywords=tuple(kws), r_max=3, top_k=10)),
              ("crafted", dict(keywords=tuple(ckws), r_max=3, top_k=8)),
              ("star", dict(keywords=tuple(reversed(kws)), r_max=3,
                            top_k=4))]
    jreg = JaxRegistry()
    reg = _registry(n_workers=P)
    for name, sj in (("star", star), ("crafted", crafted)):
        jreg.register(name, sj)
        reg.register(name, schema_from_reference(sj))
    with JaxGateway(jreg) as jgw:
        futs = [jgw.submit(t, JaxRequest(**r)) for t, r in stream]
        want = [f.result(timeout=300) for f in futs]
    with Gateway(reg, GatewayConfig(batch_window_ms=20.0)) as gw:
        for burst in range(2):
            futs = [gw.submit(t, FCTRequest(**r)) for t, r in stream]
            got = [f.result(timeout=300) for f in futs]
            for (tenant, r), g, w in zip(stream, got, want):
                sj = star if tenant == "star" else crafted
                oracle = fct_star(sj, list(r["keywords"]), r["r_max"])
                ids, f = topk_terms(oracle, list(r["keywords"]), r["top_k"])
                for arr, ref in ((g.all_freqs, w.all_freqs),
                                 (g.all_freqs, oracle), (g.term_ids, ids),
                                 (g.term_ids, w.term_ids), (g.freqs, f)):
                    np.testing.assert_array_equal(arr, ref)
                if burst:
                    assert g.cache_hit
        assert gw.stats()["star"]["coalesced"] > 0   # the repeat in burst 1


# -- SchemaRegistry ----------------------------------------------------------

def test_registry_lazy_build_and_partitioned_budgets():
    schema_a, _ = _crafted_schema(seed=0)
    reg = _registry(total_cache_entries=64, total_plan_entries=64,
                    total_tuple_set_entries=32)
    reg.register("a", schema_from_reference(schema_a))
    reg.register("b", TpchConfig(scale=0.05))   # generated lazily
    assert set(reg.names()) == {"a", "b"} and len(reg) == 2
    assert not reg.built("a") and not reg.built("b")
    sa = reg.session("a")
    assert reg.built("a") and not reg.built("b")
    sb = reg.session("b")
    assert sb.schema.fact.rows > 0
    for s in (sa, sb):
        assert s.engine.cache.max_entries == 32
        assert s.config.plan_cache_size == 32
        assert s.config.tuple_set_cache_size == 16
        assert s.device.type == "cpu"
    assert sa.engine is not sb.engine and reg.session("a") is sa


def test_registry_rejects_bad_names_and_duplicates():
    schema = schema_from_reference(_crafted_schema(seed=0)[0])
    reg = _registry()
    reg.register("ok", schema)
    with pytest.raises(ValueError, match="already registered"):
        reg.register("ok", schema)
    for bad in ("", "with:colon", " padded "):
        with pytest.raises(ValueError, match="name"):
            reg.register(bad, schema)
    with pytest.raises(ValueError, match="reserved"):
        reg.register("gateway", schema)
    with pytest.raises(KeyError, match="unknown schema"):
        reg.session("missing")
    reg.register("nope", object())
    with pytest.raises(TypeError, match="StarSchema or TpchConfig"):
        reg.session("nope")


def test_registry_engines_shared_without_budget_and_overridable():
    a = schema_from_reference(_crafted_schema(seed=0)[0])
    b = schema_from_reference(_crafted_schema(seed=1)[0])
    reg = _registry()
    reg.register("a", a)
    reg.register("b", b)
    assert reg.session("a").engine is reg.session("b").engine
    reg2 = _registry(total_cache_entries=64)
    reg2.register("a", a, config=SessionConfig(cache_max_entries=5))
    assert reg2.session("a").engine.cache.max_entries == 5


# -- ResultCache -------------------------------------------------------------

class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_result_cache_ttl_expiry_and_refresh():
    clock = _FakeClock()
    cache = ResultCache(max_entries=8, ttl_s=10.0, clock=clock)
    cache.put("k", "v")
    assert cache.get("k") == "v" and cache.stats()["result_hits"] == 1
    clock.t = 9.9
    assert cache.get("k") == "v"
    clock.t = 10.0                              # expired exactly at TTL
    assert cache.get("k") is None
    assert cache.stats()["result_expirations"] == 1 and len(cache) == 0
    cache.put("k", "v2")
    clock.t = 15.0
    cache.put("k", "v3")                        # re-put refreshes the expiry
    clock.t = 24.0
    assert cache.get("k") == "v3"
    clock.t = 50.0
    assert cache.get("k") is None
    assert cache.stats()["result_expirations"] == 2


def test_result_cache_invalidation_disable_and_lru():
    cache = ResultCache(ttl_s=None)
    cache.put("a", 1)
    cache.put("b", 2)
    assert cache.invalidate("a") == 1 and cache.get("a") is None
    assert cache.invalidate() == 1 and len(cache) == 0
    assert cache.stats()["result_invalidations"] == 2
    off = ResultCache(ttl_s=0)
    off.put("a", 1)
    assert off.get("a") is None and len(off) == 0
    with pytest.raises(ValueError, match="ttl_s"):
        ResultCache(ttl_s=-1)
    lru = ResultCache(max_entries=2, ttl_s=None)
    lru.put("a", 1)
    lru.put("b", 2)
    lru.get("a")
    lru.put("c", 3)                             # evicts b
    assert lru.get("b") is None and lru.get("a") == 1
    assert lru.stats()["result_evictions"] == 1


def test_result_cache_generation_fences_inflight_puts_and_drain():
    cache = ResultCache(ttl_s=None)
    gen = cache.generation
    cache.invalidate()
    cache.put("k", "stale", generation=gen)
    assert cache.get("k") is None, "pre-invalidation result re-entered"
    cache.put("k", "fresh", generation=cache.generation)
    assert cache.get("k") == "fresh"
    new_gen, entries = cache.drain()
    assert entries == [("k", "fresh")] and len(cache) == 0
    cache.put("k", "late", generation=gen + 1)  # dispatched before drain
    assert cache.get("k") is None
    cache.put("k", "patched", generation=new_gen)
    assert cache.get("k") == "patched"


# -- DynamicBatcher / FlushPool ------------------------------------------------

def test_batcher_windows_stack_queries_and_match_sync():
    sj, kws = _crafted_schema(seed=0)
    session = _session(sj)
    batcher = DynamicBatcher(session, window_ms=20.0, name="t")
    reqs = [FCTRequest(keywords=tuple(kws), r_max=3, salt=i)
            for i in range(4)]
    got = [f.result(timeout=300) for f in [batcher.submit(r) for r in reqs]]
    st = batcher.stats()
    assert st["windows_flushed"] == 1 and st["queries_batched"] == 4
    assert st["max_window_queries"] == 4 and st["mean_window_queries"] == 4.0
    for resp, req in zip(got, reqs):
        np.testing.assert_array_equal(resp.all_freqs,
                                      session.query(req).all_freqs)
    batcher.close()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(reqs[0])


def test_batcher_zero_window_and_close_flushes_pending():
    sj, kws = _crafted_schema(seed=0)
    session = _session(sj)
    batcher = DynamicBatcher(session, window_ms=0.0)
    assert batcher.submit(FCTRequest(keywords=tuple(kws), r_max=3)).result(
        timeout=300).n_cns > 0
    batcher2 = DynamicBatcher(session, window_ms=200.0)
    fut2 = batcher2.submit(FCTRequest(keywords=tuple(kws), r_max=2))
    batcher2.close()                            # before the window elapses
    assert fut2.done() and fut2.result().n_cns >= 0
    batcher.close()
    with pytest.raises(ValueError, match="window_ms"):
        DynamicBatcher(session, window_ms=-1)


def test_flush_pool_runs_tenants_in_parallel_and_counts_peak():
    sa, kws = _crafted_schema(seed=0)
    sb, _ = _crafted_schema(seed=1)
    reg = _registry()
    reg.register("a", schema_from_reference(sa))
    reg.register("b", schema_from_reference(sb))
    gw = Gateway(reg, GatewayConfig(batch_window_ms=5.0, result_cache_ttl_s=0,
                                    flush_workers=2))
    barrier = threading.Barrier(2, timeout=60)
    for name in ("a", "b"):
        session = reg.session(name)
        inner = session.query_batch

        def synced(reqs, _inner=inner, **kw):
            barrier.wait()                      # both tenants' flushes inside
            return _inner(reqs, **kw)

        session.query_batch = synced
    fa = gw.submit("a", FCTRequest(keywords=tuple(kws), r_max=3))
    fb = gw.submit("b", FCTRequest(keywords=tuple(kws), r_max=3))
    assert fa.result(timeout=300).n_cns > 0
    assert fb.result(timeout=300).n_cns > 0
    st = gw.stats()["gateway"]
    assert st["flush_workers"] == 2 and st["flushes"] == 2
    assert st["flush_peak_inflight"] >= 2, st
    gw.close()
    assert gw.stats()["gateway"]["flush_inflight"] == 0


def test_batcher_close_waits_for_pooled_flushes():
    sj, kws = _crafted_schema(seed=0)
    session = _session(sj)
    pool = FlushPool(max_workers=2)
    release = threading.Event()
    inner = session.query_batch

    def gated(reqs, **kw):
        release.wait(timeout=60)
        return inner(reqs, **kw)

    session.query_batch = gated
    batcher = DynamicBatcher(session, window_ms=0.0, pool=pool)
    fut = batcher.submit(FCTRequest(keywords=tuple(kws), r_max=3))
    closer = threading.Thread(target=batcher.close)
    closer.start()
    time.sleep(0.05)
    assert not fut.done()
    release.set()
    closer.join(timeout=60)
    assert not closer.is_alive()
    assert fut.result(timeout=60).n_cns > 0
    pool.shutdown()
    with pytest.raises(ValueError, match="max_workers"):
        FlushPool(max_workers=0)


# -- Gateway -----------------------------------------------------------------

def _two_tenant_gateway(window_ms=20.0, ttl_s=60.0, max_inflight=64, **cfg):
    sa, kws = _crafted_schema(seed=0)
    sb, _ = _crafted_schema(seed=1)
    reg = _registry(total_cache_entries=64)
    reg.register("a", schema_from_reference(sa))
    reg.register("b", schema_from_reference(sb))
    gw = Gateway(reg, GatewayConfig(batch_window_ms=window_ms,
                                    result_cache_ttl_s=ttl_s,
                                    max_inflight=max_inflight, **cfg))
    return gw, reg, kws


def test_gateway_result_cache_hits_skip_engine_and_advertise_policy():
    gw, reg, kws = _two_tenant_gateway()
    req = FCTRequest(keywords=tuple(kws), r_max=3)
    miss = gw.query("a", req)
    assert not miss.cache_hit and miss.accum_policy == "int32-checked"
    assert gw.stats()["a"]["accum_policy"] == "int32-checked"
    engine = reg.session("a").engine
    before = (engine.batches_run, engine.cache.traces)
    hit = gw.query("a", req)
    assert hit.cache_hit and not hit.cold
    assert hit.accum_policy == miss.accum_policy
    assert (engine.batches_run, engine.cache.traces) == before
    np.testing.assert_array_equal(hit.all_freqs, miss.all_freqs)
    assert hit.engine_stats == {k: 0 for k in miss.engine_stats}
    want = miss.all_freqs.copy()
    hit.all_freqs[:] = -1
    miss.all_freqs[:] = -1
    again = gw.query("a", req)
    assert again.cache_hit
    np.testing.assert_array_equal(again.all_freqs, want)
    gw.close()


def test_gateway_topk_sliced_from_cached_histogram():
    gw, reg, kws = _two_tenant_gateway()
    full = gw.query("a", FCTRequest(keywords=tuple(kws), r_max=3, top_k=10))
    small = gw.query("a", FCTRequest(keywords=tuple(kws), r_max=3, top_k=3))
    assert small.cache_hit and len(small.term_ids) == 3
    np.testing.assert_array_equal(small.term_ids, full.term_ids[:3])
    perm = gw.query("a", FCTRequest(keywords=tuple(reversed(kws)), r_max=3))
    assert perm.cache_hit
    np.testing.assert_array_equal(perm.all_freqs, full.all_freqs)
    gw.close()


def test_gateway_tenant_isolation_and_invalidation():
    gw, reg, kws = _two_tenant_gateway()
    req = FCTRequest(keywords=tuple(kws), r_max=3)
    assert not gw.query("a", req).cache_hit
    assert not gw.query("b", req).cache_hit
    sa, sb = reg.session("a"), reg.session("b")
    assert sa.engine is not sb.engine
    assert len(sa.store) > 0
    assert gw.invalidate("a") == 1
    assert len(sa.store) == 0 and sa.stats()["tuple_set_entries"] == 0
    again = gw.query("a", req)
    assert not again.cache_hit and again.engine_stats["store_uploads"] > 0
    assert gw.query("b", req).cache_hit
    with pytest.raises(KeyError, match="unknown"):
        gw.invalidate("zzz")
    st = gw.stats()
    assert st["gateway"]["tenants"] == 2
    assert st["a"]["result_invalidations"] == 1 and st["b"]["result_hits"] == 1
    gw.close()
    with pytest.raises(RuntimeError, match="closed"):
        gw.submit("a", req)


def test_gateway_rejects_bad_requests_synchronously():
    gw, reg, kws = _two_tenant_gateway()
    with pytest.raises(KeyError, match="unknown schema"):
        gw.submit("nope", FCTRequest(keywords=tuple(kws), r_max=3))
    with pytest.raises(ValueError, match="tokenizer"):
        gw.submit("a", FCTRequest(keywords=("string-kw",), r_max=3))
    st = gw.stats()["gateway"]
    assert st["submitted"] == 0 and st["rejected"] == 2
    gw.close()
    for bad in (dict(batch_window_ms=-2), dict(result_cache_ttl_s=-1),
                dict(result_cache_entries=0), dict(max_inflight=0),
                dict(max_inflight_per_tenant=0), dict(flush_workers=0),
                dict(flush_workers=-1),
                dict(append_policy="keep")):
        with pytest.raises(ValueError):
            GatewayConfig(**bad)


def test_gateway_backpressure_bounds_inflight():
    gw, reg, kws = _two_tenant_gateway(window_ms=400.0, ttl_s=0,
                                       max_inflight=2)
    reqs = [FCTRequest(keywords=tuple(kws), r_max=3, salt=i)
            for i in range(4)]
    order, done = [], threading.Event()

    def feeder():
        futs = [gw.submit("a", r) for r in reqs]   # blocks past 2 in flight
        order.append("submitted")
        [f.result(timeout=300) for f in futs]
        done.set()

    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    time.sleep(0.05)
    assert "submitted" not in order, "max_inflight=2 admitted 4 requests"
    assert done.wait(timeout=300), "backpressure deadlocked"
    t.join()
    gw.close()


def test_gateway_coalesces_identical_inflight_queries():
    gw, reg, kws = _two_tenant_gateway(window_ms=60.0, ttl_s=0)
    reqs = [FCTRequest(keywords=tuple(kws), r_max=3, top_k=10),
            FCTRequest(keywords=tuple(reversed(kws)), r_max=3, top_k=10),
            FCTRequest(keywords=tuple(kws), r_max=3, top_k=3)]
    leader, perm, small = [f.result(timeout=300)
                           for f in [gw.submit("a", r) for r in reqs]]
    assert not leader.coalesced and not leader.cache_hit
    assert perm.coalesced and small.coalesced and not perm.cache_hit
    np.testing.assert_array_equal(perm.all_freqs, leader.all_freqs)
    np.testing.assert_array_equal(small.term_ids, leader.term_ids[:3])
    st = gw.stats()
    assert st["a"]["coalesced"] == 2 and st["a"]["queries_served"] == 1
    perm.all_freqs[:] = -1
    np.testing.assert_array_equal(small.all_freqs, leader.all_freqs)
    gw.close()


def test_gateway_coalesced_followers_bypass_admission():
    gw, reg, kws = _two_tenant_gateway(window_ms=50.0, ttl_s=0,
                                       max_inflight=1)
    req = FCTRequest(keywords=tuple(kws), r_max=3)
    got = [f.result(timeout=300) for f in [gw.submit("a", req)
                                            for _ in range(3)]]
    assert [r.coalesced for r in got] == [False, True, True]
    gw.close()


def test_gateway_per_tenant_admission_bounds():
    gw, reg, kws = _two_tenant_gateway(window_ms=400.0, ttl_s=0,
                                       max_inflight_per_tenant=1)
    a_futs, a_state, done = [], [], threading.Event()

    def feeder():
        for salt in (0, 1):
            a_futs.append(gw.submit("a", FCTRequest(keywords=tuple(kws),
                                                    r_max=3, salt=salt)))
            a_state.append(salt)
        done.set()

    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    time.sleep(0.05)
    assert a_state == [0], "per-tenant bound admitted a second request"
    rb = gw.query("b", FCTRequest(keywords=tuple(kws), r_max=3), timeout=300)
    assert rb.n_cns > 0                        # b is not starved by a
    assert done.wait(timeout=300)
    [f.result(timeout=300) for f in a_futs]
    t.join()
    gw.close()


def test_gateway_invalidate_fences_inflight_coalescing():
    gw, reg, kws = _two_tenant_gateway(window_ms=150.0, ttl_s=60.0)
    req = FCTRequest(keywords=tuple(kws), r_max=3)
    leader = gw.submit("a", req)
    gw.invalidate("a")
    repeat = gw.submit("a", req)
    r_leader, r_repeat = leader.result(timeout=300), repeat.result(timeout=300)
    assert not r_repeat.coalesced and not r_repeat.cache_hit
    assert gw.stats()["a"]["coalesced"] == 0
    np.testing.assert_array_equal(r_leader.all_freqs, r_repeat.all_freqs)
    assert gw.stats()["a"]["result_entries"] == 1
    gw.close()


def test_gateway_mixed_tenants_concurrent_batches():
    gw, reg, kws = _two_tenant_gateway(window_ms=30.0, ttl_s=0)
    futs = []
    for i in range(3):
        for t in ("a", "b"):
            futs.append((t, gw.submit(t, FCTRequest(keywords=tuple(kws),
                                                    r_max=3, salt=i))))
    responses = [(t, f.result(timeout=300)) for t, f in futs]
    st = gw.stats()
    for tenant in ("a", "b"):
        assert st[tenant]["max_window_queries"] >= 2
    fa = [r.all_freqs for t, r in responses if t == "a"]
    fb = [r.all_freqs for t, r in responses if t == "b"]
    assert not np.array_equal(fa[0], fb[0])
    gw.close()


def test_fct_serve_smoke_on_cpu():
    from repro_torch.launch import fct_serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fct_serve.main(["--smoke", "--device", "cpu", "--workers", "2"])
    text = out.getvalue()
    assert text.rstrip().endswith("SMOKE OK"), text[-2000:]
    assert "on cpu x 2 workers" in text and "obs self-check" in text
