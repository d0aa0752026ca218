"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``): the same observations give the same bucket
counts, percentiles, labeled snapshots, span records, Chrome-trace
documents and JSON-lines lines, exactly (both sides compute every float
from the same integers and floats).  Then the behaviour of
``tests/test_obs.py`` on the port: registry thread safety, ``le`` bucket
math, snapshot aggregation, label isolation, span nesting on the sync and
pipelined session paths, and the export sinks."""
import json
import threading

import numpy as np
import pytest

from repro import obs as jax_obs
from repro_torch import obs
from repro_torch.api import FCTRequest, FCTSession, SessionConfig
from repro_torch.data.schema import schema_from_reference
from repro_torch.obs import (JsonLinesReporter, MetricsRegistry, Trace,
                             chrome_trace, current_trace, render_key, span,
                             write_chrome_trace)
from test_engine import _crafted_schema

TIMING_KEYS = {"plan_ms", "dispatch_ms", "collect_ms", "finalize_ms",
               "execute_ms", "total_ms"}


def _fill(mod, values):
    """One registry of ``mod`` fed the same observations: every instrument
    kind, labels, a merged key, a max gauge and a callback gauge."""
    m = mod.MetricsRegistry()
    a = m.labeled(schema="a")
    b = m.labeled(schema="b").labeled(stage="plan")
    lat_a = a.histogram("gateway.query_latency_ms")
    lat_b = b.histogram("gateway.query_latency_ms")
    occ = a.histogram("batcher.window_queries", buckets=mod.OCCUPANCY_BUCKETS)
    for i, v in enumerate(values):
        (lat_a if i % 3 else lat_b).observe(float(v))
        occ.observe(float(1 + i % 9))
    m.counter("c").inc(2)
    m.counter("c").inc(5)
    a.counter("result_cache.hits").inc(7)
    m.gauge("depth").add(3)
    m.gauge("depth").add(-1)
    peak = a.gauge("peak", agg="max")
    peak.set_max(4)
    peak.set_max(2)
    a.gauge("peak", agg="max").set(9)
    m.gauge_fn("resident_bytes", lambda: 42, schema="a")
    h = m.histogram("h", buckets=(1.0, 2.0, 4.0, 8.0))
    for v in (0.5, 1.0, 1.5, 3.0, 8.0, 100.0):
        h.observe(v)
    return m, lat_a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshots_equal_the_reference(seed):
    values = np.random.default_rng(seed).lognormal(1.0, 2.0, 500)
    mine, lat = _fill(obs, values)
    ref, ref_lat = _fill(jax_obs, values)
    assert obs.LATENCY_BUCKETS_MS == jax_obs.LATENCY_BUCKETS_MS
    assert obs.OCCUPANCY_BUCKETS == jax_obs.OCCUPANCY_BUCKETS
    assert mine.snapshot() == ref.snapshot()
    for labels in ({"schema": "a"}, {"schema": "b", "stage": "plan"}, None):
        assert mine.snapshot(labels=labels) == ref.snapshot(labels=labels)
    for p in (0.0, 10.0, 50.0, 95.0, 99.0, 100.0):
        assert lat.percentile(p) == ref_lat.percentile(p)
    assert lat.count == ref_lat.count


def _span_tree(mod, request_id):
    tr = mod.Trace(request_id=request_id)
    with tr.activate():
        with mod.span("plan", n=2):
            with mod.span("inner"):
                pass
        with mod.span("dispatch"):
            pass
    tr.add_span("collect", tr.t0_ns + 5, 7, shared=False)
    return tr


def _strip_clock(events):
    """Span timestamps and thread ids differ between two runs; names,
    nesting, argument values and event kinds must not."""
    out = []
    for e in events:
        e = dict(e)
        for k in ("ts", "dur", "tid", "t0_us", "dur_us", "thread_id"):
            e.pop(k, None)
        out.append(e)
    return out


def test_trace_records_and_chrome_documents_match_the_reference():
    mine, ref = _span_tree(obs, "q7"), _span_tree(jax_obs, "q7")
    assert mine.span_names() == ref.span_names()
    assert _strip_clock(mine.records()) == _strip_clock(ref.records())
    assert (_strip_clock(mine.chrome_events())
            == _strip_clock(ref.chrome_events()))
    doc, ref_doc = chrome_trace([mine, None]), jax_obs.chrome_trace([ref])
    assert doc["displayTimeUnit"] == ref_doc["displayTimeUnit"]
    assert (_strip_clock(doc["traceEvents"])
            == _strip_clock(ref_doc["traceEvents"]))


def test_json_lines_reporter_matches_the_reference(tmp_path):
    lines = {}
    for name, mod in (("mine", obs), ("ref", jax_obs)):
        m, _ = _fill(mod, [1.0, 2.0, 300.0])
        out = tmp_path / f"{name}.jsonl"
        rep = mod.JsonLinesReporter(m, str(out), interval_s=3600.0)
        rep.close()
        rep.close()                           # idempotent
        lines[name] = [json.loads(x) for x in out.read_text().splitlines()]
    assert [x["metrics"] for x in lines["mine"]] == \
        [x["metrics"] for x in lines["ref"]]
    assert all("ts" in x for x in lines["mine"])


# -- behaviour of tests/test_obs.py on the port --------------------------------

def test_counter_gauge_basics():
    m = MetricsRegistry()
    c = m.counter("x.count")
    c.inc()
    c.inc(4)
    assert c.value == 5
    c.reset()
    assert c.value == 0
    g = m.gauge("x.depth")
    assert g.add(3) == 3
    assert g.add(-1) == 2
    g.set_max(7)
    g.set_max(5)
    assert g.value == 7
    g.set(1)
    assert g.value == 1


def test_registry_thread_safety_under_concurrent_bumps():
    m = MetricsRegistry()
    c, g = m.counter("c"), m.gauge("g")
    h = m.histogram("h", buckets=(1.0, 10.0, 100.0))
    n_threads, n_iter = 8, 2000

    def worker():
        for i in range(n_iter):
            c.inc()
            g.add(1)
            g.add(-1)
            h.observe(float(i % 50))

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == n_threads * n_iter and g.value == 0
    assert h.count == n_threads * n_iter
    snap = m.snapshot()
    assert snap["counters"]["c"] == n_threads * n_iter
    assert snap["histograms"]["h"]["count"] == n_threads * n_iter


def test_histogram_bucket_math_le_semantics():
    m = MetricsRegistry()
    h = m.histogram("lat", buckets=(1.0, 2.0, 4.0, 8.0))
    for v in (0.5, 1.0, 1.5, 3.0, 8.0, 100.0):
        h.observe(v)
    snap = m.snapshot()["histograms"]["lat"]
    assert snap["buckets"] == {"1.0": 2, "2.0": 1, "4.0": 1, "8.0": 1,
                               "+inf": 1}
    assert snap["count"] == 6 and snap["sum"] == pytest.approx(114.0)
    assert 0.0 < snap["p50"] <= 2.0
    assert snap["p50"] <= snap["p95"] <= snap["p99"]
    assert h.percentile(10.0) <= 1.0


def test_histogram_and_gauge_reject_bad_arguments():
    with pytest.raises(ValueError):
        MetricsRegistry().histogram("h", buckets=())
    with pytest.raises(ValueError):
        MetricsRegistry().gauge("g", agg="median")


def test_labeled_registry_isolates_tenants():
    m = MetricsRegistry()
    a, b = m.labeled(schema="a"), m.labeled(schema="b")
    a.counter("q.served").inc(7)
    b.counter("q.served").inc(2)
    a.histogram("lat_ms", buckets=(1.0, 10.0)).observe(0.5)
    snap = m.snapshot()
    assert snap["counters"]["q.served{schema=a}"] == 7
    assert snap["counters"]["q.served{schema=b}"] == 2
    assert "lat_ms{schema=a}" in snap["histograms"]
    only_a = m.snapshot(labels={"schema": "a"})
    assert "q.served{schema=b}" not in only_a["counters"]
    assert render_key("n", {"b": 1, "a": 2}) == "n{a=2,b=1}"
    a.labeled(stage="plan").counter("n").inc()
    assert m.snapshot()["counters"]["n{schema=a,stage=plan}"] == 1


def test_gauge_fn_evaluated_outside_lock():
    m = MetricsRegistry()

    def resident():
        with m._lock:          # would deadlock if snapshot held the lock
            return 42

    m.gauge_fn("resident_bytes", resident, schema="a")
    assert m.snapshot()["gauges"]["resident_bytes{schema=a}"] == 42


def test_span_nesting_and_noop_without_trace():
    tr = Trace(request_id="q1")
    with tr.activate():
        assert current_trace() is tr
        with span("plan", n=2) as outer:
            with span("inner"):
                pass
        with span("dispatch"):
            pass
    assert current_trace() is None
    by_name = {s.name: s for s in tr.spans()}
    assert tr.span_names() == ["plan", "inner", "dispatch"]
    assert by_name["inner"].parent_id == by_name["plan"].span_id
    assert by_name["plan"].parent_id == by_name["dispatch"].parent_id == 0
    assert outer.args == {"n": 2}
    with span("orphan") as s:
        s.args["x"] = 1
    assert current_trace() is None


def test_add_span_records_from_foreign_threads():
    tr = Trace()
    barrier = threading.Barrier(4, timeout=60)

    def worker(i):
        barrier.wait()
        tr.add_span("stage", 1000 * i, 10, idx=i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = tr.spans()
    assert [s.args["idx"] for s in spans] == [0, 1, 2, 3]
    assert len({s.thread_id for s in spans}) == 4


def test_write_chrome_trace(tmp_path):
    tr = Trace()
    with tr.activate():
        with span("plan"):
            pass
    out = tmp_path / "trace.json"
    assert write_chrome_trace(str(out), [tr]) >= 1
    events = json.loads(out.read_text())["traceEvents"]
    assert any(e["ph"] == "M" for e in events)
    assert all({"pid", "tid", "ts", "dur"} <= set(e) for e in events
               if e["ph"] == "X")


def test_sync_and_pipelined_paths_share_span_and_timing_shape():
    sj, kws = _crafted_schema(seed=0)
    session = FCTSession(schema_from_reference(sj), device="cpu",
                         metrics=MetricsRegistry())
    stage = {"plan", "dispatch", "collect", "finalize"}
    sync = session.query(FCTRequest(keywords=tuple(kws), r_max=3))
    assert set(sync.timings) == TIMING_KEYS
    assert stage <= set(sync.trace.span_names())
    futs = [session.submit(FCTRequest(keywords=tuple(kws), r_max=3, salt=s))
            for s in (1, 2, 3)]
    for fut in futs:
        resp = fut.result(timeout=300)
        assert set(resp.timings) == TIMING_KEYS
        spans = {s.name: s for s in resp.trace.spans() if s.name in stage}
        assert set(spans) == stage
        assert (spans["plan"].t0_ns <= spans["dispatch"].t0_ns
                <= spans["collect"].t0_ns <= spans["finalize"].t0_ns)
    assert len({f.result().trace.request_id for f in futs}) == 3
    session.close()


def test_session_metrics_snapshot_counts_queries():
    sj, kws = _crafted_schema(seed=0)
    m = MetricsRegistry()
    session = FCTSession(schema_from_reference(sj), device="cpu", metrics=m,
                         config=SessionConfig(cache_max_entries=8))
    for _ in range(2):
        session.query(FCTRequest(keywords=tuple(kws), r_max=3))
    snap = m.snapshot()
    assert snap["counters"]["session.queries_served"] == 2
    assert snap["counters"]["engine.batches_run"] >= 1
    assert snap["counters"]["engine.bytes_shipped"] > 0
    assert snap["counters"]["store.uploads"] >= 1
    session.close()


def test_json_lines_reporter(tmp_path):
    m = MetricsRegistry()
    c = m.counter("r.count")
    out = tmp_path / "metrics.jsonl"
    rep = JsonLinesReporter(m, str(out), interval_s=3600.0)
    c.inc(5)
    rep.close()
    last = json.loads(out.read_text().splitlines()[-1])
    assert last["metrics"]["counters"]["r.count"] == 5 and "ts" in last
