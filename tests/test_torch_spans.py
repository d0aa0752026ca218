"""The port's spans, stage timers and counters inside the engine, planner
and append paths (``repro_torch.obs`` fed by ``runtime/engine.py``,
``core/fct.py``, ``api/session.py`` and ``serve/gateway.py``), on the CPU:

* each ``engine.dispatch_group`` of a warm query, or of a storeless call,
  holds ``store.group_args``, ``engine.upload`` and ``fct.route`` /
  ``fct.mr1`` / ``fct.mr2``, each inside its parent's interval, and says
  whether it built its program; the cold query's ``store.group_args`` ship
  send tables and the warm query's ship none;
* a cold ``plan`` holds ``plan.tuple_sets``, ``plan.cns``, ``plan.cn_plan``
  and ``plan.map_only``; a plan-cache hit holds none;
* an append's trace (``AppendResult.trace``) holds ``session.append``,
  ``session.delta_freq`` and ``gateway.patch``, and the gateway's three
  append counters equal the sums of those spans exactly;
* ``engine.fct_count_tokens`` equals the token slots every path hands to
  ``weighted_histogram``;
* under a CPU ``torch.profiler``, every ``span()`` has a profiler range of
  its name starting where the span starts, once the two clocks are tied by
  one mark, as ``bench/devtrace.py`` ties them;
* the device-stage times are absent off CUDA (the card's test is in
  ``tests/test_torch_cuda.py``).
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.api import FCTRequest, FCTSession, SessionConfig
from repro_torch.core import fct as core_fct
from repro_torch.data.schema import schema_from_reference
from repro_torch.obs import MetricsRegistry, Trace, span
from repro_torch.runtime import engine as engine_mod
from repro_torch.runtime.cache import ExecutableCache
from repro_torch.serve import Gateway, GatewayConfig, SchemaRegistry
from test_ingest import KWS, make_batch, make_schema

ENGINE_CHILDREN = {"engine.upload", "fct.route", "fct.mr1", "fct.mr2"}
PLAN_CHILDREN = {"plan.tuple_sets", "plan.cns", "plan.cn_plan",
                 "plan.map_only"}
#: spans recorded after the fact (``Trace.add_span``), not by ``span()``
ADDED_AFTER = {"dispatch", "collect", "finalize"}


def _session(**config):
    # an engine of its own: whether the cold query builds its programs
    # must not depend on what earlier tests left in the process-wide cache
    m = MetricsRegistry()
    return FCTSession(schema_from_reference(make_schema(5, m=2,
                                                        fact_rows=24)),
                      device="cpu", metrics=m,
                      engine=engine_mod.FCTEngine(cache=ExecutableCache(),
                                                  metrics=m),
                      config=SessionConfig(**config))


def _req(**kw):
    return FCTRequest(**{"keywords": KWS, "r_max": 3, "top_k": 5, **kw})


def _children(spans, parent):
    return [s for s in spans if s.parent_id == parent.span_id]


def _inside(child, parent):
    return (parent.t0_ns <= child.t0_ns
            and child.t0_ns + child.dur_ns <= parent.t0_ns + parent.dur_ns)


def _check_groups(spans, first_child):
    groups = [s for s in spans if s.name == "engine.dispatch_group"]
    assert groups
    for g in groups:
        kids = _children(spans, g)
        names = [k.name for k in kids]
        assert names[0] == first_child
        assert set(names) == {first_child} | ENGINE_CHILDREN
        assert all(_inside(k, g) for k in kids)
        assert isinstance(g.args["built"], bool)
        for k in kids:
            if k.name.startswith("fct."):
                assert k.args["n_cns"] >= 1 and k.args["rows"] >= 1
    return groups


def test_warm_query_splits_each_dispatch_group():
    """Store path: every group's children in order, inside the group."""
    session = _session()
    cold = session.query(_req())
    warm = session.query(_req())
    spans = warm.trace.spans()
    groups = _check_groups(spans, "store.group_args")
    assert not any(g.args["built"] for g in groups)
    assert any(g.args["built"] for g in cold.trace.spans()
               if g.name == "engine.dispatch_group")
    # the cold query's groups ship their send tables, inside
    # store.group_args; the warm query's find them on the device and ship 0
    cold_spans = cold.trace.spans()
    for trace_spans, warm_query in ((cold_spans, False), (spans, True)):
        args = [s.args for s in trace_spans if s.name == "store.group_args"]
        assert args and all(a["n_stack"] >= 1 for a in args)
        if warm_query:
            assert all(a["send_bytes"] == 0 and a["send_hits"] >= 1
                       for a in args)
        else:
            assert all(a["send_bytes"] > 0 for a in args)
        assert all(s.args["bytes"] == 0 for s in trace_spans
                   if s.name == "engine.upload")
    # cold uploads the columns inside store.group_args
    ids = {s.span_id: s for s in cold_spans}
    uploads = [s for s in cold_spans if s.name == "store.upload"]
    assert uploads and all(ids[u.parent_id].name == "store.group_args"
                           for u in uploads)
    session.close()


@pytest.mark.parametrize("individual", [False, True])
def test_storeless_groups_split_the_same_way(individual):
    """Storeless ``dispatch_plans`` on an active trace: the same children,
    the ``store.upload`` spans beneath ``store.group_args`` count the
    columns the call's own store uploads, and ``send_bytes`` the send
    tables it ships."""
    session = _session()
    plans = session._plan(_req()).plans
    eng = engine_mod.FCTEngine(cache=ExecutableCache(),
                               metrics=MetricsRegistry())
    tr = Trace()
    with tr.activate():
        pending = eng.dispatch_plans(plans, session.mesh,
                                     individual=individual)
    assert len(pending) >= 1
    spans = tr.spans()
    _check_groups(spans, "store.group_args")
    columns = sum(s.args["bytes"] for s in spans if s.name == "store.upload")
    assert columns == eng.metrics.snapshot()["counters"][
        "store.upload_bytes"] > 0
    shipped = sum(s.args["send_bytes"] for s in spans
                  if s.name == "store.group_args")
    assert shipped == eng.stats()["bytes_shipped"] > 0
    session.close()


def test_cold_plan_has_planner_children_and_a_hit_none():
    session = _session()
    cold = session.query(_req())
    spans = cold.trace.spans()
    plan, = [s for s in spans if s.name == "plan"]
    kids = _children(spans, plan)
    assert {k.name for k in kids} == PLAN_CHILDREN
    assert all(_inside(k, plan) for k in kids)
    cns, = [k for k in kids if k.name == "plan.cns"]
    n_plans = sum(k.name == "plan.cn_plan" for k in kids)
    n_map = sum(k.name == "plan.map_only" for k in kids)
    assert cns.args["n_cns"] == cold.n_cns == n_plans
    assert n_plans - n_map == cold.n_joined_cns
    for k in kids:
        if k.name == "plan.cn_plan":
            assert k.args["n_rel"] >= 1
            assert (k.args["fact_rows"] > 0) == (k.args["n_rel"] > 1)
    hit = session.query(_req(top_k=3))
    plan, = [s for s in hit.trace.spans() if s.name == "plan"]
    assert plan.args["plan_cached"] is True
    assert not any(s.name.startswith("plan.") for s in hit.trace.spans())
    session.close()


def _gateway(metrics):
    reg = SchemaRegistry(device="cpu")
    reg.register("t", schema_from_reference(make_schema(21)))
    return Gateway(reg, GatewayConfig(batch_window_ms=0.0,
                                      append_policy="patch"),
                   metrics=metrics), reg


def test_append_trace_holds_the_append_path():
    m = MetricsRegistry()
    gw, reg = _gateway(m)
    rng = np.random.default_rng(3)
    for req in (_req(), _req(mode="skew", rho=2),
                FCTRequest(keywords=KWS[:1], r_max=2, top_k=4)):
        gw.query("t", req)
    ar = gw.append("t", "F", make_batch(rng, reg.session("t").schema, "F", 4,
                                        new_term=True))
    spans = ar.trace.spans()
    root, = [s for s in spans if s.name == "gateway.append"]
    kids = _children(spans, root)
    # two cached entries share (keywords, r_max): one delta for both
    assert [k.name for k in kids] == ["session.append", "session.delta_freq",
                                      "session.delta_freq", "gateway.patch"]
    assert all(_inside(k, root) for k in kids)
    assert kids[-1].args["entries"] == 3
    assert kids[0].args["rows"] == 4
    beneath = [{s.name for s in _children(spans, d)} for d in kids[1:3]]
    assert all("plan.cn_plan" in names for names in beneath)
    assert any("engine.dispatch_group" in names for names in beneath)
    # the session alone returns a trace of its own
    sess = reg.session("t")
    own = sess.append("F", make_batch(rng, sess.schema, "F", 2))
    assert own.trace is not None and own.trace is not ar.trace
    assert own.trace.span_names() == ["session.append"]
    gw.close()
    reg.close()


def test_gateway_counters_equal_their_spans():
    m = MetricsRegistry()
    gw, reg = _gateway(m)
    rng = np.random.default_rng(4)
    gw.query("t", _req())
    want = {"appends": 0, "append_ns": 0, "delta_plan_ns": 0}
    for n in (3, 0, 2):
        ar = gw.append("t", "F", make_batch(rng, reg.session("t").schema,
                                            "F", n))
        spans = ar.trace.spans()
        deltas = {s.span_id for s in spans if s.name == "session.delta_freq"}
        want["appends"] += 1
        want["append_ns"] += sum(s.dur_ns for s in spans
                                 if s.name == "gateway.append")
        want["delta_plan_ns"] += sum(s.dur_ns for s in spans
                                     if s.name == "plan.cn_plan"
                                     and s.parent_id in deltas)
    assert want["delta_plan_ns"] > 0
    counters = m.snapshot()["counters"]
    for name, value in want.items():
        assert counters[f"gateway.{name}{{schema=t}}"] == value
    gw.close()
    reg.close()


@pytest.fixture
def counted_histograms(monkeypatch):
    """Token slots of every ``weighted_histogram`` call of the body."""
    seen = []
    orig = core_fct.weighted_histogram

    def counting(tokens, weights, vocab, *a, **k):
        seen.append(tokens.numel())
        return orig(tokens, weights, vocab, *a, **k)

    monkeypatch.setattr(core_fct, "weighted_histogram", counting)
    return seen


@pytest.mark.parametrize("path", ["query", "batch", "device_topk",
                                  "storeless"])
def test_fct_count_tokens_equal_the_launched_shapes(counted_histograms, path):
    session = _session(device_topk=path == "device_topk")
    before = session.stats()["fct_count_tokens"]
    if path == "batch":
        resps = session.query_batch([_req(), _req(mode="skew", rho=2)])
        stats = resps[0].engine_stats
    elif path == "storeless":
        plans = session._plan(_req()).plans
        session.engine.run_plans(plans, session.mesh)
        stats = {"fct_count_tokens": session.stats()["fct_count_tokens"]
                 - before}
    else:
        stats = session.query(_req()).engine_stats
    assert counted_histograms
    assert stats["fct_count_tokens"] == sum(counted_histograms)
    session.close()


def test_spans_open_profiler_ranges_on_its_clock():
    """Every ``span()`` of a query is a profiler range of its name, and
    its start, moved onto the profiler's clock by one mark, lies within
    200 µs of the range's start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    session = _session()
    session.query(_req())                  # builds: the profiled query won't
    assert engine_mod._profiler_range("x") is None      # not recording
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm.mark"):
            pass                           # the first range pays the setup
        mark_ns = time.perf_counter_ns()
        with torch.profiler.record_function("clock.mark"):
            pass
        resp = session.query(_req(top_k=3))
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    mark_us, = [e.time_range.start for e in events if e.name == "clock.mark"]
    shift_us = mark_us - mark_ns / 1e3
    starts = {}
    for e in events:
        starts.setdefault(e.name, []).append(e.time_range.start)
    spans = [s for s in resp.trace.spans() if s.name not in ADDED_AFTER]
    assert {s.name for s in spans} >= {"plan", "engine.dispatch_group",
                                       "store.group_args"} | ENGINE_CHILDREN
    for s in spans:
        assert s.name in starts, s.name
        placed = s.t0_ns / 1e3 + shift_us
        assert min(abs(t - placed) for t in starts[s.name]) < 200.0, s.name
    session.close()


def test_span_hook_sees_recorded_spans_and_is_restorable():
    from repro_torch.obs import set_span_hook
    calls = []

    class Ctx:
        def __exit__(self, *exc):
            calls.append("exit")

    def hook(name):
        calls.append(name)
        return Ctx()

    prev = set_span_hook(hook)
    try:
        with span("outside"):              # no active trace: not recorded
            pass
        tr = Trace()
        with tr.activate(), span("inside"):
            pass
    finally:
        replaced = set_span_hook(prev)
    assert calls == ["inside", "exit"]
    assert replaced is hook and prev is engine_mod._profiler_range


def test_device_stage_times_absent_off_cuda():
    session = _session()
    resp = session.query(_req())
    assert not set(engine_mod.DEVICE_STAGES) & set(resp.timings)
    assert session.engine.device_stage_ms([]) == {}
    session.close()
