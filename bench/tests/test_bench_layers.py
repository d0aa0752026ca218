"""The readers of the per-layer metrics that read the program's own spans,
stage timers and counters: on synthetic answers, with the cases where they
find nothing to read (a program without the spans, the CPU without CUDA
events), and on a tiny run of a warm cell and the ingest cell on the CPU."""
import time
import types

import pytest
import torch

from bench import harness
from bench.tests import _tiny

SPAN_READERS = {"engine.send_tables_ms.warm": ("store.group_args",),
                "engine.upload_ms.warm": ("engine.upload",),
                "engine.enqueue_ms.warm": ("fct.route", "fct.mr1",
                                           "fct.mr2")}
DEVICE_READERS = {"fct.route_device_ms.warm": "device_route_ms",
                  "fct.mr1_device_ms.warm": "device_mr1_ms",
                  "fct.mr2_device_ms.warm": "device_mr2_ms"}
PLANNER_READERS = {"planner.tuple_sets_ms.cold": "plan.tuple_sets",
                   "planner.cn_plans_ms.cold": "plan.cn_plan"}
GATEWAY_READERS = {"gateway.append_ms.ingest": "gateway.append_ns",
                   "gateway.delta_plan_ms.ingest": "gateway.delta_plan_ns"}
NEW = (list(SPAN_READERS) + list(DEVICE_READERS) + list(PLANNER_READERS)
       + list(GATEWAY_READERS) + ["fct_count_launch_padding"])


def _trace(spans):
    """A program trace holding ``(name, ms)`` spans, one after another."""
    from repro_torch.obs import Trace
    tr = Trace()
    t = tr.t0_ns
    for name, ms in spans:
        tr.add_span(name, t, int(ms * 1e6))
        t += int(ms * 1e6)
    return tr


def _resp(spans=(), timings=None, stats=None):
    return types.SimpleNamespace(trace=_trace(spans) if spans else None,
                                 timings=dict(timings or {}),
                                 engine_stats=dict(stats or {}))


def _run(answers=(), setup=(), reference=None, text_len=12):
    return types.SimpleNamespace(
        answers=[(i, 5, r, 1.0) for i, r in answers],
        setup_answers=[(i, 5, r) for i, r in setup],
        reference=reference or {}, config={"text_len": text_len})


@pytest.mark.parametrize("name", list(SPAN_READERS))
def test_span_readers_take_the_median_query_sum(name):
    read = harness.reader(name)
    spans = SPAN_READERS[name]
    per_query = [[(s, 1.0) for s in spans] * 2,     # 2 ms a span name
                 [(s, 3.0) for s in spans],
                 [(s, 0.5) for s in spans] + [("fct.other", 9.0)]]
    got = read(_run([(0, _resp(q)) for q in per_query]))
    assert got == pytest.approx(len(spans) * 2.0)
    # a query without the spans counts 0 beside queries that have them
    got = read(_run([(0, _resp(per_query[1])), (0, _resp([("plan", 4.0)])),
                     (0, _resp())]))
    assert got == pytest.approx(0.0)
    # nothing to read: no answer, no trace, or a program without the spans
    assert read(_run()) is None
    assert read(_run([(0, _resp()), (1, _resp([("plan", 2.0)]))])) is None


@pytest.mark.parametrize("name", list(DEVICE_READERS))
def test_device_stage_readers_take_the_median(name):
    read = harness.reader(name)
    key = DEVICE_READERS[name]
    got = read(_run([(0, _resp(timings={key: v, "dispatch_ms": 9.0}))
                     for v in (1.0, 4.0, 2.0)] + [(0, _resp())]))
    assert got == 2.0
    assert read(_run([(0, _resp(timings={"dispatch_ms": 1.0}))])) is None
    assert read(_run()) is None


def test_launch_padding_reads_slots_over_needed_tokens():
    read = harness.reader("fct_count_launch_padding")
    ref = {0: (None, {"weighted_rows": 10}), 1: (None, {"weighted_rows": 5})}
    run = _run([(0, _resp(stats={"fct_count_tokens": 600})),
                (1, _resp(stats={"fct_count_tokens": 300})),
                (1, _resp(stats={"fct_count_tokens": 300}))], reference=ref)
    assert read(run) == pytest.approx(1200 / ((10 + 5 + 5) * 12))
    parent = _run([(0, _resp(stats={"bytes_shipped": 1}))], reference=ref)
    assert read(parent) is None
    assert read(_run(reference=ref)) is None
    none_needed = {0: (None, {"weighted_rows": 0})}
    assert read(_run([(0, _resp(stats={"fct_count_tokens": 6}))],
                     reference=none_needed)) is None


@pytest.mark.parametrize("name", list(PLANNER_READERS))
def test_planner_readers_average_each_sets_first_answer(name):
    read = harness.reader(name)
    span = PLANNER_READERS[name]
    setup = [(0, _resp([("plan.cns", 1.0), (span, 2.0), (span, 4.0)])),
             (0, _resp([(span, 100.0)])),            # not the first of set 0
             (1, _resp([("plan.tuple_sets", 1.0), ("plan.cn_plan", 1.0)]))]
    other = 1.0
    assert read(_run(setup=setup)) == pytest.approx((6.0 + other) / 2)
    # a first answer whose plan was a hit counts 0 beside cold ones
    assert read(_run(setup=setup[:1] + [(1, _resp([("plan", 1.0)]))])) == \
        pytest.approx(6.0 / 2)
    assert read(_run(setup=[(0, _resp([("plan", 5.0)])),
                            (1, _resp())])) is None
    assert read(_run()) is None


@pytest.mark.parametrize("name", list(GATEWAY_READERS))
def test_gateway_readers_divide_process_totals(monkeypatch, name):
    import repro_torch.obs as obs
    read = harness.reader(name)
    m = obs.MetricsRegistry()
    monkeypatch.setattr(obs, "default_registry", lambda: m)
    assert read(_run()) is None                    # no counters
    lane = m.labeled(schema="t")
    appends, ns = lane.counter("gateway.appends"), lane.counter(
        GATEWAY_READERS[name])
    assert read(_run()) is None                    # no append yet
    appends.inc(3)
    ns.inc(9_000_000)
    m.labeled(schema="u").counter("gateway.appends").inc(1)
    m.counter(GATEWAY_READERS[name]).inc(3_000_000)
    assert read(_run()) == pytest.approx(12.0 / 4)


def _tiny_run(cell, name):
    """Set-up, window, finish and reference of one cell on the CPU, as
    ``bench/run.py`` runs them untraced (``DeviceTrace`` needs CUDA), then
    every per-layer metric of the cell (the gateway's counters are the
    process's totals, this run's appends among them)."""
    spec = harness.load_spec()
    c, _, traffic = harness.find_cell(spec, cell)
    run = harness.Run(cell=c, config=_tiny.config(name), traffic=traffic,
                      seed=_tiny.SEED, seconds=1.0, trace=False,
                      device=torch.device("cpu"),
                      t_start=time.perf_counter())
    client = harness.client(traffic["client"])
    client.setup(run)
    client.window(run)
    client.finish(run)
    client.reference(run)
    return harness.read_metrics(harness.metric_entries(spec, cell, True),
                                run)


@pytest.mark.parametrize("cell,name,want", [
    ("tpch_sf1_uniform.warm", "tpch_sf1_uniform",
     list(SPAN_READERS) + list(PLANNER_READERS)
     + ["fct_count_launch_padding"]),
    ("tpch_sf1_uniform.rf1_ingest", "tpch_sf1_uniform",
     list(PLANNER_READERS) + list(GATEWAY_READERS))])
def test_new_readers_read_a_tiny_run(cell, name, want):
    got = _tiny_run(cell, name)
    for metric in want:
        assert got[metric]["value"] > 0, metric
    # the device's stage times come from CUDA events alone
    assert not set(DEVICE_READERS) & set(got)
    assert set(got) & set(NEW) == set(want)
    if "fct_count_launch_padding" in got:
        assert got["fct_count_launch_padding"]["value"] >= 1.0
