"""The cells of the P 8 adaptive deployment and of the pipelined client, on
the CPU at tiny sizes: their runs come out correct, an altered count is
caught, the client that keeps futures in flight refuses a window that
never held them, and the four readers of the shuffle's shape read the
program's spans and counters (and nothing where the program has none)."""
import time
import types
from concurrent.futures import Future

import pytest
import torch

from bench import harness
from bench.tests import _tiny

P8 = ("tpch_sf1_zipf1_p8.warm", "tpch_sf1_zipf1_p8")
DEPTH8 = ("tpch_sf1_uniform.submit_depth8", "tpch_sf1_uniform")
COLD_READERS = ("planner.schedule_ms.cold", "planner.row_imbalance.cold",
                "planner.dim_replication.cold")
NEW = COLD_READERS + ("engine.route_padding.warm",)


@pytest.mark.parametrize("cell,name", [P8, DEPTH8])
def test_new_cell_runs_correct(cell, name):
    rc, res, err = _tiny.run_cell(cell, _tiny.config(name))
    assert rc == 0, err
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] > 0
    e2e = {m["name"] for m in harness.metric_entries(harness.load_spec(),
                                                      cell, False)}
    assert e2e == {"queries_per_s", "setup_s"} == set(res["metrics"])
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_p8_cell_plans_for_8_workers_in_adaptive_mode():
    from bench import port
    cell, cfg, traffic = harness.find_cell(harness.load_spec(), P8[0])
    assert cfg["workers"] == 8 and cfg["reduced"] == []
    conf = port.session_config(cfg, traffic)
    assert conf.adaptive_rho is True and conf.accum_policy == "int32"


def test_an_altered_count_is_caught_at_p8(monkeypatch):
    from repro_torch.api.session import FCTSession
    finish = FCTSession._finish

    def altered(self, planned, freq, *a, **k):
        freq = freq.copy()
        freq[1] += 1
        return finish(self, planned, freq, *a, **k)

    monkeypatch.setattr(FCTSession, "_finish", altered)
    rc, res, _ = _tiny.run_cell(P8[0], _tiny.config(P8[1]))
    assert rc == 0
    assert res["correct"] is False
    assert res["checks"]["bins_wrong"]["value"] >= 1
    assert res["checks"]["topk_wrong"]["value"] >= 1


def test_pipelined_window_keeps_its_depth_and_submission_order(monkeypatch):
    """Answers come back in the order they were submitted, each timed from
    its submit, and the window held 8 futures unresolved at once."""
    from repro_torch.api.session import FCTSession
    submit = FCTSession.submit
    order, live, most = [], [], [0]

    def watched(self, req):
        fut = submit(self, req)
        order.append((req.keywords, req.top_k))
        live.append(fut)
        most[0] = max(most[0], sum(not f.done() for f in live))
        return fut

    monkeypatch.setattr(FCTSession, "submit", watched)
    run = _tiny_run(*DEPTH8)
    assert most[0] == 8
    got = [(run.pool[i], k) for i, k, _, _ in run.answers]
    assert got == order[:len(got)] and len(got) == run.attempted
    assert all(ms > 0 for *_, ms in run.answers)


def test_a_window_that_never_fills_raises(monkeypatch):
    """A session whose futures resolve at once never has 8 in flight: the
    run raises before it prints a result."""
    from repro_torch.api.session import FCTSession

    def resolved(self, req):
        fut = Future()
        fut.set_result(self.query(req))
        return fut

    monkeypatch.setattr(FCTSession, "submit", resolved)
    with pytest.raises(RuntimeError, match="in flight"):
        _tiny.run_cell(DEPTH8[0], _tiny.config(DEPTH8[1]))


def _tiny_run(cell, name):
    """Set-up, window, finish and reference of one cell on the CPU, as
    ``bench/run.py`` runs them (untraced: ``DeviceTrace`` needs CUDA)."""
    c, _, traffic = harness.find_cell(harness.load_spec(), cell)
    run = harness.Run(cell=c, config=_tiny.config(name), traffic=traffic,
                      seed=_tiny.SEED, seconds=1.0, trace=False,
                      device=torch.device("cpu"),
                      t_start=time.perf_counter())
    client = harness.client(traffic["client"])
    client.setup(run)
    client.window(run)
    client.finish(run)
    client.reference(run)
    return run


@pytest.mark.parametrize("cell,name,want", [
    P8 + (NEW,),
    ("tpch_sf1_uniform.warm", "tpch_sf1_uniform",
     ("engine.route_padding.warm",)),
    ("tpch_sf1_zipf1.warm", "tpch_sf1_zipf1", ("engine.route_padding.warm",))])
def test_new_readers_read_a_tiny_run(cell, name, want):
    spec = harness.load_spec()
    got = harness.read_metrics(harness.metric_entries(spec, cell, True),
                               _tiny_run(cell, name))
    assert set(got) & set(NEW) == set(want)
    for metric in want:
        assert got[metric]["value"] > 0, metric
    assert got["engine.route_padding.warm"]["value"] >= 1.0
    if cell == P8[0]:
        assert 1.0 <= got["planner.row_imbalance.cold"]["value"] <= 8.0
        assert got["planner.dim_replication.cold"]["value"] > 1.0


def _span(name, ms, **args):
    return types.SimpleNamespace(name=name, dur_ns=int(ms * 1e6), args=args)


def _resp(spans=(), stats=None):
    trace = types.SimpleNamespace(spans=lambda: list(spans))
    return types.SimpleNamespace(trace=trace if spans else None,
                                 engine_stats=dict(stats or {}))


def _run(setup=(), answers=()):
    return types.SimpleNamespace(
        setup_answers=[(i, 5, r) for i, r in setup],
        answers=[(i, 5, r, 1.0) for i, r in answers])


def test_cold_readers_read_each_sets_first_answer():
    plan = "plan.cn_plan"
    first0 = _resp([_span("plan.schedule", 2.0), _span("plan.schedule", 1.0),
                    _span(plan, 9.0, fact_rows=300, row_imbalance=1.2,
                          dim_rows=10, dim_sent=40),
                    _span(plan, 1.0, fact_rows=100, row_imbalance=2.0,
                          dim_rows=30, dim_sent=40),
                    _span(plan, 1.0, n_rel=1, fact_rows=0, shuffle_rows=0)])
    later0 = _resp([_span("plan.schedule", 50.0),
                    _span(plan, 9.0, fact_rows=10 ** 6, row_imbalance=8.0,
                          dim_rows=1, dim_sent=8)])
    first1 = _resp([_span("plan", 1.0)])          # a plan-cache hit
    run = _run(setup=[(0, first0), (0, later0), (1, first1)])
    read = {n: harness.reader(n) for n in COLD_READERS}
    assert read["planner.schedule_ms.cold"](run) == pytest.approx(3.0 / 2)
    assert read["planner.row_imbalance.cold"](run) == pytest.approx(
        (1.2 * 300 + 2.0 * 100) / 400)
    assert read["planner.dim_replication.cold"](run) == pytest.approx(
        80 / 40)
    # a program without the new span and args: nothing to read
    parent = _run(setup=[(0, _resp([_span(plan, 9.0, n_rel=3, fact_rows=5,
                                          shuffle_rows=9)]))])
    for name in COLD_READERS:
        assert read[name](parent) is None
        assert read[name](_run()) is None


def test_route_padding_reads_slots_over_rows():
    read = harness.reader("engine.route_padding.warm")
    run = _run(answers=[(0, _resp(stats={"route_slots": 64,
                                         "route_rows": 40})),
                        (1, _resp(stats={"route_slots": 16,
                                         "route_rows": 10}))])
    assert read(run) == pytest.approx(80 / 50)
    parent = _run(answers=[(0, _resp(stats={"fct_count_tokens": 9}))])
    assert read(parent) is None
    assert read(_run()) is None
    assert read(_run(answers=[(0, _resp(stats={"route_slots": 8,
                                               "route_rows": 0}))])) is None
