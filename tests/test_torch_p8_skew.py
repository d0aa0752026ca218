"""Eight reduce workers in adaptive mode on a Zipf-skewed star, on the CPU.

The deployment of the benchmark's ``tpch_sf1_zipf1_p8`` configuration, at a
tiny size: LINEITEM's foreign keys Zipf z 1 (``bench/data/tpch.py``), and an
``FCTSession`` with ``n_workers=8`` and ``SessionConfig(adaptive_rho=True)``
(adaptive ρ, shares over the ρ·P task grid, LPT onto the workers).

* Every answer's ``all_freqs`` and top-k equal the plain reference's
  (``bench/reference/star.py``, plain torch) and the same session's at P 1,
  bit for bit.
* Adaptive's achieved row imbalance on the dominant CN is no worse than
  uniform mode's.
* The planner's ``plan.schedule`` span is there in adaptive mode and absent
  in uniform mode; ``plan.cn_plan`` carries the shuffle's shape.
* The engine's ``route_slots`` (gather slots launched) and ``route_rows``
  (rows the plans send): slots ≥ rows > 0; at P 1 without bucketing the two
  are equal.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import port  # noqa: E402
from bench.data import tpch  # noqa: E402
from bench.reference import star  # noqa: E402
from bench.tests import _tiny  # noqa: E402
from repro_torch.api import FCTSession, SessionConfig  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.runtime.cache import ExecutableCache  # noqa: E402
from repro_torch.runtime.engine import FCTEngine  # noqa: E402

CPU = torch.device("cpu")
SEED = _tiny.SEED
PLAN_ARGS = ("rho", "tasks", "row_imbalance", "dim_rows", "dim_sent")


@pytest.fixture(scope="module")
def star_data():
    """A tiny zipf1 star (0.2% of SF1), its schema and the pool's keyword
    sets."""
    cfg = _tiny.config("tpch_sf1_zipf1_p8")
    assert cfg["workers"] == 8 and cfg["foreign_keys"]["dist"] == "zipf"
    tables = tpch.generate(cfg, SEED, CPU)
    kws = cfg["planted"]["keywords"]
    return cfg, tables, port.star_schema(tables, cfg), [tuple(kws),
                                                        tuple(kws[:2])]


def _session(schema, n_workers, adaptive, engine=None):
    return FCTSession(schema, device=CPU, n_workers=n_workers,
                      engine=engine or FCTEngine(cache=ExecutableCache(),
                                                 metrics=MetricsRegistry()),
                      config=SessionConfig(accum_policy="int32",
                                           adaptive_rho=adaptive))


def _ask(session, keywords, k, r_max):
    return session.query(port.request(keywords, k, r_max))


def _cn_plan_spans(resp):
    return [s for s in resp.trace.spans() if s.name == "plan.cn_plan"
            and s.args["fact_rows"] > 0]


@pytest.mark.parametrize("k", [5, 20])
def test_p8_adaptive_equals_the_reference_and_p1(star_data, k):
    cfg, tables, schema, pool = star_data
    ref_tables = star.StarTables(tables, cfg["star"], CPU)
    with _session(schema, 8, True) as p8, _session(schema, 1, False) as p1:
        for kws in pool:
            freq, _ = star.fct(ref_tables, kws, cfg["r_max"], cfg["vocab"])
            ids, f = star.topk(freq, kws, k)
            a8, a1 = (_ask(s, kws, k, cfg["r_max"]) for s in (p8, p1))
            assert any(p.rho > 1 for p in p8._plan(
                port.request(kws, k, cfg["r_max"])).plans)
            for resp in (a8, a1):
                np.testing.assert_array_equal(resp.all_freqs, freq)
                np.testing.assert_array_equal(resp.term_ids, ids)
                np.testing.assert_array_equal(resp.freqs, f)


def test_adaptive_balances_the_dominant_cn_no_worse(star_data):
    cfg, _, schema, pool = star_data

    def dominant(session):
        plans = session._plan(port.request(pool[0], 5, cfg["r_max"])).plans
        return max(plans, key=lambda p: p.fact.ref.n_rows)

    with _session(schema, 8, True) as ad, _session(schema, 8, False) as un:
        a, u = dominant(ad), dominant(un)
    assert a.fact.ref.n_rows == u.fact.ref.n_rows
    assert a.rho > 1 and u.rho == 1
    assert a.row_imbalance <= u.row_imbalance


@pytest.mark.parametrize("adaptive", [True, False])
def test_schedule_span_only_where_a_schedule_is_computed(star_data,
                                                         adaptive):
    cfg, _, schema, pool = star_data
    with _session(schema, 8, adaptive) as s:
        resp = _ask(s, pool[0], 5, cfg["r_max"])
    spans = resp.trace.spans()
    schedules = [sp for sp in spans if sp.name == "plan.schedule"]
    plans = _cn_plan_spans(resp)
    assert plans
    if not adaptive:
        assert schedules == []
        return
    # one schedule a routed CN, beneath its plan.cn_plan
    assert len(schedules) == len(plans)
    parents = {sp.span_id for sp in plans}
    for sp in schedules:
        assert sp.parent_id in parents and sp.dur_ns > 0
        assert sp.args["mode"] == "adaptive" and sp.args["devices"] == 8
        assert sp.args["tasks"] >= 8


@pytest.mark.parametrize("adaptive", [True, False])
def test_cn_plan_span_carries_the_shuffle_shape(star_data, adaptive):
    cfg, _, schema, pool = star_data
    with _session(schema, 8, adaptive) as s:
        resp = _ask(s, pool[0], 5, cfg["r_max"])
        plans = s._plan(port.request(pool[0], 5, cfg["r_max"])).plans
    spans = _cn_plan_spans(resp)
    assert len(spans) == len(plans)
    for sp, plan in zip(spans, plans):
        assert set(PLAN_ARGS) <= set(sp.args)
        assert sp.args["rho"] == plan.rho
        assert sp.args["tasks"] == len(plan.schedule.task_to_device)
        assert sp.args["tasks"] == (8 * plan.rho if adaptive else 8)
        assert sp.args["row_imbalance"] == pytest.approx(plan.row_imbalance)
        assert 1.0 <= sp.args["row_imbalance"] <= 8.0
        assert sp.args["dim_rows"] == sum(plan.dims[i].ref.n_rows
                                          for i in plan.included)
        assert sp.args["dim_sent"] >= sp.args["dim_rows"] > 0


@pytest.mark.parametrize("n_workers,adaptive", [(8, True), (8, False),
                                                (1, False)])
def test_route_slots_cover_route_rows(star_data, n_workers, adaptive):
    cfg, _, schema, pool = star_data
    with _session(schema, n_workers, adaptive) as s:
        for kws in pool:
            resp = _ask(s, kws, 5, cfg["r_max"])
            st = resp.engine_stats
            planned = s._plan(port.request(kws, 5, cfg["r_max"]))
            assert st["route_rows"] == sum(p.shuffle_rows
                                           for p in planned.plans)
            assert st["route_slots"] >= st["route_rows"] > 0
    assert s.stats()["route_slots"] >= s.stats()["route_rows"] > 0


def test_route_slots_equal_route_rows_without_padding(star_data):
    """At P 1 a relation's send table holds exactly its routed rows; with
    the signature's buckets off nothing pads them."""
    cfg, _, schema, pool = star_data
    eng = FCTEngine(cache=ExecutableCache(), metrics=MetricsRegistry(),
                    bucket=False)
    with _session(schema, 1, False, engine=eng) as s:
        for kws in pool:
            st = _ask(s, kws, 5, cfg["r_max"]).engine_stats
            assert st["route_slots"] == st["route_rows"] > 0
