"""The TPC-DS ``store_sales`` deployment at a tiny size: a star of nine
dimensions whose fact carries no text (width 0), one dimension of 3 rows,
the others of their own widths, drawn from a seed by the benchmark's
generator (``bench/data/tpcds.py``).

Through ``FCTSession`` on the CPU, every answer is held bit for bit to the
benchmark's plain reference (``bench/reference/tpcds.py``: frequencies,
top-k ids and their order) under both accumulation policies, at P 1 and
P 8, and to the JAX package's ``fct_star``.  A relation of width 0 gets no
text in the store, no MR² read and no token slot: ``fct_count_tokens``
counts the dimensions' slots alone, ``mr2_by_reference`` the relations
read, ``mr2_textless_skips`` the fact once a group, and the ``fct.mr2``
span names the relations read.  The two-job path, whose job 2 skips it
too, stays bit-equal to the fused path CN for CN.  On the card
(``cuda``-marked; they skip here) the same answers come from the routed
kernel, eagerly, captured and replayed, with one routed launch per
relation read.
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
from bench.data import tpcds  # noqa: E402
from bench.reference import star  # noqa: E402
from bench.reference import tpcds as tpcds_ref  # noqa: E402
from bench.tests import _tiny  # noqa: E402
from repro_torch.api import FCTRequest, FCTSession, SessionConfig  # noqa: E402
from repro_torch.core.fct import run_cn_plan, run_cn_plan_two_jobs  # noqa: E402
from repro_torch.launch.mesh import make_worker_mesh  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.runtime.batch import group_plans  # noqa: E402
from repro_torch.runtime.cache import ExecutableCache  # noqa: E402
from repro_torch.runtime.engine import FCTEngine  # noqa: E402

CPU = torch.device("cpu")
SEED = _tiny.SEED
VOCAB = 64
ROWS = {"STORE_SALES": 600, "ITEM": 40, "CUSTOMER": 50,
        "CUSTOMER_ADDRESS": 30, "CUSTOMER_DEMOGRAPHICS": 90,
        "HOUSEHOLD_DEMOGRAPHICS": 20, "DATE_DIM": 73, "TIME_DIM": 24,
        "STORE": 3, "PROMOTION": 16}
WIDTHS = {"STORE_SALES": 0, "ITEM": 8, "CUSTOMER": 3,
          "CUSTOMER_ADDRESS": 4, "CUSTOMER_DEMOGRAPHICS": 5,
          "HOUSEHOLD_DEMOGRAPHICS": 2, "DATE_DIM": 4, "TIME_DIM": 3,
          "STORE": 4, "PROMOTION": 6}


def tiny_config() -> dict:
    """The configuration cut to a few rows a relation, STORE to 3, the
    widths small and distinct, the fact's 0, a vocabulary of 64 (the
    planted keywords its last ids) and keywords planted in half the rows,
    from a data seed at which the 3-row STORE holds one."""
    cfg = _tiny.config("tpcds_sf1_store_sales", vocab=VOCAB)
    cfg.update(rows=dict(ROWS), text_len=dict(WIDTHS), data_seed=3)
    cfg["planted"]["frac"] = 0.5
    return cfg


@pytest.fixture(scope="module")
def data():
    cfg = tiny_config()
    tables = tpcds.generate(cfg, SEED, CPU)
    kws = cfg["planted"]["keywords"]
    sets = [tuple(kws), tuple(kws[:2]), tuple(kws[1:]), (kws[0],)]
    ref = star.StarTables(tables, cfg["star"], CPU)
    return cfg, tables, port.star_schema(tables, cfg), sets, ref


def _session(schema, policy, P=1, metrics=None):
    return FCTSession(schema, device=CPU, n_workers=P,
                      engine=FCTEngine(cache=ExecutableCache(),
                                       metrics=metrics or MetricsRegistry()),
                      config=SessionConfig(accum_policy=policy))


def test_tiny_star_has_nine_dimensions_a_textless_fact_and_a_3_row_one(data):
    cfg, tables, schema, _, _ = data
    assert len(schema.dims) == 9 and schema.fact.text_len == 0
    assert schema.fact.rows == ROWS["STORE_SALES"]
    store = {d.name: d for d in schema.dims}["STORE"]
    assert store.rows == 3
    assert (store.text == cfg["planted"]["keywords"][1]).any()
    assert [d.text_len for d in schema.dims] == [
        WIDTHS[d] for d, _ in cfg["star"]["dims"]]
    first, last = tpcds.window_rows(
        cfg["foreign_keys"]["windows"]["ss_sold_date_sk"], ROWS["DATE_DIM"])
    dates = tables["STORE_SALES"]["keys"]["ss_sold_date_sk"]
    assert first <= dates.min() and dates.max() <= last < ROWS["DATE_DIM"]


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("policy", ["int32", "int64"])
def test_session_equals_the_tpcds_reference_bit_for_bit(data, policy, P):
    cfg, _, schema, sets, ref = data
    joined = 0
    with _session(schema, policy, P) as s:
        for kws in sets:
            want, stats = tpcds_ref.fct(ref, kws, cfg["r_max"], VOCAB)
            for k in (3, 10):
                resp = s.query(FCTRequest(keywords=kws, top_k=k,
                                          r_max=cfg["r_max"]))
                np.testing.assert_array_equal(resp.all_freqs, want)
                ids, f = star.topk(want, kws, k)
                np.testing.assert_array_equal(resp.term_ids, ids)
                np.testing.assert_array_equal(resp.freqs, f)
                assert resp.n_cns == stats["cns"]
            joined += stats["joined_cns"]
            # a joined CN needs two keywords: one alone is map-only
            assert (stats["weighted_tokens"] > 0) == (len(kws) > 1)
    assert joined >= 40         # the data makes CNs over many dimensions


def test_session_equals_the_jax_fct_star(data):
    from repro.core.star import fct_star
    from repro.data.schema import JoinEdge, Relation, StarSchema
    cfg, _, schema, sets, _ = data

    def rel(r):
        return Relation(r.name, keys=dict(r.keys),
                        key_domains=dict(r.key_domains), text=r.text)

    sj = StarSchema(fact=rel(schema.fact), dims=[rel(d) for d in schema.dims],
                    edges=[JoinEdge(e.dim_name, e.fact_col, e.dim_col)
                           for e in schema.edges],
                    vocab_size=VOCAB)
    with _session(schema, "int32") as s:
        for kws in sets:
            resp = s.query(FCTRequest(keywords=kws, top_k=5,
                                      r_max=cfg["r_max"]))
            np.testing.assert_array_equal(resp.all_freqs,
                                          fct_star(sj, kws, cfg["r_max"]))


@pytest.mark.parametrize("P", [1, 8])
def test_a_textless_relation_gets_no_store_text_and_no_mr2_read(data, P):
    """The fact's stored text holds no bytes and has no address table; each
    group's MR² reads its dimensions alone: its token slots are theirs, one
    by-reference read each, one skip (the fact), and ``fct.mr2`` says so."""
    cfg, _, schema, sets, _ = data
    metrics = MetricsRegistry()
    with _session(schema, "int32", P, metrics) as s:
        resp = s.query(FCTRequest(keywords=sets[0], top_k=5,
                                  r_max=cfg["r_max"]))
        planned = s._plan(FCTRequest(keywords=sets[0], top_k=5,
                                     r_max=cfg["r_max"]))
        groups = group_plans(planned.plans, accum=s.accum_policy)
        facts = [e for key, e in s.store._entries.items()
                 if key[0][0] == "fact"]
        assert facts and all(e.text.shape[-1] == 0 and e.text.numel() == 0
                             and e.nbytes == e.keys.numel() * 4
                             for e in facts)
    st = resp.engine_stats
    assert groups and all(sig.fact.text_len == 0 for sig, _ in groups)
    assert st["batches_run"] == len(groups)
    assert st["fct_count_tokens"] == sum(
        len(plans) * P * P * sum(d.cap * d.text_len for d in sig.dims)
        for sig, plans in groups)
    assert st["mr2_by_reference"] == sum(len(sig.dims) for sig, _ in groups)
    assert st["mr2_textless_skips"] == len(groups) > 0
    mr2 = [sp for sp in resp.trace.spans() if sp.name == "fct.mr2"]
    assert [sp.args["relations"] for sp in mr2] == [
        len(sig.dims) for sig, _ in groups]


def test_relations_that_carry_text_are_all_read():
    """A star whose every relation carries text skips none."""
    cfg = _tiny.config("tpch_sf1_uniform")
    from bench.data import tpch
    schema = port.star_schema(tpch.generate(cfg, SEED, CPU), cfg)
    kws = tuple(cfg["planted"]["keywords"])
    with _session(schema, "int32") as s:
        st = s.query(FCTRequest(keywords=kws, top_k=5,
                                r_max=cfg["r_max"])).engine_stats
    assert st["mr2_textless_skips"] == 0
    assert st["mr2_by_reference"] > st["batches_run"] > 0


@pytest.mark.parametrize("policy", ["int32", "int64"])
def test_two_jobs_equal_the_fused_path_with_a_textless_fact(data, policy):
    cfg, _, schema, sets, _ = data
    from repro_torch.core.accum import AccumPolicy
    accum = AccumPolicy.resolve(policy)
    mesh = make_worker_mesh(1, "cpu")
    with _session(schema, policy) as s:
        planned = s._plan(FCTRequest(keywords=sets[0], top_k=5,
                                     r_max=cfg["r_max"]))
    assert planned.plans
    for plan in planned.plans:
        np.testing.assert_array_equal(
            run_cn_plan_two_jobs(plan, mesh, cache=ExecutableCache(),
                                 accum=accum),
            run_cn_plan(plan, mesh, accum))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc) to build and launch the "
                    "kernels")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_answers_equal_the_reference_eager_captured_and_replayed(data):
    """Three rounds over the sets (eager, capture, replay): the same bits as
    the reference, one routed launch per relation read, none for the fact."""
    from repro_torch.kernels.fct_count import ops
    dev = _card()
    cfg, _, schema, sets, ref = data
    ops.reset_path_counts()
    metrics = MetricsRegistry()
    with FCTSession(schema, device=dev, n_workers=1,
                    engine=FCTEngine(cache=ExecutableCache(),
                                     metrics=metrics),
                    config=SessionConfig(accum_policy="int32")) as s:
        for _ in range(3):
            for kws in sets:
                want = tpcds_ref.fct(ref, kws, cfg["r_max"], VOCAB)[0]
                resp = s.query(FCTRequest(keywords=kws, top_k=5,
                                          r_max=cfg["r_max"]))
                np.testing.assert_array_equal(resp.all_freqs, want)
        st = s.engine.stats()
    assert st["graph_replays"] > 0
    assert st["mr2_textless_skips"] == st["batches_run"] > 0
    assert ops.PATH_COUNTS["cuda_routed"] == st["mr2_by_reference"] > 0
