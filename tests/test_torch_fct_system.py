"""The port's FCT system end to end over modes, worker counts, aggregation
layouts and random schemas, held to the ``fct_star`` oracle and to the JAX
package at P = 1: the deprecated ``run_fct_query`` shim (every ``FCTResult``
field the reference's), the port-side counterparts of
``tests/test_system.py``, ``tests/test_fct_property.py`` (hypothesis, every
mode), ``tests/test_fct_distributed.py`` (every mode on 8 workers) and
``tests/test_multidevice.py`` (P = 8 reduce-scatter vs psum vs P = 1, both
policies, a vocab of 100 that 8 does not divide) — the port's 8 workers
run in process on the virtual mesh."""
import warnings

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.api import FCTRequest as JaxRequest
from repro.api import FCTSession as JaxSession
from repro.api import SessionConfig as JaxConfig
from repro.core.fct import run_fct_query as jax_run_fct_query
from repro.core.star import fct_star, topk_terms
from repro.data.tpch import TpchConfig, generate, plant_keywords
from repro.runtime.cache import ExecutableCache as JaxCache
from repro.runtime.engine import FCTEngine as JaxEngine
from repro_torch.api import FCTRequest, FCTSession, SessionConfig
from repro_torch.core.fct import FCTResult, run_fct_query
from repro_torch.data.schema import schema_from_reference
from repro_torch.runtime.cache import ExecutableCache
from repro_torch.runtime.engine import FCTEngine
from test_fct_property import random_schema
from test_system import small_schema

MODES = ("uniform", "skew", "round_robin", "adaptive")


def _port_query(sp, kws, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return run_fct_query(sp, kws, device="cpu", **kw)


@pytest.mark.parametrize("P", [1, 8])
def test_run_fct_query_warns_and_equals_the_reference(P):
    sj, kws = small_schema()
    with pytest.warns(DeprecationWarning, match="run_fct_query"):
        want = jax_run_fct_query(sj, kws, r_max=4, k_terms=10)
    with pytest.warns(DeprecationWarning, match="FCTSession"):
        got = run_fct_query(schema_from_reference(sj), kws, r_max=4,
                            k_terms=10, device="cpu", n_workers=P,
                            engine=FCTEngine(cache=ExecutableCache()))
    assert isinstance(got, FCTResult)
    np.testing.assert_array_equal(got.all_freqs, fct_star(sj, kws, 4))
    for field in ("term_ids", "freqs", "all_freqs"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert (got.n_cns, got.n_joined_cns) == (want.n_cns, want.n_joined_cns)
    if P == 1:     # the plan statistics depend on the worker count
        assert (got.shuffle_rows, got.shuffle_bytes, got.imbalance) == \
            (want.shuffle_rows, want.shuffle_bytes, want.imbalance)


def test_distributed_engine_equals_star_oracle():
    sj, kws = small_schema()
    res = _port_query(schema_from_reference(sj), kws, r_max=4)
    np.testing.assert_array_equal(res.all_freqs, fct_star(sj, kws, 4))
    ids, f = topk_terms(res.all_freqs, kws, 10)
    np.testing.assert_array_equal(res.term_ids, ids)
    np.testing.assert_array_equal(res.freqs, f)


@pytest.mark.parametrize("P", [1, 8])
def test_skew_modes_match_uniform_results(P):
    sj, kws = small_schema(skew=1.0)
    sp = schema_from_reference(sj)
    base = _port_query(sp, kws, r_max=3, n_workers=P).all_freqs
    np.testing.assert_array_equal(base, fct_star(sj, kws, 3))
    for mode in MODES[1:]:
        got = _port_query(sp, kws, r_max=3, mode=mode, rho=4, n_workers=P)
        np.testing.assert_array_equal(got.all_freqs, base)


def test_result_reports_shuffle_stats():
    sj, kws = small_schema()
    res = _port_query(schema_from_reference(sj), kws, r_max=3)
    assert res.n_joined_cns >= 1
    assert res.shuffle_rows > 0
    assert res.shuffle_bytes > 0
    assert res.imbalance >= 1.0


@settings(max_examples=20, deadline=None)
@given(st.data())
def test_distributed_equals_star_on_random_schemas(data):
    sj = random_schema(data.draw)
    kws = [40]
    rng = np.random.default_rng(7)
    for rel in [sj.fact, *sj.dims]:
        idx = np.nonzero(rng.random(rel.rows) < 0.5)[0]
        rel.text[idx, rng.integers(0, rel.text_len, idx.size)] = 40
    mode = data.draw(st.sampled_from(MODES))
    P = data.draw(st.sampled_from([1, 8]))
    r_max = sj.m + 1
    oracle = fct_star(sj, kws, r_max)
    res = _port_query(schema_from_reference(sj), kws, r_max=r_max, mode=mode,
                      rho=2, n_workers=P)
    np.testing.assert_array_equal(res.all_freqs, oracle)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jax_run_fct_query(sj, kws, r_max=r_max, mode=mode, rho=2)
    np.testing.assert_array_equal(res.all_freqs, want.all_freqs)
    np.testing.assert_array_equal(res.term_ids, want.term_ids)


@pytest.fixture(scope="module")
def eight_workers():
    """``tests/test_fct_distributed.py``'s runs on the port's 8 virtual
    workers, with the JAX session's answer at P = 1 for each schema."""
    out = {}
    for skew in (0.0, 1.2):
        cfg = TpchConfig(fact_rows=600, part_rows=48, supp_rows=32,
                         order_rows=40, text_len=6, vocab_size=128, seed=5,
                         skew=skew)
        kws = [100, 101, 102]
        sj = plant_keywords(generate(cfg), {"PART": [100], "SUPPLIER": [101],
                                            "ORDERS": [102]}, frac=0.4)
        want = JaxSession(sj, engine=JaxEngine(cache=JaxCache())).query(
            JaxRequest(keywords=tuple(kws), r_max=3)).all_freqs
        session = FCTSession(schema_from_reference(sj), device="cpu",
                             n_workers=8,
                             engine=FCTEngine(cache=ExecutableCache()))
        for mode in MODES:
            resp = session.query(FCTRequest(keywords=tuple(kws), r_max=3,
                                            mode=mode, rho=4))
            out[(skew, mode)] = (resp, fct_star(sj, kws, 3), want)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_all_modes_correct_on_8_workers(eight_workers, mode):
    for skew in (0.0, 1.2):
        resp, oracle, want = eight_workers[(skew, mode)]
        np.testing.assert_array_equal(resp.all_freqs, oracle)
        np.testing.assert_array_equal(resp.all_freqs, want)


def test_skew_scheduler_improves_balance(eight_workers):
    # on Zipf-skewed data, LPT over-decomposition beats the uniform hash grid
    assert eight_workers[(1.2, "skew")][0].imbalance \
        <= eight_workers[(1.2, "uniform")][0].imbalance + 1e-6


MULTI_REQS = [dict(), dict(mode="adaptive"), dict(mode="skew", rho=4)]


def _multidevice_schema():
    cfg = TpchConfig(fact_rows=600, part_rows=48, supp_rows=32,
                     order_rows=40, text_len=6, vocab_size=100,  # 100 % 8
                     seed=5, skew=1.2)
    return plant_keywords(generate(cfg), {"PART": [80], "SUPPLIER": [81],
                                          "ORDERS": [82]}, frac=0.4)


@pytest.fixture(scope="module")
def multidevice():
    """``tests/test_multidevice.py``'s sessions: for each policy, the JAX
    session's answers at P = 1 and the port's at P = 1 and 8 under
    reduce-scatter and psum — ``query``, ``query_batch`` and device
    top-k."""
    sj = _multidevice_schema()
    sp = schema_from_reference(sj)
    out = {}
    prev = jax.config.jax_enable_x64
    try:
        for accum in ("int32", "int64"):
            jax.config.update("jax_enable_x64", accum == "int64")
            js = JaxSession(sj, engine=JaxEngine(cache=JaxCache()),
                            config=JaxConfig(adaptive_rho=True))
            jreqs = [JaxRequest(keywords=(80, 81, 82), r_max=3, **kw)
                     for kw in MULTI_REQS]
            out[(accum, "jax")] = [r.all_freqs for r in
                                   [js.query(q) for q in jreqs]]
            reqs = [FCTRequest(keywords=(80, 81, 82), r_max=3, **kw)
                    for kw in MULTI_REQS]
            for P in (1, 8):
                for rs in (True, False):
                    engine = FCTEngine(cache=ExecutableCache(),
                                       reduce_scatter=rs)
                    config = dict(adaptive_rho=True, accum_policy=accum)
                    session = FCTSession(sp, device="cpu", n_workers=P,
                                         engine=engine,
                                         config=SessionConfig(**config))
                    topk = FCTSession(sp, device="cpu", n_workers=P,
                                      engine=engine,
                                      config=SessionConfig(device_topk=True,
                                                           **config))
                    out[(accum, P, rs)] = (
                        [session.query(q) for q in reqs],
                        session.query_batch(reqs),
                        [topk.query(q) for q in reqs])
    finally:
        jax.config.update("jax_enable_x64", prev)
    return sj, out


@pytest.mark.parametrize("accum", ["int32", "int64"])
def test_8_workers_bit_identical_to_1_and_to_the_reference(multidevice,
                                                           accum):
    sj, out = multidevice
    want = out[(accum, "jax")]
    oracle = fct_star(sj, [80, 81, 82], 3)
    ids, f = topk_terms(oracle, [80, 81, 82], 10)
    for P in (1, 8):
        for rs in (True, False):
            single, batch, topk = out[(accum, P, rs)]
            for got, w in zip(single + batch, want + want):
                np.testing.assert_array_equal(got.all_freqs, w)
                np.testing.assert_array_equal(got.all_freqs, oracle)
                assert got.accum_policy.startswith(accum)
            for got in topk:
                assert got.finalize == "device_topk"
                np.testing.assert_array_equal(got.term_ids, ids)
                np.testing.assert_array_equal(got.freqs, f)


@pytest.mark.parametrize("accum", ["int32", "int64"])
def test_reduce_scatter_matches_psum(multidevice, accum):
    """Equal answers and equal traffic apart from the vocab pad: under psum
    on 8 workers the histogram and the exclusion vector are the whole
    vocab (100 bins), under reduce-scatter padded to 104."""
    _, out = multidevice
    for P in (1, 8):
        rs_single, rs_batch, rs_topk = out[(accum, P, True)]
        ps_single, ps_batch, ps_topk = out[(accum, P, False)]
        for a, b in zip(rs_single + rs_batch + rs_topk,
                        ps_single + ps_batch + ps_topk):
            for field in ("all_freqs", "term_ids", "freqs"):
                np.testing.assert_array_equal(getattr(a, field),
                                              getattr(b, field))
        width = 8 if accum == "int64" else 4
        pad = 4 * width if P == 8 else 0        # 104 - 100 bins
        a, b = rs_single[0], ps_single[0]
        assert a.engine_stats["device_to_host_bytes"] - \
            b.engine_stats["device_to_host_bytes"] == \
            pad * a.engine_stats["batches_run"]
