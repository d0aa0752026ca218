"""The TPC-DS cell on the CPU at tiny sizes: it comes out correct and an
altered count does not (``test_bench_run``'s bodies, run on this cell),
the TPC-DS reference at int16 comes out not correct where counts pass
32 767, the TPC-DS reference agrees with the star reference where every
relation has one width, and the cell's readers read a tiny run (the
roofline's kernel time from synthetic device readings: the CPU has no
device trace)."""
import time
import types

import numpy as np
import pytest
import torch

from bench import check, control, harness, loadgen
from bench.data import tpcds, tpch
from bench.reference import star
from bench.reference import tpcds as tpcds_ref
from bench.tests import _tiny, test_bench_run

TPCDS = "tpcds_sf1_store_sales.warm"
NAMES = {TPCDS: "tpcds_sf1_store_sales",
         "tpch_sf1_uniform.warm": "tpch_sf1_uniform",
         "tpch_sf1_chain.warm": "tpch_sf1_chain"}


def _steps(cell):
    """A run of ``cell`` through its client's set-up, window, finish and
    reference on the CPU, untraced, and the comparison's checks."""
    spec = harness.load_spec()
    c, _, traffic = harness.find_cell(spec, cell)
    run = harness.Run(cell=c, config=_tiny.config(NAMES[cell]),
                      traffic=traffic, seed=_tiny.SEED, seconds=1.0,
                      trace=False, device=torch.device("cpu"),
                      t_start=time.perf_counter())
    client = harness.client(traffic["client"])
    client.setup(run)
    client.window(run)
    client.finish(run)
    checks = check.compare(client.reference(run), run.failed, run.stale)
    return run, checks


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: beside other test workers on a few cores,
    torch's thread pools contend and slow the reference's ops manyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tpcds_run():
    return _steps(TPCDS)


def test_cpu_run_is_correct():
    test_bench_run.test_cpu_run_is_correct(TPCDS, NAMES[TPCDS])


def test_an_altered_answer_is_caught(monkeypatch):
    test_bench_run.test_an_altered_answer_is_caught(monkeypatch, TPCDS,
                                                    NAMES[TPCDS])


@pytest.fixture(scope="module")
def wrapping_tpcds():
    """A TPC-DS dataset whose counts pass 32 767 (vocabulary of 64), the
    traffic's pool over it and the exact reference of each set."""
    cfg = _tiny.config("tpcds_sf1_store_sales", scale=0.01, vocab=64)
    traffic = harness.find_cell(harness.load_spec(), TPCDS)[2]
    dev = torch.device("cpu")
    tables = star.StarTables(tpcds.generate(cfg, _tiny.SEED, dev),
                             cfg["star"], dev)
    pool = loadgen.pool(cfg, traffic)
    exact = [tpcds_ref.fct(tables, kws, cfg["r_max"], cfg["vocab"])[0]
             for kws in pool]
    return cfg, traffic, tables, pool, exact


@pytest.mark.parametrize("acc,caught", [("int64", False), ("int16", True)])
def test_tpcds_reference_at_int16_is_caught(wrapping_tpcds, acc, caught):
    """The TPC-DS reference put in the program's place at int16 comes out
    not correct once counts pass 32 767; at int64 it agrees."""
    cfg, traffic, tables, pool, exact = wrapping_tpcds
    got = [tpcds_ref.fct(tables, kws, cfg["r_max"], cfg["vocab"],
                         control.ACC[acc])[0] for kws in pool]
    assert max(int(f.max()) for f in exact) > 2 ** 15
    answers = [(pool[i], k, control.answer(got[i], pool[i], k), exact[i])
               for i, k in loadgen.block(traffic)]
    c = check.compare(answers, 0)
    assert (c["bins_wrong"]["value"] > 0 and c["topk_wrong"]["value"] > 0) \
        == caught
    assert check.correct(c) == (not caught)


def test_tpcds_reference_equals_the_star_reference_at_one_width():
    """Over the TPC-H star, whose relations share one width, the TPC-DS
    reference gives the star reference's frequencies and statistics, and
    ``weighted_tokens`` is ``weighted_rows`` times that width."""
    cfg = _tiny.config("tpch_sf1_uniform")
    t = star.StarTables(tpch.generate(cfg, _tiny.SEED, "cpu"), cfg["star"],
                        "cpu")
    kws = cfg["planted"]["keywords"]
    for keywords in (kws, kws[:2], kws[1:]):
        want, ws = star.fct(t, keywords, cfg["r_max"], cfg["vocab"])
        got, gs = tpcds_ref.fct(t, keywords, cfg["r_max"], cfg["vocab"])
        np.testing.assert_array_equal(got, want)
        assert {k: gs[k] for k in ws} == ws
        assert gs["weighted_tokens"] == cfg["text_len"] * ws["weighted_rows"]
        assert gs["text_rows"] > 0


def test_tpcds_reference_counts_no_fact_token(tpcds_run):
    """The fact has width 0: every joined CN weighs its rows, and MR² needs
    none of their tokens, so the tokens needed are the dimensions'."""
    run, checks = tpcds_run
    assert check.correct(checks)
    cfg = run.config
    widths = cfg["text_len"]
    assert widths[cfg["star"]["fact"]] == 0
    dim_widths = [widths[d] for d, _ in cfg["star"]["dims"]]
    for _, stats in run.reference.values():
        assert stats["joined_cns"] > 0
        assert stats["weighted_tokens"] <= max(dim_widths) * stats[
            "weighted_rows"]
        assert stats["text_rows"] < stats["joined_rows"]


def _tiny_metrics(cell):
    """Every per-layer metric of ``cell`` over a tiny untraced CPU run."""
    spec = harness.load_spec()
    run, _ = _steps(cell)
    return run, harness.read_metrics(
        harness.metric_entries(spec, cell, True), run)


@pytest.mark.parametrize("cell,want", [
    (TPCDS, ["fct_count_launch_padding.tpcds", "engine.groups_per_query.warm",
             "engine.mr2_textless_skips.warm"]),
    ("tpch_sf1_uniform.warm", ["engine.groups_per_query.warm"]),
    ("tpch_sf1_chain.warm", ["engine.groups_per_query.warm"])])
def test_new_readers_read_a_tiny_run(cell, want):
    _, got = _tiny_metrics(cell)
    for metric in want:
        assert got[metric]["value"] > 0, metric
    if cell == TPCDS:
        assert got["fct_count_launch_padding.tpcds"]["value"] >= 1.0
        assert got["engine.mr2_textless_skips.warm"]["value"] == 1.0
        assert got["engine.groups_per_query.warm"]["value"] >= 1.0


def _resp(stats=None):
    return types.SimpleNamespace(trace=None, engine_stats=dict(stats or {}))


def test_counter_readers_on_synthetic_answers():
    groups = harness.reader("engine.groups_per_query.warm")
    skips = harness.reader("engine.mr2_textless_skips.warm")
    answers = [(0, 5, _resp({"batches_run": 3, "mr2_textless_skips": 3}),
                1.0),
               (1, 5, _resp({"batches_run": 1, "mr2_textless_skips": 0}),
                1.0)]
    run = types.SimpleNamespace(answers=answers)
    assert groups(run) == 2.0
    assert skips(run) == pytest.approx(3 / 4)
    parent = types.SimpleNamespace(answers=[(0, 5, _resp({"batches_run": 2}),
                                             1.0)])
    assert groups(parent) == 2.0 and skips(parent) is None
    none = types.SimpleNamespace(answers=[])
    assert groups(none) is None and skips(none) is None


def test_tpcds_roofline_counts_what_mr2_reads(tpcds_run):
    from bench.roofline import HBM_BYTES_PER_S
    read = harness.reader("fct_count_tpcds_roofline")
    run, _ = tpcds_run
    assert read(run) is None                  # no device trace on the CPU
    traced = [a[0] for a in run.answers[:4]]
    stats = [run.reference[i][1] for i in traced]
    least = sum(s["text_rows"] * 4 + s["weighted_tokens"] * 4
                + run.config["vocab"] * 4 for s in stats) / HBM_BYTES_PER_S
    dt = {"kernels": {"void fct_count_routed_kernel<int>(...)": 2 * least,
                      "other": 1.0}}
    traced_run = types.SimpleNamespace(
        device_trace=dt, traced=traced, reference=run.reference,
        config=run.config)
    assert read(traced_run) == pytest.approx(50.0)
    chain_stats = {i: (None, {"joined_rows": 1, "weighted_rows": 1,
                              "weighted_tokens": 12}) for i in traced}
    assert read(types.SimpleNamespace(device_trace=dt, traced=traced,
                                      reference=chain_stats,
                                      config=run.config)) is None
    no_kernel = types.SimpleNamespace(
        device_trace={"kernels": {"other": 1.0}}, traced=traced,
        reference=run.reference, config=run.config)
    assert read(no_kernel) is None
