"""The chain cell and the device top-k cell on the CPU at tiny sizes: both
come out correct, an altered count and the chain reference at int16 come
out not correct, the reference's own pre-join equals the program's, and
the chain's three readers read a tiny run (the kernel time of the
roofline from synthetic device readings: the CPU has no device trace)."""
import time
import types

import numpy as np
import pytest
import torch

from bench import check, control, harness, loadgen
from bench.clients import chain as chain_client
from bench.data import chain as chain_data
from bench.reference import chain as chain_ref
from bench.reference import star
from bench.tests import _tiny

CHAIN, TOPK = "tpch_sf1_chain.warm", "tpch_sf1_uniform.device_topk"
NAMES = {CHAIN: "tpch_sf1_chain", TOPK: "tpch_sf1_uniform",
         "tpch_sf1_uniform.warm": "tpch_sf1_uniform"}


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
def chain_run():
    return _steps(CHAIN)


@pytest.fixture(scope="module")
def wrapping_chain():
    """A chain dataset whose counts pass 32 767 (vocabulary of 64), the
    traffic's pool over it and the exact reference of each set."""
    cfg = _tiny.config("tpch_sf1_chain", scale=0.01, vocab=64)
    traffic = harness.find_cell(harness.load_spec(), CHAIN)[2]
    dev = torch.device("cpu")
    tables = star.StarTables(chain_ref.prejoin(
        chain_data.generate(cfg, _tiny.SEED, dev), cfg, dev), cfg["star"],
        dev)
    pool = loadgen.pool(cfg, traffic)
    exact = [chain_ref.fct(tables, kws, cfg["r_max"], cfg["vocab"])[0]
             for kws in pool]
    return cfg, traffic, tables, pool, exact


def test_tiny_chain_config_cuts_customer_too():
    cfg = _tiny.config("tpch_sf1_chain")
    assert cfg["rows"]["CUSTOMER"] == int(150000 * 0.002)
    assert cfg["rows"]["ORDERS"] == int(1500000 * 0.002)


@pytest.mark.parametrize("cell", [CHAIN, TOPK])
def test_cpu_run_is_correct(cell):
    rc, res, err = _tiny.run_cell(cell, _tiny.config(NAMES[cell]))
    assert rc == 0, err
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] > 0
    e2e = {m["name"] for m in harness.metric_entries(harness.load_spec(),
                                                      cell, False)}
    assert set(res["metrics"]) == e2e
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_device_topk_cell_finalizes_on_the_device():
    run, checks = _steps(TOPK)
    assert check.correct(checks)
    assert run.answers
    for _, _, resp, _ in run.answers:
        assert resp.finalize == "device_topk"
        assert resp.all_freqs is None


def test_an_altered_count_is_caught_in_the_chain(monkeypatch):
    from repro_torch.api.session import FCTSession
    finish = FCTSession._finish

    def altered(self, planned, freq, *a, **k):
        freq = freq.copy()
        freq[1] += 1
        return finish(self, planned, freq, *a, **k)

    monkeypatch.setattr(FCTSession, "_finish", altered)
    rc, res, _ = _tiny.run_cell(CHAIN, _tiny.config(NAMES[CHAIN]))
    assert rc == 0
    assert res["correct"] is False
    assert res["checks"]["bins_wrong"]["value"] >= 1
    assert res["checks"]["topk_wrong"]["value"] >= 1


@pytest.mark.parametrize("acc,caught", [("int64", False), ("int16", True)])
def test_chain_reference_at_int16_is_caught(wrapping_chain, acc, caught):
    """The chain reference put in the program's place at int16 comes out
    not correct once counts pass 32 767; at int64 it agrees."""
    cfg, traffic, tables, pool, exact = wrapping_chain
    got = [chain_ref.fct(tables, kws, cfg["r_max"], cfg["vocab"],
                         control.ACC[acc])[0] for kws in pool]
    assert max(int(f.max()) for f in exact) > 2 ** 15
    answers = [(pool[i], k, control.answer(got[i], pool[i], k), exact[i])
               for i, k in loadgen.block(traffic)]
    c = check.compare(answers, 0)
    assert (c["bins_wrong"]["value"] > 0 and c["topk_wrong"]["value"] > 0) \
        == caught
    assert check.correct(c) == (not caught)


def test_reference_prejoin_equals_the_programs():
    """Row for row, the same keys and the same tokens as multisets: the
    reference's own gather and concatenation against
    ``prejoin_orders_customer``."""
    cfg = _tiny.config("tpch_sf1_chain")
    tables = chain_data.generate(cfg, _tiny.SEED, "cpu")
    name = cfg["prejoin"]["name"]
    ref = chain_ref.prejoin(tables, cfg, "cpu")[name]
    prog = chain_client.prejoined(tables, cfg)[name]
    assert ref["text"].shape == prog["text"].shape == (
        cfg["rows"]["ORDERS"], 2 * cfg["text_len"])
    np.testing.assert_array_equal(
        torch.sort(ref["text"], dim=1).values.numpy(),
        np.sort(prog["text"], axis=1))
    np.testing.assert_array_equal(ref["keys"]["orderkey"],
                                  prog["keys"]["orderkey"])


def test_every_seed_holds_the_same_prejoined_rows():
    """O_CUSTKEY skips the customers whose 1-based key is a multiple of 3,
    and a run's seed permutes the pre-joined rows against the order keys
    without changing them, so every seed has the same tuple sets."""
    cfg = _tiny.config("tpch_sf1_chain")
    name = cfg["prejoin"]["name"]
    rows = []
    for seed in (_tiny.SEED, 7):
        tables = chain_data.generate(cfg, seed, "cpu")
        cust = tables["ORDERS"]["keys"]["custkey"]
        assert not np.any((cust + 1) % 3 == 0)
        text = chain_ref.prejoin(tables, cfg, "cpu")[name]["text"].numpy()
        rows.append(text[np.lexsort(text.T[::-1])])
    np.testing.assert_array_equal(rows[0], rows[1])


def _resp(spans=(), stats=None):
    from repro_torch.obs import Trace
    tr = Trace()
    for name, args in spans:
        tr.add_span(name, tr.t0_ns, 1000, **args)
    return types.SimpleNamespace(trace=tr, engine_stats=dict(stats or {}))


def test_free_fact_share_reads_the_cold_plans(chain_run):
    read = harness.reader("planner.free_fact_share.cold")
    run, _ = chain_run
    chain_share = read(run)
    uniform_share = read(_steps("tpch_sf1_uniform.warm")[0])
    assert 0 < uniform_share < chain_share <= 100
    setup = [(0, 5, _resp([("plan.cn_plan", {"fact_mask": 0,
                                             "fact_rows": 30,
                                             "dim_rows": 10}),
                           ("plan.cn_plan", {"fact_mask": 1,
                                             "fact_rows": 10,
                                             "dim_rows": 0}),
                           ("plan.cn_plan", {"fact_mask": -1,
                                             "fact_rows": 0})])),
             (0, 5, _resp([("plan.cn_plan", {"fact_mask": 0,
                                             "fact_rows": 99})]))]
    assert read(types.SimpleNamespace(setup_answers=setup)) == 60.0
    parent = [(0, 5, _resp([("plan.cn_plan", {"fact_rows": 30})]))]
    assert read(types.SimpleNamespace(setup_answers=parent)) is None
    assert read(types.SimpleNamespace(setup_answers=[])) is None


def test_chain_roofline_counts_each_row_at_its_width(chain_run):
    from bench.roofline import HBM_BYTES_PER_S
    read = harness.reader("fct_count_chain_roofline")
    run, _ = chain_run
    assert read(run) is None                  # no device trace on the CPU
    traced = [a[0] for a in run.answers[:4]]
    stats = [run.reference[i][1] for i in traced]
    assert all(s["weighted_tokens"] > 12 * s["weighted_rows"] > 0
               for s in stats)            # 24-token rows weigh in
    least = sum(s["joined_rows"] * 4 + s["weighted_tokens"] * 4
                + run.config["vocab"] * 4 for s in stats) / HBM_BYTES_PER_S
    dt = {"kernels": {"void fct_count_routed_kernel<int>(...)": 2 * least,
                      "other": 1.0}}
    traced_run = types.SimpleNamespace(
        device_trace=dt, traced=traced, reference=run.reference,
        config=run.config)
    assert read(traced_run) == pytest.approx(50.0)
    star_stats = {i: (None, {"joined_rows": 1, "weighted_rows": 1})
                  for i in traced}
    assert read(types.SimpleNamespace(device_trace=dt, traced=traced,
                                      reference=star_stats,
                                      config=run.config)) is None
    no_kernel = types.SimpleNamespace(
        device_trace={"kernels": {"other": 1.0}}, traced=traced,
        reference=run.reference, config=run.config)
    assert read(no_kernel) is None


def test_chain_launch_padding_reads_slots_over_needed_tokens(chain_run):
    read = harness.reader("fct_count_launch_padding.chain")
    run, _ = chain_run
    assert read(run) >= 1.0
    ref = {0: (None, {"weighted_tokens": 36}),
           1: (None, {"weighted_tokens": 24})}
    answers = [(0, 5, _resp(stats={"fct_count_tokens": 360}), 1.0),
               (1, 5, _resp(stats={"fct_count_tokens": 120}), 1.0)]
    assert read(types.SimpleNamespace(answers=answers, reference=ref)) == \
        pytest.approx(480 / 60)
    parent = [(0, 5, _resp(stats={"bytes_shipped": 0}), 1.0)]
    assert read(types.SimpleNamespace(answers=parent, reference=ref)) is None
    star_ref = {0: (None, {"weighted_rows": 3}),
                1: (None, {"weighted_rows": 2})}
    assert read(types.SimpleNamespace(answers=answers,
                                      reference=star_ref)) is None
