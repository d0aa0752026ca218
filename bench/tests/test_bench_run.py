"""Whole runs of the harness on the CPU at tiny sizes: a sound run comes
out correct, and a run whose answers are broken underneath does not."""
import sys
import types

import numpy as np
import pytest
import torch

from bench import check, control, harness, run
from bench.tests import _tiny

CELLS = (("tpch_sf1_uniform.warm", "tpch_sf1_uniform"),
         ("tpch_sf1_zipf1.warm", "tpch_sf1_zipf1"),
         ("tpch_sf1_uniform.rf1_ingest", "tpch_sf1_uniform"))


@pytest.mark.parametrize("cell,name", CELLS)
def test_cpu_run_is_correct(cell, name):
    """Every answer of the window, at its data epoch in the ingest cell,
    equals the reference's."""
    rc, res, err = _tiny.run_cell(cell, _tiny.config(name))
    assert rc == 0, err
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] > 0
    e2e = {m["name"] for m in harness.metric_entries(harness.load_spec(),
                                                      cell, False)}
    assert set(res["metrics"]) == e2e
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"
    # only the cell that appends checks its answers' epochs
    assert ("stale" in res["checks"]) == (cell == CELLS[2][0])
    last = list(res["checks"])[-1]
    assert err.strip().splitlines()[-1].startswith(f"check {last} 0 limit 0")


@pytest.mark.parametrize("cell,name", (CELLS[0], CELLS[2]))
def test_an_altered_answer_is_caught(monkeypatch, cell, name):
    """A count altered where the program produces it."""
    from repro_torch.api.session import FCTSession
    finish = FCTSession._finish

    def altered(self, planned, freq, *a, **k):
        freq = freq.copy()
        freq[1] += 1
        return finish(self, planned, freq, *a, **k)

    monkeypatch.setattr(FCTSession, "_finish", altered)
    rc, res, _ = _tiny.run_cell(cell, _tiny.config(name))
    assert rc == 0
    assert res["correct"] is False
    assert res["checks"]["bins_wrong"]["value"] >= 1


def test_a_failing_request_is_caught(monkeypatch):
    from repro_torch.api.session import FCTSession
    query = FCTSession.query
    calls = []

    def flaky(self, req):
        calls.append(req)
        # set-up sends each of 2 keyword sets twice: the window's first
        if len(calls) == 5:
            raise RuntimeError("lost")
        return query(self, req)

    monkeypatch.setattr(FCTSession, "query", flaky)
    rc, res, _ = _tiny.run_cell(CELLS[0][0], _tiny.config(CELLS[0][1]))
    assert rc == 0 and res["failed"] == 1 and res["correct"] is False


@pytest.mark.parametrize("acc,caught", [("int64", False), ("int16", True)])
def test_control_is_caught(acc, caught):
    """The reference put in the program's place at int16 comes out not
    correct once counts pass 32 767; at int64 it agrees."""
    cfg = _tiny.config("tpch_sf1_uniform", scale=0.01, vocab=64)
    traffic = harness.find_cell(harness.load_spec(),
                                CELLS[0][0])[2]
    r = control.readings(cfg, traffic, _tiny.SEED, acc, torch.device("cpu"))
    assert r["max_count"] > 2 ** 15
    assert (r["bins_wrong"] > 0 and r["topk_wrong"] > 0) == caught
    assert (r["bins_wrong"] == 0 and r["topk_wrong"] == 0) == (not caught)


def test_compare_counts_each_kind_of_fault():
    freq = np.arange(40, dtype=np.int64)[::-1].copy()
    freq[0] = 0
    kws = (37, 38, 39)
    good = control.answer(freq, kws, 5)
    bad = control.answer(freq + (np.arange(40) == 3), kws, 5)
    checks = check.compare([(kws, 5, good, freq), (kws, 5, bad, freq)], 0)
    assert checks["bins_wrong"]["value"] == 1
    assert checks["topk_wrong"]["value"] == 1
    assert not check.correct(checks)
    assert check.correct(check.compare([(kws, 5, good, freq)], 0))
    assert not check.correct(check.compare([(kws, 5, good, freq)], 1))


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this run would measure")
    rc = run.main(["--workload", CELLS[0][0], "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_unknown_workload_no_result(capsys):
    rc = run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"],
                  device="cpu")
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_are_named_by_whole_top_level(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like",
                        types.ModuleType("repro_torch_like"))
    base = set(harness.forbidden_loaded())
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert set(harness.forbidden_loaded()) == base | {"jax"}


def test_an_altered_refresh_delta_is_caught(monkeypatch):
    """The ingest cell's patched answers: a delta altered where the
    program produces it."""
    from repro_torch.api.session import FCTSession
    delta_freq = FCTSession.delta_freq

    def altered(self, *a, **k):
        d = delta_freq(self, *a, **k)
        d[1] += 1
        return d

    monkeypatch.setattr(FCTSession, "delta_freq", altered)
    rc, res, _ = _tiny.run_cell(CELLS[2][0], _tiny.config(CELLS[2][1]))
    assert rc == 0
    assert res["correct"] is False


def test_a_patch_left_out_is_caught(monkeypatch):
    """The ingest cell's freshness: an append that returns without patching
    the cached answers leaves them at their old epoch, and the answers read
    after it are stale."""
    from repro_torch.serve import Gateway

    def unpatched(self, schema, relation, rows):
        lane = self._lane(schema)
        with lane.append_lock:
            return lane.session.append(relation, rows)

    monkeypatch.setattr(Gateway, "append", unpatched)
    rc, res, _ = _tiny.run_cell(CELLS[2][0], _tiny.config(CELLS[2][1]))
    assert rc == 0
    assert res["correct"] is False
    assert res["checks"]["stale"]["value"] >= 1


@pytest.mark.parametrize("where", ["setup", "reference", "metric"])
def test_a_run_that_loads_jax_prints_no_result(monkeypatch, where):
    """JAX loaded at any point before the result line: in set-up, in the
    reference after the window, or in a metric reader."""
    from bench.clients import session

    def load_flax():
        monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))

    if where == "metric":
        reader = harness.reader

        def loading_reader(name):
            read = reader(name)

            def loading(run):
                load_flax()
                return read(run)
            return loading

        monkeypatch.setattr(harness, "reader", loading_reader)
    else:
        step = getattr(session, where)

        def loading(run):
            out = step(run)
            load_flax()
            return out

        monkeypatch.setattr(session, where, loading)
    rc, res, err = _tiny.run_cell(CELLS[0][0], _tiny.config(CELLS[0][1]))
    assert rc != 0 and res is None
    assert "flax" in err
