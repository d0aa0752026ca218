"""The trace arithmetic and the readers of the traced metrics, on
synthetic readings."""
import types

import pytest

from bench import harness
from bench.devtrace import attribute, top, union
from bench.roofline import HBM_BYTES_PER_S, fct_count_least


def test_union_clips_to_the_window_and_finds_the_gaps():
    busy, gaps = union([(5, 10), (8, 12), (20, 25), (40, 60)], 0, 50)
    assert busy == 7 + 5 + 10
    assert gaps == [(0, 5), (12, 20), (25, 40)]
    assert union([], 0, 10) == (0.0, [(0, 10)])


def test_idle_goes_to_the_deepest_covering_span():
    spans = [(0, 100, 1, "dispatch"), (10, 30, 2, "engine.dispatch_group"),
             (0, 100, 1, "plan_long"), (200, 300, 1, "collect")]
    idle = attribute([(12, 20), (60, 80), (150, 160), (250, 252)], spans)
    assert idle == pytest.approx({"engine.dispatch_group": 8e-6,
                                  "dispatch": 20e-6, "client": 10e-6,
                                  "collect": 2e-6})


def test_top_keeps_the_largest_and_cuts_names():
    got = top({"a" * 200: 3.0, "b": 1.0, "c": 2.0}, n=2, width=5)
    assert got == [["aaaaa", 3.0], ["c", 2.0]]


def _run(**kw):
    cfg = {"text_len": 12, "vocab": 32768, "accum_policy": "int32"}
    base = dict(config=cfg, device_trace=None, traced=[], reference={})
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_roofline_reader():
    read = harness.reader("fct_count_roofline")
    assert read(_run()) is None
    stats = {"joined_rows": 1000, "weighted_rows": 400}
    least = fct_count_least(stats, 12, 32768, 4)
    assert least["bytes"] == 1000 * 4 + 400 * 48 + 32768 * 4
    assert least["seconds"] == least["bytes"] / HBM_BYTES_PER_S
    dt = {"kernels": {"void fct_count_kernel<int>(...)": 4 * least["seconds"],
                      "other": 1.0}, "busy_s": 1.0, "window_s": 2.0}
    run = _run(device_trace=dt, traced=[0, 0], reference={0: (None, stats)})
    assert read(run) == pytest.approx(50.0)
    no_kernel = dict(dt, kernels={"other": 1.0})
    assert read(_run(device_trace=no_kernel, traced=[0],
                     reference={0: (None, stats)})) is None


@pytest.mark.parametrize("name", ["device.idle_share.warm",
                                  "device.idle_share.ingest"])
def test_idle_share_reader(name):
    read = harness.reader(name)
    assert read(_run()) is None
    assert read(_run(device_trace={"busy_s": 0.5, "window_s": 2.0})) == 75.0
