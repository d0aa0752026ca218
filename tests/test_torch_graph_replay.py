"""Store-path signature groups replayed from CUDA graphs
(``runtime/graphs.py``, ``FCTEngine.graphs``).

On the CPU a capture stub stands in for ``torch.cuda.CUDAGraph``: it runs
the stage once when it captures, as a capture and its first replay compute
together, and its replays launch nothing, since a replay over the same
unchanged inputs gives the same outputs.  So the tests here hold the
engine's decisions and bookkeeping:

* a group's first dispatch runs eagerly, its second with the very same
  input tensors captures (and replays), every later one replays;
* inputs that changed (a store eviction, a plan dropped and planned anew,
  an append's re-assembled chunk) run eagerly, and the stale graphs are
  dropped once their inputs die;
* storeless calls (a store made for the call, whose columns die with it)
  and CPU meshes never capture;
* the ``graph`` arg of ``engine.dispatch_group`` and the counters
  ``graph_eager`` / ``graph_captures`` / ``graph_replays`` read as stated,
  and ``engine.graph_replay_share.warm`` reads them;
* a capture's own ``LAUNCHES``, ``PATH_COUNTS`` and collective tallies are
  held back, and each replay adds what one run of the body adds;
* a warm store query replays every group, ships 0 bytes, reads MR²'s
  tokens by reference (``mr2_by_reference``) and its route stage hands on
  routed keys and masks only, no routed text.

On the card (``cuda``-marked; they skip here) the real graphs: replayed
answers are bit-identical to eager ones and to the oracle on uniform P 1 and
skewed P 8 adaptive plans, through ``query_batch``'s per-CN family, device
top-k, 8 pipelined ``submit``s alternating two keyword sets from a cold
session, and an ``append`` followed by the same query; launch counts equal
the eager path's; ``dispatch_plans`` hands back each group already copied
into pinned host memory; the route stage's allocations stay within a few
times its routed keys and masks, below what a routed text copy would
take.  This module imports no JAX, so it runs on the
card.
"""
import collections
import gc
import types

import numpy as np
import pytest
import torch

from bench import harness
from repro_torch.api import FCTRequest, FCTSession, SessionConfig
from repro_torch.core.star import fct_star, topk_terms
from repro_torch.data.schema import PAD_ID
from repro_torch.data.tpch import TpchConfig, generate, plant_keywords
from repro_torch.kernels import _build
from repro_torch.kernels.fct_count import kernel, ops, ref
from repro_torch.launch.mesh import collective_census, make_worker_mesh
from repro_torch.obs import MetricsRegistry, Trace
from repro_torch.runtime.cache import ExecutableCache
from repro_torch.runtime.engine import FCTEngine, HostCopy, _stage_steps
from repro_torch.runtime.graphs import CAPTURE, EAGER, REPLAY, GraphCache
from repro_torch.runtime.store import RelationStore

GRAPH_KEYS = ("graph_eager", "graph_captures", "graph_replays")
KWS = (253, 254, 255)


def _schema(skew: float = 0.0, fact_rows: int = 600):
    cfg = TpchConfig(scale=1.0, fact_rows=fact_rows, part_rows=60,
                     supp_rows=12, order_rows=150, text_len=6,
                     vocab_size=256, skew=skew, seed=3)
    return plant_keywords(generate(cfg), {
        "PART": [KWS[0]], "SUPPLIER": [KWS[1]], "ORDERS": [KWS[2]],
        "LINEITEM": [KWS[0], KWS[2]]}, frac=0.3)


def _stub_cache(calls):
    """A graph cache that captures on the CPU too, through a stub that
    runs the stage once and whose replays launch nothing."""
    def capture(fn, device):
        calls.append(device)
        return types.SimpleNamespace(replay=lambda: None), fn()
    return GraphCache(capture=capture, device_types=("cpu", "cuda"))


def _n_captured(cache):
    return sum(e.graphs is not None for e in cache._entries.values())


def _engine(graphs=None):
    eng = FCTEngine(cache=ExecutableCache(), metrics=MetricsRegistry())
    if graphs is not None:
        eng.graphs = graphs
    return eng


def _graph_counts(resp):
    return {k: resp.engine_stats[k] for k in GRAPH_KEYS}


def _group_modes(resp):
    return [s.args["graph"] for s in resp.trace.spans()
            if s.name == "engine.dispatch_group"]


def _oracle(schema, kws=KWS, r_max=4):
    return fct_star(schema, list(kws), r_max)


def _check_answer(resp, schema, req):
    want = _oracle(schema, req.keywords, req.r_max)
    if resp.all_freqs is not None:
        np.testing.assert_array_equal(resp.all_freqs, want)
    want[PAD_ID] = 0
    ids, f = topk_terms(want, list(req.keywords), req.top_k)
    np.testing.assert_array_equal(resp.term_ids, ids)
    np.testing.assert_array_equal(resp.freqs, f)


def _run(session, family, reqs):
    """One dispatch of the family: the leader's response and all of them."""
    if family == "percn":
        out = session.query_batch(reqs)
    else:
        out = [session.query(reqs[0])]
    return out[0], out


FAMILIES = {"sum": {}, "percn": {}, "topk": {"device_topk": True}}


# ---------------------------------------------------------------------------
# CPU: the decisions, through a capture stub
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_first_eager_then_capture_then_replay(family, P):
    schema = _schema()
    calls = []
    eng = _engine(_stub_cache(calls))
    session = FCTSession(schema, device="cpu", n_workers=P, engine=eng,
                         config=SessionConfig(**FAMILIES[family]))
    reqs = [FCTRequest(keywords=KWS, top_k=5, r_max=4),
            FCTRequest(keywords=KWS[:2], top_k=10, r_max=4)]
    first, answers = _run(session, family, reqs)
    n = first.engine_stats["graph_eager"]
    assert n > 0
    assert _graph_counts(first) == {"graph_eager": n, "graph_captures": 0,
                                    "graph_replays": 0}
    assert _group_modes(first) == [EAGER] * n and not calls
    want = {"graph_eager": 0, "graph_captures": n, "graph_replays": 0}
    for i in range(4):
        resp, answers_i = _run(session, family, reqs)
        assert _graph_counts(resp) == want, i
        assert _group_modes(resp) == [CAPTURE if i == 0 else REPLAY] * n
        # three stages captured a group, at the second dispatch only
        assert len(calls) == 3 * n
        for a, b, req in zip(answers, answers_i, reqs):
            np.testing.assert_array_equal(a.term_ids, b.term_ids)
            np.testing.assert_array_equal(a.freqs, b.freqs)
            _check_answer(b, schema, req)
        want = {"graph_eager": 0, "graph_captures": 0, "graph_replays": n}
    assert _n_captured(eng.graphs) == n
    session.close()


def _append_rows(schema, n=5):
    """LINEITEM rows over existing rows' keys, holding two keywords."""
    rng = np.random.default_rng(9)
    fact = schema.fact
    picks = rng.integers(0, fact.rows, n)
    return [{**{c: int(col[r]) for c, col in fact.keys.items()},
             "text": [KWS[0], KWS[2], 7 + i, 9]}
            for i, r in enumerate(picks)]


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("mutation", ["evict", "replan", "append"])
def test_changed_inputs_run_eager_and_drop_stale_graphs(mutation, P):
    schema = _schema()
    calls = []
    eng = _engine(_stub_cache(calls))
    session = FCTSession(schema, device="cpu", n_workers=P, engine=eng,
                         config=SessionConfig(plan_cache_size=1))
    req = FCTRequest(keywords=KWS, top_k=5, r_max=4)
    for _ in range(3):
        resp = session.query(req)
    n = resp.engine_stats["graph_replays"]
    assert n > 0 and _n_captured(eng.graphs) == n
    stale = set(eng.graphs._entries)
    if mutation == "evict":
        session.store.clear()
    elif mutation == "replan":
        # plan_cache_size 1: another set's plan takes the slot
        session.query(FCTRequest(keywords=KWS[1:], top_k=5, r_max=4))
    else:
        session.append("LINEITEM", _append_rows(session.schema))
    gc.collect()
    # the stale graphs went with their inputs
    assert not stale & set(eng.graphs._entries)
    n_calls = len(calls)
    modes = []
    for _ in range(3):
        resp = session.query(req)
        modes.append(set(_group_modes(resp)))
        _check_answer(resp, session.schema, req)
    assert modes == [{EAGER}, {CAPTURE}, {REPLAY}]
    assert len(calls) > n_calls
    session.close()


@pytest.mark.parametrize("P", [1, 8])
def test_host_path_never_captures(P):
    """Storeless ``run_plans``: each call uploads the columns to a store of
    its own, so no two calls share inputs, and each call's entries go with
    its columns."""
    schema = _schema()
    calls = []
    eng = _engine(_stub_cache(calls))
    session = FCTSession(schema, device="cpu", n_workers=P,
                         engine=_engine())
    plans = session._plan(FCTRequest(keywords=KWS, r_max=4)).plans
    mesh = make_worker_mesh(P, "cpu")
    want = eng.run_plans(plans, mesh)
    for _ in range(3):
        tr = Trace()
        with tr.activate():
            got = eng.run_plans(plans, mesh)
        np.testing.assert_array_equal(got, want)
        modes = [s.args["graph"] for s in tr.spans()
                 if s.name == "engine.dispatch_group"]
        assert modes and set(modes) == {EAGER}
    st = eng.stats()
    assert not calls and len(eng.graphs) == 0
    # every group ran through the engine's one loop, eagerly
    assert {k: st[k] for k in GRAPH_KEYS} == {
        "graph_eager": st["batches_run"], "graph_captures": 0,
        "graph_replays": 0}
    session.close()


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_cpu_mesh_never_captures(family, P):
    schema = _schema()
    eng = _engine()             # the engine's own cache: CUDA devices only
    session = FCTSession(schema, device="cpu", n_workers=P, engine=eng,
                         config=SessionConfig(**FAMILIES[family]))
    reqs = [FCTRequest(keywords=KWS, top_k=5, r_max=4),
            FCTRequest(keywords=KWS[:2], top_k=10, r_max=4)]
    for _ in range(3):
        resp, answers = _run(session, family, reqs)
        n = resp.engine_stats["graph_eager"]
        assert n > 0 and _graph_counts(resp) == {
            "graph_eager": n, "graph_captures": 0, "graph_replays": 0}
        assert set(_group_modes(resp)) == {EAGER}
        for a, req in zip(answers, reqs):
            _check_answer(a, schema, req)
    assert len(eng.graphs) == 0
    session.close()


def _route_stage_footprints(session, req):
    """Per signature group of ``req``'s plans on the session's store: the
    route stage's outputs (run once, eagerly), the bytes of the routed keys
    and masks they should be, and the bytes a routed copy of the text
    would take."""
    from repro_torch.runtime.engine import _build_stages
    from repro_torch.runtime.store import store_group_args
    plans = session._plan(req).plans
    out = []
    for sig, idxs in session.engine._group(plans):
        group = [plans[i] for i in idxs]
        args = store_group_args(session.store, group, sig, len(group))
        route = _build_stages(sig, True, False)[0]
        slots = [len(group) * sig.n_devices ** 2 * r.cap
                 for r in (sig.fact, *sig.dims)]
        keys_mask = sum(n * (4 * w + 1) for n, w in zip(
            slots, [sig.m] + [1] * len(sig.dims)))
        text = sum(n * r.text_len * 4
                   for n, r in zip(slots, (sig.fact, *sig.dims)))
        out.append((args, route, keys_mask, text))
    return out


@pytest.mark.parametrize("P", [1, 8])
def test_warm_query_replays_and_routes_keys_and_masks_only(P):
    schema = _schema()
    calls = []
    session = FCTSession(schema, device="cpu", n_workers=P,
                         engine=_engine(_stub_cache(calls)))
    req = FCTRequest(keywords=KWS, top_k=5, r_max=4)
    for _ in range(3):
        resp = session.query(req)
    st = resp.engine_stats
    assert st["graph_replays"] == st["batches_run"] > 0
    assert st["graph_eager"] == st["graph_captures"] == 0
    assert st["bytes_shipped"] == 0
    assert st["mr2_by_reference"] > st["batches_run"]
    _check_answer(resp, schema, req)
    for args, route, keys_mask, _ in _route_stage_footprints(session, req):
        routed_fact, routed_dims = route(args.fact, args.dims)
        outs = [t for rel in (routed_fact, *routed_dims) for t in rel]
        assert len(outs) == 2 * (1 + len(routed_dims))
        assert sum(t.numel() * t.element_size() for t in outs) == keys_mask
    session.close()


def _plain_routed_kernel(texts, send, weights, vocab, pointers=None):
    """The routed kernel's stand-in: the plain routed histogram, counted as
    a launch."""
    _, name = kernel.ROUTED[weights.dtype]
    _build.bump(kernel.LIB.launches, name)
    return ref.routed_weighted_histogram(texts, send, weights, vocab)


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("individual", [False, True])
def test_capture_holds_back_its_counts(monkeypatch, individual, P):
    monkeypatch.setattr(kernel, "fct_count_routed", _plain_routed_kernel)
    monkeypatch.setattr(ops.routed_histogram, "__defaults__", (None, "cuda"))
    schema = _schema()
    calls = []
    eng = _engine(_stub_cache(calls))
    session = FCTSession(schema, device="cpu", n_workers=P,
                         engine=_engine())
    plans = session._plan(FCTRequest(keywords=KWS, r_max=4)).plans
    mesh = make_worker_mesh(P, "cpu")
    store = RelationStore(mesh)
    per_run = []
    for _ in range(4):
        kernel.LIB.reset_launches()
        ops.reset_path_counts()
        with collective_census() as census:
            if individual:
                eng.run_plans_individual(plans, mesh, store=store)
            else:
                eng.run_plans(plans, mesh, store=store)
        per_run.append((dict(kernel.LAUNCHES), dict(ops.PATH_COUNTS),
                        dict(census)))
    st = eng.stats()
    assert st["graph_captures"] > 0 and calls
    assert st["graph_replays"] == 2 * st["graph_captures"]
    eager = per_run[0]
    assert sum(eager[0].values()) > 0 and eager[1]["cuda_routed"] > 0
    assert eager[2]["all_to_all"] > 0
    # capture, then two replays: each counts one run of the body
    assert per_run[1:] == [eager] * 3
    session.close()


def test_graph_cache_matches_live_objects_only():
    calls = []
    cache = _stub_cache(calls)
    dev = torch.device("cpu")
    key = ("fct_store", "sig")
    a, b = torch.zeros(4), torch.ones(4)
    assert cache.decide(key, dev, (a, b))[0] == EAGER
    mode, entry = cache.decide(key, dev, (a, b))
    assert mode == CAPTURE
    cache.capture_group(entry, _stage_steps(
        (lambda f, d: f, lambda r: r, lambda f, d, v: f + v), a, []), dev)
    assert cache.decide(key, dev, (a, b))[0] == REPLAY
    # another object in a slot, or another key: eager
    c = b.clone()
    assert cache.decide(key, dev, (a, c))[0] == EAGER
    assert cache.decide(("fct_store", "other"), dev, (a, b))[0] == EAGER
    assert len(cache) == 3 and _n_captured(cache) == 1
    # an input dies: its entries go, even if its id comes back
    ident_b = id(b)
    del b
    gc.collect()
    assert len(cache) == 1 and _n_captured(cache) == 0
    fresh = [torch.ones(4) for _ in range(64)]
    same_id = [t for t in fresh if id(t) == ident_b]
    for t in same_id or fresh[:1]:
        assert cache.decide(key, dev, (a, t))[0] == EAGER
    # devices outside device_types are never remembered
    assert GraphCache(device_types=("cuda",)).decide(
        key, dev, (a,)) == (EAGER, None)


def _answers(stats_list):
    return [(0, 5, types.SimpleNamespace(engine_stats=s), 1.0)
            for s in stats_list]


@pytest.mark.parametrize("stats,want", [
    ([{"graph_eager": 0, "graph_captures": 0, "graph_replays": 9}] * 3,
     100.0),
    ([{"graph_eager": 9, "graph_captures": 0, "graph_replays": 0},
      {"graph_eager": 0, "graph_captures": 9, "graph_replays": 0},
      {"graph_eager": 0, "graph_captures": 0, "graph_replays": 18}], 50.0),
    ([{"graph_eager": 0, "graph_captures": 0, "graph_replays": 0}], None),
    ([{"bytes_shipped": 0}], None),
    ([], None)])
def test_replay_share_reads_the_window(stats, want):
    read = harness.reader("engine.graph_replay_share.warm")
    run = types.SimpleNamespace(answers=_answers(stats))
    assert read(run) == want


# ---------------------------------------------------------------------------
# on the card: the real graphs
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc) to capture and replay "
                    "CUDA graphs of the fct_count kernel")
    return torch.device("cuda")


def _eager_engine():
    """An engine whose graph cache captures on no device."""
    return _engine(GraphCache(device_types=()))


CARD_CASES = {"uniform_p1": (0.0, 1, {}),
              "zipf_p8_adaptive": (0.5, 8, {"adaptive_rho": True})}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_replayed_answers_bit_identical_on_card(cuda_device, case):
    skew, P, config = CARD_CASES[case]
    schema = _schema(skew, fact_rows=3000)
    reqs = [FCTRequest(keywords=KWS, top_k=10, r_max=4),
            FCTRequest(keywords=KWS[:2], top_k=5, r_max=4)]
    eager = FCTSession(schema, device=cuda_device, n_workers=P,
                       engine=_eager_engine(),
                       config=SessionConfig(**config))
    graphed = FCTSession(schema, device=cuda_device, n_workers=P,
                         engine=_engine(), config=SessionConfig(**config))
    modes = collections.Counter()
    for _ in range(4):
        for req in reqs:
            want = eager.query(req)
            got = graphed.query(req)
            modes.update(_group_modes(got))
            np.testing.assert_array_equal(got.all_freqs, want.all_freqs)
            np.testing.assert_array_equal(got.term_ids, want.term_ids)
            np.testing.assert_array_equal(got.freqs, want.freqs)
            _check_answer(got, schema, req)
    assert modes[REPLAY] == 2 * modes[CAPTURE] == 2 * modes[EAGER] > 0
    eager.close()
    graphed.close()


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["percn", "topk"])
def test_families_replay_on_card(cuda_device, family):
    schema = _schema(fact_rows=3000)
    session = FCTSession(schema, device=cuda_device, n_workers=2,
                         engine=_engine(),
                         config=SessionConfig(**FAMILIES[family]))
    reqs = [FCTRequest(keywords=KWS, top_k=10, r_max=4),
            FCTRequest(keywords=KWS[1:], top_k=10, r_max=4)]
    seen = []
    for _ in range(4):
        resp, answers = _run(session, family, reqs)
        seen.append(set(_group_modes(resp)))
        for a, req in zip(answers, reqs):
            _check_answer(a, schema, req)
    assert seen == [{EAGER}, {CAPTURE}, {REPLAY}, {REPLAY}]
    session.close()


@pytest.mark.cuda
def test_pipelined_submits_alternating_sets_on_card(cuda_device):
    schema = _schema(fact_rows=3000)
    session = FCTSession(schema, device=cuda_device, engine=_engine())
    reqs = [FCTRequest(keywords=KWS, top_k=10, r_max=4),
            FCTRequest(keywords=KWS[:2], top_k=10, r_max=4)]
    inflight, done = collections.deque(), []
    for i in range(32):          # from a cold session, 8 always in flight
        if len(inflight) == 8:
            done.append(inflight.popleft())
            done[-1] = (done[-1][0], done[-1][1].result(timeout=300))
        inflight.append((i % 2, session.submit(reqs[i % 2])))
    done.extend((i, f.result(timeout=300)) for i, f in inflight)
    modes = collections.Counter()
    for i, resp in done:
        _check_answer(resp, schema, reqs[i])
        modes.update(_group_modes(resp))
    assert modes[CAPTURE] > 0 and modes[REPLAY] > modes[CAPTURE]
    session.close()


@pytest.mark.cuda
def test_append_then_same_query_on_card(cuda_device):
    schema = _schema(fact_rows=3000)
    session = FCTSession(schema, device=cuda_device, engine=_engine())
    req = FCTRequest(keywords=KWS, top_k=10, r_max=4)
    for _ in range(3):
        _check_answer(session.query(req), session.schema, req)
    session.append("LINEITEM", _append_rows(session.schema))
    modes = []
    for _ in range(3):
        resp = session.query(req)
        modes.append(set(_group_modes(resp)))
        _check_answer(resp, session.schema, req)
    assert modes == [{EAGER}, {CAPTURE}, {REPLAY}]
    session.close()


@pytest.mark.cuda
def test_launch_counts_equal_eager_on_card(cuda_device):
    schema = _schema(fact_rows=3000)
    reqs = [FCTRequest(keywords=KWS, top_k=10, r_max=4),
            FCTRequest(keywords=KWS[:2], top_k=10, r_max=4)] * 3
    counts = {}
    for name, eng in (("eager", _eager_engine()), ("graphs", _engine())):
        session = FCTSession(schema, device=cuda_device, engine=eng)
        kernel.LIB.reset_launches()
        ops.reset_path_counts()
        with collective_census() as census:
            for req in reqs:
                session.query(req)
        counts[name] = (dict(kernel.LAUNCHES), dict(ops.PATH_COUNTS),
                        dict(census))
        session.close()
    assert sum(counts["eager"][0].values()) > 0
    assert counts["graphs"] == counts["eager"]


@pytest.mark.cuda
@pytest.mark.parametrize("individual", [False, True])
def test_dispatch_copies_each_group_to_pinned_host_on_card(cuda_device,
                                                          individual):
    schema = _schema(fact_rows=3000)
    session = FCTSession(schema, device=cuda_device, engine=_engine())
    plans = session._plan(FCTRequest(keywords=KWS, r_max=4)).plans
    eng = session.engine
    want = None
    for _ in range(3):                     # eager, capture, replay
        pending = eng.dispatch_plans(plans, session.mesh,
                                     individual=individual,
                                     store=session.store)
        assert all(isinstance(lazy, HostCopy) and lazy.host.is_pinned()
                   for _, lazy in pending)
        got = (eng.collect_individual(pending, len(plans),
                                      schema.vocab_size).sum(axis=0)
               if individual else eng.collect_total(pending,
                                                    schema.vocab_size))
        if want is None:
            want = _oracle(schema)
            want -= session._plan(FCTRequest(keywords=KWS,
                                             r_max=4)).host_freq
        np.testing.assert_array_equal(got, want)
    assert eng.stats()["graph_replays"] > 0
    session.close()


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 8])
def test_warm_query_on_card_routes_no_text(cuda_device, P):
    """On the card: a warm query replays every group, ships nothing, and
    launches the routed kernel; over an eager run of the route stage of
    the group with the most text, the allocator's peak stays within 8
    times its routed keys and masks (plus the allocator's 512-byte
    rounding of some 64 blocks) and below the routed text copy it no
    longer makes."""
    schema = plant_keywords(generate(TpchConfig(
        scale=1.0, fact_rows=3000, part_rows=60, supp_rows=12,
        order_rows=150, text_len=32, vocab_size=256, seed=3)), {
        "PART": [KWS[0]], "SUPPLIER": [KWS[1]], "ORDERS": [KWS[2]],
        "LINEITEM": [KWS[0], KWS[2]]}, frac=0.3)
    session = FCTSession(schema, device=cuda_device, n_workers=P,
                         engine=_engine())
    req = FCTRequest(keywords=KWS, top_k=10, r_max=4)
    for _ in range(2):
        session.query(req)
    kernel.LIB.reset_launches()
    ops.reset_path_counts()
    resp = session.query(req)
    st = resp.engine_stats
    assert st["graph_replays"] == st["batches_run"] > 0
    assert st["bytes_shipped"] == 0 and st["mr2_by_reference"] > 0
    assert ops.PATH_COUNTS["cuda_routed"] == st["mr2_by_reference"]
    assert ops.PATH_COUNTS["ref"] == 0
    _check_answer(resp, schema, req)
    args, route, keys_mask, text = max(
        _route_stage_footprints(session, req), key=lambda g: g[3])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    routed = route(args.fact, args.dims)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del routed
    assert peak <= 8 * keys_mask + 64 * 512, (peak, keys_mask)
    assert peak < text, (peak, text)
    session.close()
