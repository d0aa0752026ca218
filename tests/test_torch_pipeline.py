"""The port's ``FCTSession.submit`` pipeline against the JAX package's on the
CPU: futures resolve in submission order with answers bit-equal to
``repro.api.FCTSession.submit``'s, at P = 1 and P = 8; an error lands on
the offending request's future only; a cancelled future does not wedge the
pipeline; an undersized program cache evicted and rebuilt under the
pipeline still serves every answer right; ``close`` drains and a later
``submit`` restarts.  (The behaviour of ``tests/test_api.py``'s submit
tests, on the port.)"""
import threading

import numpy as np
import pytest

from repro.api import FCTRequest as JaxRequest
from repro.api import FCTSession as JaxSession
from repro_torch.api import FCTRequest, FCTSession, SessionConfig
from repro_torch.api.pipeline import QueryPipeline
from repro_torch.data.schema import schema_from_reference
from repro_torch.kernels.fct_count import ops
from repro_torch.runtime.cache import ExecutableCache
from repro_torch.runtime.engine import FCTEngine
from test_engine import _crafted_schema, _dataset


def _port(sj, P=1, **kw):
    return FCTSession(schema_from_reference(sj), device="cpu", n_workers=P,
                      engine=FCTEngine(cache=ExecutableCache()), **kw)


@pytest.fixture(scope="module")
def star():
    """The star dataset and the JAX session's pipelined answers for three
    requests (two keyword sets, one salt)."""
    sj, kws = _dataset("star")
    reqs = [dict(keywords=tuple(kws), r_max=3, top_k=10),
            dict(keywords=tuple(kws[:2]), r_max=3, top_k=10),
            dict(keywords=tuple(kws), r_max=3, top_k=5, salt=1)]
    with JaxSession(sj) as session:
        futs = [session.submit(JaxRequest(**r)) for r in reqs]
        want = [f.result(timeout=300) for f in futs]
    return sj, reqs, want


@pytest.mark.parametrize("P", [1, 8])
def test_submit_answers_equal_the_reference(star, P):
    sj, reqs, want = star
    with _port(sj, P) as session:
        futs = [session.submit(FCTRequest(**r)) for r in reqs]
        got = [f.result(timeout=300) for f in futs]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.all_freqs, w.all_freqs)
        np.testing.assert_array_equal(g.term_ids, w.term_ids)
        np.testing.assert_array_equal(g.freqs, w.freqs)
        assert (g.n_cns, g.n_joined_cns, g.data_epoch, g.finalize) == \
            (w.n_cns, w.n_joined_cns, w.data_epoch, w.finalize)
        if P == 1:
            assert (g.shuffle_rows, g.shuffle_bytes) == \
                (w.shuffle_rows, w.shuffle_bytes)


def test_submit_preserves_order_and_propagates_exceptions():
    sj, kws = _crafted_schema(seed=0)
    session = _port(sj)
    done_order, futs = [], []
    for i in range(3):
        f = session.submit(FCTRequest(keywords=tuple(kws), r_max=3, salt=i))
        f.add_done_callback(lambda fut, i=i: done_order.append(i))
        futs.append(f)
    bad = session.submit(FCTRequest(keywords=("needs-a-tokenizer",), r_max=3))
    after = session.submit(FCTRequest(keywords=tuple(kws), r_max=3))
    responses = [f.result(timeout=300) for f in futs]
    with pytest.raises(ValueError, match="tokenizer"):
        bad.result(timeout=300)
    resp_after = after.result(timeout=300)   # failures don't wedge the stream
    assert done_order == [0, 1, 2], "futures resolved out of order"
    sync = session.query(FCTRequest(keywords=tuple(kws), r_max=3))
    np.testing.assert_array_equal(resp_after.all_freqs, sync.all_freqs)
    np.testing.assert_array_equal(responses[0].all_freqs, sync.all_freqs)
    session.close()
    session.submit(FCTRequest(keywords=tuple(kws), r_max=3)).result(
        timeout=300)                         # close() restarts on next submit
    session.close()


def test_cancelled_future_does_not_wedge_pipeline():
    sj, kws = _crafted_schema(seed=0)
    session = _port(sj)
    req = FCTRequest(keywords=tuple(kws), r_max=3)
    session.query(req)
    futs = [session.submit(FCTRequest(keywords=tuple(kws), r_max=3, salt=i))
            for i in range(4)]
    futs[1].cancel()                         # may or may not win the race
    for i in (0, 2, 3):
        assert futs[i].result(timeout=300) is not None
    after = session.submit(req).result(timeout=300)
    np.testing.assert_array_equal(after.all_freqs,
                                  session.query(req).all_freqs)
    session.close()


def test_lru_eviction_under_concurrent_submit_pipeline():
    sj, kws = _crafted_schema(seed=0)
    session = FCTSession(schema_from_reference(sj), device="cpu",
                         config=SessionConfig(cache_max_entries=1,
                                              plan_cache_size=0))
    reqs = [FCTRequest(keywords=tuple(kws), r_max=3),
            FCTRequest(keywords=tuple(kws), r_max=2),
            FCTRequest(keywords=(kws[0],), r_max=3)]
    want = {i: session.query(r).all_freqs for i, r in enumerate(reqs)}
    evictions_before = session.engine.cache.evictions
    futs = [(i, session.submit(reqs[i])) for _ in range(4)
            for i in range(len(reqs))]
    for i, fut in futs:
        np.testing.assert_array_equal(fut.result(timeout=600).all_freqs,
                                      want[i])
    assert session.engine.cache.evictions > evictions_before
    assert session.engine.cache.stats()["entries"] <= 1
    session.close()


def test_submit_from_threads_counts_every_histogram():
    """Three threads submit at once: every answer is right and the plain
    version's path count is exact (the counts move under one lock)."""
    sj, kws = _crafted_schema(seed=0)
    session = _port(sj)
    req = FCTRequest(keywords=tuple(kws), r_max=3)
    want = session.query(req).all_freqs
    ops.reset_path_counts()
    session.query(req)
    calls_per_query = ops.PATH_COUNTS["ref"]
    ops.reset_path_counts()
    results, errors = [], []

    def worker():
        try:
            futs = [session.submit(req) for _ in range(5)]
            results.extend(f.result(timeout=300) for f in futs)
        except BaseException as exc:         # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    session.close()
    assert not errors and len(results) == 15
    for r in results:
        np.testing.assert_array_equal(r.all_freqs, want)
    assert ops.PATH_COUNTS["ref"] == 15 * calls_per_query > 0


def test_closed_pipeline_refuses_and_close_is_idempotent():
    sj, kws = _crafted_schema(seed=0)
    pipeline = QueryPipeline(_port(sj), queue_depth=4)
    fut = pipeline.submit(FCTRequest(keywords=tuple(kws), r_max=3))
    pipeline.close()
    assert fut.done() and fut.result().n_cns > 0   # drained, not dropped
    pipeline.close()
    with pytest.raises(RuntimeError, match="closed"):
        pipeline.submit(FCTRequest(keywords=tuple(kws), r_max=3))


def test_counts_stay_exact_under_thread_stress():
    """Launch and path counts move by read-modify-write: under many threads
    and a short switch interval an unlocked ``+= 1`` loses updates; the
    locked ``bump`` must not."""
    import sys

    from repro_torch.kernels import _build
    counts = {"k": 0}
    n_threads, n_iter = 16, 4000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.bump(counts, "k") for _ in range(n_iter)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counts["k"] == n_threads * n_iter
    _build.reset_counts(counts)
    assert counts == {"k": 0}
