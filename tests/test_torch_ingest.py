"""The port's incremental ingest against the JAX package's on the CPU:
``FCTSession.append`` then a query, and ``delta_freq``, equal the JAX
session's on the same rows bit for bit (histograms, top-k, ``data_epoch``,
every ``AppendResult`` field), at P = 1 and P = 8 and under both
accumulation policies; the store's on-device ``_assemble`` equals a direct
upload of the same ref bit for bit; the epoch fences hold (a delta for an
overtaken epoch raises, ``clear()`` keeps a raced upload out of the store,
concurrent queries see one snapshot); the gateway patches or drops its
memoized results, and an int32 patch that would wrap raises the
reference's error.  A hypothesis suite appends random batches (fact and
dimension rows, empty batches, new terms) and holds every query to the
reference's ``fct_star`` over the reference's own appended schema.
(``tests/test_ingest.py`` on the port, with the subprocess cases run in
process.)"""
import dataclasses
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.api import FCTRequest as JaxRequest
from repro.api import FCTSession as JaxSession
from repro.core.accum import INT32_CHECKED as JAX_INT32
from repro.core.star import fct_star, topk_terms
from repro_torch.api import AppendResult, FCTRequest, FCTSession, SessionConfig
from repro_torch.core.plan import RelationRef
from repro_torch.data.schema import schema_from_reference
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.obs import MetricsRegistry
from repro_torch.runtime.store import RelationStore
from repro_torch.serve import Gateway, GatewayConfig, SchemaRegistry
from test_ingest import KWS, VOCAB, make_batch, make_schema

SETTINGS = dict(max_examples=25, deadline=None)


def _port(schema, P=1, **config):
    return FCTSession(schema_from_reference(schema), device="cpu",
                      n_workers=P, config=SessionConfig(**config))


def _oracle(schema, req):
    freq = fct_star(schema, list(req.keywords), req.r_max)
    ids, f = topk_terms(freq, list(req.keywords), req.top_k)
    return freq, ids, f


# -- the tentpole property: append == the reference, bit for bit -------------

def _random_run(data, device_topk: bool):
    seed = data.draw(st.integers(0, 10_000))
    rng = np.random.default_rng(seed)
    m = data.draw(st.integers(1, 3))
    P = data.draw(st.sampled_from([1, 8]))
    accum = data.draw(st.sampled_from(["int32", "int64"]))
    ref = make_schema(seed, m=m, fact_rows=data.draw(st.integers(4, 24)))
    req = FCTRequest(keywords=KWS, r_max=m + 1, top_k=5,
                     mode=data.draw(st.sampled_from(
                         ["uniform", "skew", "round_robin"])))
    sess = _port(ref, P, device_topk=device_topk, accum_policy=accum)
    freq = sess.query(req).all_freqs
    epoch = 0
    for _ in range(data.draw(st.integers(1, 4))):
        relation = data.draw(st.sampled_from(
            ["F"] + [f"D{i}" for i in range(m)]))
        n_rows = data.draw(st.integers(0, 5))         # 0 = empty append
        batch = make_batch(rng, ref, relation, n_rows, new_term=True)
        ar = sess.append(relation, batch)
        if n_rows:                                     # the reference's data
            role, i = ref.relation_role(relation)
            rel = ref.fact if role == "fact" else ref.dims[i]
            base = rel.rows
            keys = {c: np.array([r[c] for r in batch], np.int32)
                    for c in rel.keys}
            text = np.array([r["text"] for r in batch], np.int32)
            ref = ref.with_appended(relation, keys, text)
            epoch += 1
            assert (ar.role, ar.dim_index, ar.base_rows) == (role, i, base)
        assert (ar.rows_appended, ar.data_epoch) == (n_rows, epoch)
        want_freq, want_ids, want_f = _oracle(ref, req)
        if not device_topk and n_rows:
            freq = freq + sess.delta_freq(ar, KWS, req.r_max)
        resp = sess.query(req)
        assert resp.data_epoch == epoch
        np.testing.assert_array_equal(resp.term_ids, want_ids)
        np.testing.assert_array_equal(resp.freqs, want_f)
        if not device_topk:
            np.testing.assert_array_equal(resp.all_freqs, want_freq)
            np.testing.assert_array_equal(freq, want_freq)
        assert sess.schema.fact.chunks == ref.fact.chunks
        assert [d.key_domains for d in sess.schema.dims] == \
            [d.key_domains for d in ref.dims]
    sess.close()


@settings(**SETTINGS)
@given(st.data())
def test_append_equals_the_reference_host_path(data):
    _random_run(data, device_topk=False)


@settings(**SETTINGS)
@given(st.data())
def test_append_equals_the_reference_device_topk(data):
    _random_run(data, device_topk=True)


@pytest.mark.parametrize("accum", ["int32", "int64"])
@pytest.mark.parametrize("P", [1, 8])
def test_append_and_delta_equal_the_jax_session(P, accum):
    """The same rows through both sessions: every AppendResult field, every
    delta, every post-append histogram and epoch, and the stores' chunk
    assemblies."""
    sj = make_schema(7, m=2, fact_rows=40)
    rng = np.random.default_rng(7)
    js, ps = JaxSession(sj), _port(sj, P, accum_policy=accum)
    req = dict(keywords=KWS, r_max=3, top_k=5)
    np.testing.assert_array_equal(ps.query(FCTRequest(**req)).all_freqs,
                                  js.query(JaxRequest(**req)).all_freqs)
    for relation, n in (("F", 4), ("D0", 2), ("F", 0), ("D1", 3)):
        batch = make_batch(rng, js.schema, relation, n, new_term=True)
        aj, ap = js.append(relation, batch), ps.append(relation, batch)
        assert isinstance(ap, AppendResult)
        # every field the JAX package's result has; the port's adds the
        # append's span tree
        assert ap.trace is not None
        assert dataclasses.asdict(dataclasses.replace(ap, trace=None)) == \
            {**dataclasses.asdict(aj), "trace": None}
        np.testing.assert_array_equal(ps.delta_freq(ap, KWS, 3),
                                      js.delta_freq(aj, KWS, 3))
        want, got = js.query(JaxRequest(**req)), ps.query(FCTRequest(**req))
        np.testing.assert_array_equal(got.all_freqs, want.all_freqs)
        np.testing.assert_array_equal(got.term_ids, want.term_ids)
        np.testing.assert_array_equal(got.freqs, want.freqs)
        assert got.data_epoch == want.data_epoch
        assert got.accum_policy == ("int64-exact" if accum == "int64"
                                    else "int32-checked")
    assert ps.schema.fact.chunks == js.schema.fact.chunks == (40, 4)
    assert ps.stats()["store_chunk_assembles"] > 0
    if P == 1:
        assert ps.stats()["store_chunk_assembles"] == \
            js.stats()["store_chunk_assembles"]
    js.close()
    ps.close()


# -- the chunked store ---------------------------------------------------------

@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("role", ["fact", "dim"])
def test_assemble_equals_a_direct_upload(P, role):
    """A ref over three append chunks, assembled on the device from its
    per-chunk entries, equals the padded, worker-sharded tensor a direct
    upload of the whole ref builds, bit for bit; only the parts cost
    uploads."""
    rng = np.random.default_rng(P)
    chunks = (37, 5, 12)
    n = sum(chunks)
    text = rng.integers(0, 50, (n, 6)).astype(np.int32)
    keys = tuple(rng.integers(0, 9, n).astype(np.int32)
                 for _ in range(3 if role == "fact" else 1))
    rows = np.sort(rng.choice(n, 31, replace=False))
    rows[-1] = n - 1                              # the last chunk is hit
    ref = RelationRef(role=role, name="R", rows=rows, base_text=text,
                      base_keys=keys, n_devices=P, base_chunks=chunks)
    assert len(ref.chunk_parts()) >= 2
    store = RelationStore(make_worker_mesh(P, "cpu"),
                          metrics=MetricsRegistry())
    rows_pad, text_pad = 2 * ref.shard_rows, 8    # past the exact size
    got = store.columns(ref, rows_pad, text_pad)
    want_text, want_keys = ref.store_columns(rows_pad, text_pad)
    np.testing.assert_array_equal(got.text.numpy(), want_text)
    np.testing.assert_array_equal(got.keys.numpy(), want_keys)
    assert got.nbytes == want_text.nbytes + want_keys.nbytes
    st_ = store.stats()
    assert st_["store_chunk_assembles"] == 1
    assert st_["store_uploads"] == len(ref.chunk_parts())
    # the whole ref is now one entry beside its parts: a hit, no work
    assert store.columns(ref, rows_pad, text_pad) is got
    assert store.stats()["store_bytes"] == sum(
        c.nbytes for c in store._entries.values())


def test_clear_fences_an_upload_in_flight():
    rng = np.random.default_rng(0)
    text = rng.integers(0, 50, (20, 4)).astype(np.int32)
    ref = RelationRef(role="dim", name="D", rows=np.arange(20),
                      base_text=text, base_keys=(np.arange(20,
                                                           dtype=np.int32),),
                      n_devices=2)
    store = RelationStore(make_worker_mesh(2, "cpu"),
                          metrics=MetricsRegistry())
    inner = ref.store_columns

    def racing(*args):
        store.clear()                 # an invalidation lands mid-upload
        return inner(*args)

    ref.store_columns = racing
    served = store.columns(ref, 16, 4)
    assert served.text.shape == (2, 16, 4)        # this dispatch is served
    assert len(store) == 0 and store.resident_bytes == 0   # nothing cached


def test_empty_append_is_a_noop():
    sess = _port(make_schema(3))
    r0 = sess.query(FCTRequest(keywords=KWS, r_max=3))
    ar = sess.append("F", [])
    assert (ar.rows_appended, ar.data_epoch) == (0, 0)
    assert sess.schema.fact.chunks is None
    assert not sess.delta_freq(ar, KWS, 3).any()
    r1 = sess.query(FCTRequest(keywords=KWS, r_max=3))
    np.testing.assert_array_equal(r0.all_freqs, r1.all_freqs)
    assert r1.data_epoch == 0


def test_append_validation_raises_the_reference_errors():
    js, ps = JaxSession(make_schema(4)), _port(make_schema(4))
    bad = [("NOPE", [{"text": [1, 2, 3, 4]}]),
           ("F", [{"k0": 0, "k1": 0}]),
           ("F", [{"k0": 0, "text": [1, 2, 3, 4]}]),
           ("F", [{"k0": 0, "k1": 99, "text": [1, 2, 3, 4]}]),
           ("F", [{"k0": 0, "k1": 0, "text": [1, VOCAB + 7]}]),
           ("F", [{"k0": 0, "k1": 0, "text": "hello"}])]
    for relation, rows in bad:
        with pytest.raises((KeyError, ValueError)) as want:
            js.append(relation, rows)
        with pytest.raises(want.type) as got:
            ps.append(relation, rows)
        assert str(got.value) == str(want.value)
    # the failed appends left no trace: epoch unmoved
    assert ps.query(FCTRequest(keywords=KWS, r_max=3)).data_epoch == 0


def test_post_append_query_builds_zero_programs():
    rng = np.random.default_rng(11)
    ref = make_schema(11, fact_rows=40)
    sess = _port(ref)
    req = FCTRequest(keywords=KWS, r_max=3)
    sess.query(req)
    assert sess.query(req).engine_stats["traces"] == 0
    uploads, up_bytes = (sess.stats()[k] for k in ("store_uploads",
                                                    "store_upload_bytes"))
    batch = make_batch(rng, sess.schema, "F", 6, copy_text=True)
    ar = sess.append("F", batch)
    assert ar.plans_dropped > 0
    post = sess.query(req)
    assert post.data_epoch == ar.data_epoch
    assert post.engine_stats["traces"] == 0 and not post.cold
    st_ = sess.stats()
    assert st_["store_chunk_assembles"] > 0
    # only chunk-sized parts were uploaded, never the relation again
    assert st_["store_upload_bytes"] - up_bytes < up_bytes
    assert st_["store_uploads"] >= uploads
    np.testing.assert_array_equal(post.all_freqs,
                                  fct_star(sess.schema, list(KWS), 3))
    assert len(sess._cn_lists) > 0


def test_append_keeps_old_schema_snapshot_intact():
    sess = _port(make_schema(5))
    old = sess.schema
    old_text = old.fact.text
    sess.append("F", make_batch(np.random.default_rng(5), old, "F", 3))
    assert sess.schema is not old and old.fact.rows == 20
    np.testing.assert_array_equal(old_text, sess.schema.fact.text[:20])
    assert sess.schema.fact.chunks == (20, 3)


def test_delta_freq_requires_matching_epoch():
    sess = _port(make_schema(51))
    rng = np.random.default_rng(51)
    ar1 = sess.append("F", make_batch(rng, sess.schema, "F", 2))
    sess.append("F", make_batch(rng, sess.schema, "F", 2))
    with pytest.raises(RuntimeError, match="serialize appends"):
        sess.delta_freq(ar1, KWS, 3)


def test_invalidate_drops_device_map_only_histograms():
    sess = _port(make_schema(8), device_topk=True)
    resp = sess.query(FCTRequest(keywords=KWS, r_max=3))
    assert resp.finalize == "device_topk"
    dropped = sess.invalidate()
    assert dropped["host_freq_dev"] >= 1 and len(sess._hf_dev) == 0
    assert sess.query(FCTRequest(keywords=KWS, r_max=3)).data_epoch == 1


# -- gateway: patch vs drop ----------------------------------------------------

def _gateway(policy: str, seed: int = 21, **session_config):
    reg = SchemaRegistry(device="cpu")
    reg.register("t", schema_from_reference(make_schema(seed)),
                 config=SessionConfig(**session_config)
                 if session_config else None)
    return Gateway(reg, GatewayConfig(batch_window_ms=0.0,
                                      append_policy=policy)), reg


def test_gateway_patch_keeps_cache_warm_and_exact():
    gw, reg = _gateway("patch")
    rng = np.random.default_rng(21)
    reqs = [FCTRequest(keywords=KWS, r_max=3, top_k=5),
            FCTRequest(keywords=KWS, r_max=3, top_k=5, mode="skew", rho=2),
            FCTRequest(keywords=KWS[:1], r_max=2, top_k=4)]
    for r in reqs:
        gw.query("t", r)
    ar = gw.append("t", "F", make_batch(rng, reg.session("t").schema, "F", 4,
                                        new_term=True))
    stats = gw.stats()["t"]
    assert stats["histograms_patched"] == 3
    assert stats["appends"] == 1 and stats["delta_rows"] == 4
    for r in reqs:
        resp = gw.query("t", r)
        assert resp.cache_hit and resp.data_epoch == ar.data_epoch
        want, ids, f = _oracle(reg.session("t").schema, r)
        np.testing.assert_array_equal(resp.all_freqs, want)
        np.testing.assert_array_equal(resp.term_ids, ids)
    ar2 = gw.append("t", "D0", [{"k0": reg.session("t").schema.dims[0].rows,
                                 "text": [KWS[0], 1, 2, 3]}])
    for r in reqs:
        resp = gw.query("t", r)
        assert resp.cache_hit and resp.data_epoch == ar2.data_epoch
        np.testing.assert_array_equal(
            resp.all_freqs, _oracle(reg.session("t").schema, r)[0])
    gw.close()


def test_gateway_drop_policy_invalidates_results():
    gw, reg = _gateway("drop")
    req = FCTRequest(keywords=KWS, r_max=3)
    gw.query("t", req)
    assert gw.query("t", req).cache_hit
    ar = gw.append("t", "F", make_batch(np.random.default_rng(23),
                                        reg.session("t").schema, "F", 2))
    resp = gw.query("t", req)
    assert not resp.cache_hit and not resp.coalesced
    assert resp.data_epoch == ar.data_epoch
    np.testing.assert_array_equal(resp.all_freqs,
                                  _oracle(reg.session("t").schema, req)[0])
    gw.close()


def test_gateway_device_topk_masters_refinalize_from_patched_histogram():
    gw, reg = _gateway("patch", seed=31, device_topk=True)
    req = FCTRequest(keywords=KWS, r_max=3, top_k=5)
    gw.query("t", req)
    ar = gw.append("t", "F", make_batch(np.random.default_rng(31),
                                        reg.session("t").schema, "F", 5,
                                        new_term=True))
    assert gw.stats()["t"]["histograms_patched"] == 1
    resp = gw.query("t", req)
    assert resp.cache_hit and resp.data_epoch == ar.data_epoch
    _, ids, f = _oracle(reg.session("t").schema, req)
    np.testing.assert_array_equal(resp.term_ids, ids)
    np.testing.assert_array_equal(resp.freqs, f)
    gw.close()


def test_gateway_append_unknown_names():
    gw, _ = _gateway("patch")
    with pytest.raises(KeyError):
        gw.append("nope", "F", [])
    with pytest.raises(KeyError, match="unknown relation"):
        gw.append("t", "NOPE", [{"text": [1, 2, 3, 4]}])
    gw.close()


def test_concurrent_queries_see_consistent_epochs():
    gw, reg = _gateway("patch")
    req = FCTRequest(keywords=KWS, r_max=3)
    sess = reg.session("t")
    snapshots = {0: sess.schema}
    responses, errors = [], []
    stop = threading.Event()

    def worker():
        try:
            while not stop.is_set():
                responses.append(gw.query("t", req))
                time.sleep(0.001)     # interleave, and keep the list short
        except BaseException as exc:               # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    rng = np.random.default_rng(41)
    try:
        for _ in range(5):
            time.sleep(0.02)
            ar = gw.append("t", "F", make_batch(rng, sess.schema, "F", 3,
                                                new_term=True))
            snapshots[ar.data_epoch] = sess.schema
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors and len(snapshots) == 6 and responses
    expected = {ep: fct_star(s, list(KWS), 3) for ep, s in snapshots.items()}
    for resp in responses:
        np.testing.assert_array_equal(resp.all_freqs,
                                      expected[resp.data_epoch])
    gw.close()


def test_int32_patch_overflow_raises_the_reference_error():
    with pytest.raises(OverflowError) as cold:
        JAX_INT32.check_totals(np.array([-1]))
    gw, reg = _gateway("patch")
    req = FCTRequest(keywords=KWS, r_max=3)
    assert gw.query("t", req).accum_policy == "int32-checked"
    lane = gw._lane("t")
    (key, (_, master)), = list(lane.results._entries.items())
    huge = master.all_freqs.astype(np.int64).copy()
    huge[KWS[0]] = 2**31 - 1
    lane.results.put(key, dataclasses.replace(master, all_freqs=huge),
                     generation=lane.results.generation)
    batch = make_batch(np.random.default_rng(43), reg.session("t").schema,
                       "F", 1, plant=())
    batch[0]["text"][0], batch[0]["text"][1] = KWS
    with pytest.raises(OverflowError) as got:
        gw.append("t", "F", batch)
    assert str(got.value) == str(cold.value)
    resp = gw.query("t", req)                     # dropped, not served
    assert not resp.cache_hit
    np.testing.assert_array_equal(resp.all_freqs,
                                  _oracle(reg.session("t").schema, req)[0])
    gw.close()
