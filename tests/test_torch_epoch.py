"""The device map-only histogram cache (``FCTSession._hf_dev``) is keyed by
the plan's data epoch as well as by the plan: a device-top-k query planned
before an ``append`` and dispatched after it answers over its own epoch's
data, and neither installs its map-only histogram where the other epoch's
query reads it, in either order."""
import numpy as np
import pytest

from repro.core.star import fct_star, topk_terms
from repro_torch.api import FCTRequest, FCTSession, SessionConfig
from repro_torch.data.schema import schema_from_reference
from test_ingest import KWS, VOCAB, make_batch, make_schema


def _assert_answer(resp, ref_schema, req):
    freq = fct_star(ref_schema, list(req.keywords), req.r_max)
    ids, f = topk_terms(freq, list(req.keywords), req.top_k)
    assert resp.finalize == "device_topk"
    np.testing.assert_array_equal(resp.term_ids, ids)
    np.testing.assert_array_equal(resp.freqs, f)


@pytest.mark.parametrize("P", [1, 8])
def test_stale_plan_and_fresh_query_each_read_their_own_epoch(P):
    ref = make_schema(3, m=2, fact_rows=20)
    session = FCTSession(schema_from_reference(ref), device="cpu",
                         n_workers=P, config=SessionConfig(device_topk=True))
    req = FCTRequest(keywords=KWS, r_max=3, top_k=VOCAB)   # every term
    stale = session._plan(req)
    assert stale.data_epoch == 0 and stale.host_freq.any() and stale.plans

    # fact rows holding both keywords: the map-only CN F^{40,41} grows
    rng = np.random.default_rng(0)
    batch = make_batch(rng, ref, "F", 4)
    for row in batch:
        row["text"][:2] = list(KWS)
    session.append("F", batch)
    new_ref = ref.with_appended(
        "F", {c: np.array([r[c] for r in batch], np.int32)
              for c in ref.fact.keys},
        np.array([r["text"] for r in batch], np.int32))

    old = session._finalize(session._dispatch_planned([stale]))[0]
    _assert_answer(old, ref, req)
    assert old.data_epoch == 0
    fresh = session.query(req)
    _assert_answer(fresh, new_ref, req)
    assert fresh.data_epoch == 1
    # the stale plan again, now that the fresh epoch's entry is cached
    again = session._finalize(session._dispatch_planned([stale]))[0]
    _assert_answer(again, ref, req)

    fresh_plan = session._plan(req)
    assert not np.array_equal(fresh_plan.host_freq, stale.host_freq)
    assert [k[-1] for k in session._hf_dev] == [1]
    (cached,) = session._hf_dev.values()
    assert np.array_equal(cached.numpy()[:len(fresh_plan.host_freq)],
                          fresh_plan.host_freq)
    old_dev = session._host_freq_device(stale)
    assert not np.array_equal(old_dev.numpy(), cached.numpy())
    assert np.array_equal(old_dev.numpy()[:len(stale.host_freq)],
                          stale.host_freq)
    assert len(session._hf_dev) == 1
