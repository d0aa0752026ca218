"""The plain reference against the program on the CPU, at tiny sizes."""
import numpy as np
import pytest
import torch

from bench.data import tpch
from bench.reference import star
from bench.tests import _tiny

CONFIGS = ("tpch_sf1_uniform", "tpch_sf1_zipf1")


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_equals_session_answers(name):
    from bench import port
    cfg = _tiny.config(name)
    tables = tpch.generate(cfg, _tiny.SEED, "cpu")
    session = port.session(port.star_schema(tables, cfg), cfg, {}, "cpu")
    ref_tables = star.StarTables(tables, cfg["star"], "cpu")
    kws = cfg["planted"]["keywords"]
    for keywords in (tuple(kws), tuple(kws[:2])):
        want, stats = star.fct(ref_tables, keywords, cfg["r_max"],
                               cfg["vocab"])
        assert stats["joined_cns"] > 0
        for k in (5, 10, 20):
            resp = session.query(port.request(keywords, k, cfg["r_max"]))
            np.testing.assert_array_equal(resp.all_freqs, want)
            ids, f = star.topk(want, keywords, k)
            np.testing.assert_array_equal(resp.term_ids, ids)
            np.testing.assert_array_equal(resp.freqs, f)


@pytest.mark.parametrize("n_keywords,r_max", [(1, 4), (2, 3), (3, 4), (3, 2)])
def test_cn_enumeration_matches_program(n_keywords, r_max):
    from repro_torch.core.candidate_network import enumerate_star_cns
    want = {(c.fact_mask, c.dim_masks, c.single_dim)
            for c in enumerate_star_cns(n_keywords, 3, r_max)}
    got = star.enumerate_cns(n_keywords, 3, r_max)
    assert len(got) == len(set(got))
    assert set(got) == want


def test_tables_repeat_from_the_seed():
    cfg = _tiny.config("tpch_sf1_zipf1", scale=0.02)
    a = tpch.generate(cfg, _tiny.SEED, "cpu")
    b = tpch.generate(cfg, _tiny.SEED, "cpu")
    c = tpch.generate(cfg, _tiny.SEED + 1, "cpu")
    for name in a:
        np.testing.assert_array_equal(a[name]["text"], b[name]["text"])
        for col in a[name]["keys"]:
            np.testing.assert_array_equal(a[name]["keys"][col],
                                          b[name]["keys"][col])
    assert not np.array_equal(a["LINEITEM"]["text"], c["LINEITEM"]["text"])
    # another seed holds the same rows in another order: the same work
    for name in a:
        rows_a = np.column_stack([a[name]["text"]]
                                 + [a[name]["keys"][k] for k in
                                    sorted(a[name]["keys"])])
        rows_c = np.column_stack([c[name]["text"]]
                                 + [c[name]["keys"][k] for k in
                                    sorted(c[name]["keys"])])
        if name == cfg["star"]["fact"]:
            assert sorted(map(tuple, rows_a)) == sorted(map(tuple, rows_c))
        else:               # a dimension's texts move against its keys
            assert sorted(map(tuple, a[name]["text"])) == sorted(
                map(tuple, c[name]["text"]))
    fact = a["LINEITEM"]
    for dim, key in cfg["star"]["dims"]:
        assert fact["keys"][key].dtype == np.int32
        assert 0 <= fact["keys"][key].min()
        assert fact["keys"][key].max() < cfg["rows"][dim]
    kws = cfg["planted"]["keywords"]
    for name, which in cfg["planted"]["relations"].items():
        for i in which:
            share = (a[name]["text"] == kws[i]).any(axis=1).mean()
            assert 0.2 < share < 0.4, (name, i, share)


@pytest.mark.parametrize("dist,key0", [({"dist": "uniform"}, 1 / 1000),
                                       ({"dist": "zipf", "z": 1.0}, None)])
def test_foreign_key_shares(dist, key0):
    gen = torch.Generator().manual_seed(5)
    keys = tpch.foreign_keys(1000, 200_000, dist, gen, "cpu")
    share = float((keys == 0).double().mean())
    if key0 is None:            # Zipf z 1: key 0 holds 1 / H(1000)
        key0 = 1 / sum(1 / r for r in range(1, 1001))
    assert abs(share - key0) < 0.1 * key0 + 3e-4
