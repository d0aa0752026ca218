"""The port's data layer against the JAX package's: generated datasets,
keyword planting, tuple-set masks, host histograms and the tokenizer must be
array-for-array identical, since routing plans are compared bit for bit."""
import numpy as np
import pytest
import torch

from repro.data import schema as jax_schema
from repro.data import tokenizer as jax_tok
from repro.data import tpch as jax_tpch
from repro_torch.data import schema as pt_schema
from repro_torch.data import tokenizer as pt_tok
from repro_torch.data import tpch as pt_tpch


def _assert_relation_equal(a, b):
    assert a.name == b.name
    assert dict(a.key_domains) == dict(b.key_domains)
    assert list(a.keys) == list(b.keys)
    for col in a.keys:
        np.testing.assert_array_equal(a.keys[col], b.keys[col])
        assert a.keys[col].dtype == b.keys[col].dtype
    np.testing.assert_array_equal(a.text, b.text)
    assert a.text.dtype == b.text.dtype


def _assert_schema_equal(a, b):
    assert a.vocab_size == b.vocab_size
    _assert_relation_equal(a.fact, b.fact)
    assert len(a.dims) == len(b.dims)
    for da, db in zip(a.dims, b.dims):
        _assert_relation_equal(da, db)
    assert [(e.dim_name, e.fact_col, e.dim_col) for e in a.edges] == \
        [(e.dim_name, e.fact_col, e.dim_col) for e in b.edges]


def _cfgs(skew):
    kw = dict(fact_rows=300, part_rows=40, supp_rows=24, order_rows=32,
              cust_rows=24, text_len=6, vocab_size=128, seed=5, skew=skew)
    return jax_tpch.TpchConfig(**kw), pt_tpch.TpchConfig(**kw)


PLANT = {"PART": [100], "SUPPLIER": [101], "ORDERS": [102],
         "LINEITEM": [100, 102]}


@pytest.mark.parametrize("skew", [0.0, 1.0])
def test_generate_and_plant_identical(skew):
    cj, cp = _cfgs(skew)
    sj, sp = jax_tpch.generate(cj), pt_tpch.generate(cp)
    _assert_schema_equal(sj, sp)
    _assert_schema_equal(jax_tpch.plant_keywords(sj, PLANT, frac=0.35),
                         pt_tpch.plant_keywords(sp, PLANT, frac=0.35))


def test_customer_prejoin_identical():
    cj, cp = _cfgs(0.0)
    cust_j, cust_p = jax_tpch.generate_customer(cj), \
        pt_tpch.generate_customer(cp)
    _assert_relation_equal(cust_j, cust_p)
    orders = jax_tpch.generate(cj).dims[2]
    of = np.random.default_rng(3).integers(0, cust_j.rows, orders.rows)
    _assert_relation_equal(
        jax_tpch.prejoin_orders_customer(orders, cust_j, of),
        pt_tpch.prejoin_orders_customer(pt_tpch.generate(cp).dims[2],
                                        cust_p, of))


@pytest.mark.parametrize("skew", [0.0, 1.0])
def test_keyword_mask_and_histograms_identical(skew):
    cj, _ = _cfgs(skew)
    s = jax_tpch.plant_keywords(jax_tpch.generate(cj), PLANT, frac=0.35)
    w = np.random.default_rng(1).integers(0, 1000, s.fact.rows)
    for text in [s.fact.text] + [d.text for d in s.dims]:
        for kws in ([100], [100, 101, 102], [102, 7]):
            np.testing.assert_array_equal(jax_schema.keyword_mask(text, kws),
                                          pt_schema.keyword_mask(text, kws))
        np.testing.assert_array_equal(jax_schema.count_token(text, 100),
                                      pt_schema.count_token(text, 100))
    np.testing.assert_array_equal(
        jax_schema.tokens_histogram(s.fact.text, w, 128),
        pt_schema.tokens_histogram(s.fact.text, w, 128))


def test_schema_from_reference_copies_every_array():
    cj, cp = _cfgs(1.0)
    sj = jax_tpch.plant_keywords(jax_tpch.generate(cj), PLANT, frac=0.35)
    copied = pt_schema.schema_from_reference(sj)
    assert isinstance(copied, pt_schema.StarSchema)
    _assert_schema_equal(sj, copied)
    assert copied.fact.text is not sj.fact.text      # a copy, not a view
    _assert_schema_equal(
        pt_tpch.plant_keywords(pt_tpch.generate(cp), PLANT, frac=0.35),
        copied)


def test_as_device_arrays_on_cpu():
    _, cp = _cfgs(0.0)
    rel = pt_tpch.generate(cp).fact
    out = pt_schema.as_device_arrays(rel, "cpu")
    assert out["text"].dtype == torch.int32 and out["text"].device.type == "cpu"
    np.testing.assert_array_equal(out["text"].numpy(), rel.text)
    np.testing.assert_array_equal(out["key:partkey"].numpy(),
                                  rel.keys["partkey"])


def test_tokenizer_identical():
    texts = ["The Alps and Bordeaux", "express freight of the azure parts",
             "", "x_1 y2 Z3 a an the polished"]
    tj, tp = jax_tok.HashingTokenizer(4096), pt_tok.HashingTokenizer(4096)
    np.testing.assert_array_equal(tj.encode_batch(texts, 6),
                                  tp.encode_batch(texts, 6))
    np.testing.assert_array_equal(tj.stop_mask(), tp.stop_mask())
    ids = tp.encode_batch(texts, 6).reshape(-1)
    tj.encode_batch(texts, 6)
    assert [tj.decode(t) for t in ids] == [tp.decode(t) for t in ids]
