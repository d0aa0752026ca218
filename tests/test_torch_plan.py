"""The port's host planner against the JAX package's: CN enumeration, tuple
sets and per-CN routing plans (send tables, device rows, balance, bounds,
store fingerprints) must be identical array for array, for the star, chain
and mix datasets, every scheduling mode, at P = 1 and P = 8 (planning is
host-only, so P = 8 needs no devices)."""
import numpy as np
import pytest

from repro.core import candidate_network as jax_cn
from repro.core import plan as jax_plan
from repro_torch.core import candidate_network as pt_cn
from repro_torch.core import plan as pt_plan
from repro_torch.core.shares import optimize_shares
from repro_torch.data.schema import schema_from_reference
from test_engine import _dataset


def _assert_route_equal(a, b):
    np.testing.assert_array_equal(a.send, b.send)
    assert a.send.dtype == b.send.dtype
    assert a.sent_rows == b.sent_rows
    assert a.key_cols == b.key_cols
    assert a.ref.uid == b.ref.uid
    assert a.ref.role == b.ref.role and a.ref.name == b.ref.name
    np.testing.assert_array_equal(a.ref.rows, b.ref.rows)
    np.testing.assert_array_equal(a.text, b.text)
    np.testing.assert_array_equal(a.keys, b.keys)


def _assert_plan_equal(a, b):
    assert vars(a.cn) == vars(b.cn)
    assert a.included == b.included
    assert a.shares == b.shares and a.rho == b.rho
    np.testing.assert_array_equal(a.schedule.task_to_device,
                                  b.schedule.task_to_device)
    np.testing.assert_array_equal(a.schedule.device_cost,
                                  b.schedule.device_cost)
    assert a.schedule.imbalance == b.schedule.imbalance
    _assert_route_equal(a.fact, b.fact)
    assert sorted(a.dims) == sorted(b.dims)
    for i in a.dims:
        _assert_route_equal(a.dims[i], b.dims[i])
    assert a.key_domains == b.key_domains
    assert (a.shuffle_rows, a.shuffle_bytes) == (b.shuffle_rows,
                                                  b.shuffle_bytes)
    np.testing.assert_array_equal(a.device_rows, b.device_rows)
    assert a.row_imbalance == b.row_imbalance
    assert a.contrib_bound == b.contrib_bound


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("mode", ["uniform", "skew", "round_robin",
                                  "adaptive"])
@pytest.mark.parametrize("qtype", ["star", "chain", "mix"])
def test_plans_identical(qtype, mode, P):
    sj, kws = _dataset(qtype)
    sp = schema_from_reference(sj)
    tj = jax_cn.TupleSets.build(sj, kws)
    tp = pt_cn.TupleSets.build(sp, kws)
    np.testing.assert_array_equal(tj.fact_kw, tp.fact_kw)
    for a, b in zip(tj.dim_kw, tp.dim_kw):
        np.testing.assert_array_equal(a, b)
    cj = jax_cn.prune_empty_cns(jax_cn.enumerate_star_cns(3, sj.m, 3), tj)
    cp = pt_cn.prune_empty_cns(pt_cn.enumerate_star_cns(3, sp.m, 3), tp)
    assert [vars(c) for c in cj] == [vars(c) for c in cp]
    n_joined = 0
    for a, b in zip(cj, cp):
        pj = jax_plan.build_cn_plan(sj, tj, a, P, mode=mode, rho=4)
        pp = pt_plan.build_cn_plan(sp, tp, b, P, mode=mode, rho=4)
        assert (pj is None) == (pp is None)
        if pj is not None:
            n_joined += 1
            _assert_plan_equal(pj, pp)
            assert pp.n_devices == P
    assert n_joined >= 3


def test_cn_enumeration_identical_across_sizes():
    for n_kw in (1, 2, 3):
        for r_max in (1, 2, 3, 4):
            a = jax_cn.enumerate_star_cns(n_kw, 3, r_max)
            b = pt_cn.enumerate_star_cns(n_kw, 3, r_max)
            assert [vars(c) for c in a] == [vars(c) for c in b]


def test_share_optimizer_identical():
    from repro.core.shares import optimize_shares as jax_optimize
    for sizes, k in (([40, 24, 32], 8), ([5, 500], 12), ([7], 64)):
        assert vars(jax_optimize(sizes, k, fact_size=300)) == \
            vars(optimize_shares(sizes, k, fact_size=300))
