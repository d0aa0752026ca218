"""The port's fused MR¹+MR² device program (core/fct.py) on the virtual
mesh, held against the JAX package's ``run_cn_plan`` at P = 1 and against the
``fct_star`` oracle, at P = 1 and P = 8, under both accumulation policies,
including a crafted int32 overflow that must wrap to the reference's bits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import candidate_network as jax_cn
from repro.core.fct import run_cn_plan as jax_run_cn_plan
from repro.core.plan import build_cn_plan as jax_build_cn_plan
from repro.core.star import fct_star
from repro.data.schema import JoinEdge, Relation, StarSchema
from repro.launch.mesh import make_worker_mesh as jax_worker_mesh
from repro_torch.core import candidate_network as pt_cn
from repro_torch.core.accum import INT32_CHECKED, INT64_EXACT
from repro_torch.core.fct import _route, _routed_text, run_cn_plan
from repro_torch.core.plan import build_cn_plan
from repro_torch.data.schema import schema_from_reference, tokens_histogram
from repro_torch.kernels.mr1_volumes.ref import clamp_index, scatter_add_drop
from repro_torch.launch.mesh import make_worker_mesh
from test_engine import _dataset


def overflow_schema(n_dim=2000, n_fact=10):
    """One joined CN, F^{} ⋈ D0^{a} ⋈ D1^{b} ⋈ D2^{c}, every key 0: each
    fact row's volume is n_dim^3 (8e9, past 2^31) and each dim row's is
    n_fact·n_dim^2, so int32 volumes and totals wrap and int64 ones do
    not."""
    kws = [60, 61, 62]
    dims = []
    for i, kw in enumerate(kws):
        text = np.full((n_dim, 2), 5 + i, np.int32)
        text[:, 1] = kw
        dims.append(Relation(f"D{i}", keys={f"k{i}": np.zeros(n_dim, np.int32)},
                             key_domains={f"k{i}": 4}, text=text))
    fact = Relation("F", keys={f"k{i}": np.zeros(n_fact, np.int32)
                               for i in range(3)},
                    key_domains={f"k{i}": 4 for i in range(3)},
                    text=np.full((n_fact, 2), 9, np.int32))
    edges = [JoinEdge(f"D{i}", f"k{i}", f"k{i}") for i in range(3)]
    return StarSchema(fact=fact, dims=dims, edges=edges, vocab_size=64), kws


def _cn_pairs(sj, kws, r_max):
    sp = schema_from_reference(sj)
    tj = jax_cn.TupleSets.build(sj, kws)
    tp = pt_cn.TupleSets.build(sp, kws)
    cj = jax_cn.prune_empty_cns(jax_cn.enumerate_star_cns(len(kws), sj.m,
                                                          r_max), tj)
    cp = pt_cn.prune_empty_cns(pt_cn.enumerate_star_cns(len(kws), sp.m,
                                                        r_max), tp)
    return sp, tj, tp, list(zip(cj, cp))


@pytest.mark.parametrize("qtype", ["star", "mix"])
def test_run_cn_plan_matches_reference_and_oracle(qtype):
    sj, kws = _dataset(qtype)
    sp, tj, tp, pairs = _cn_pairs(sj, kws, 3)
    jmesh = jax_worker_mesh(1)
    mesh1, mesh8 = make_worker_mesh(1, "cpu"), make_worker_mesh(8, "cpu")
    totals = {k: np.zeros(sj.vocab_size, np.int64)
              for k in ("p1", "p8", "i64")}
    joined = 0
    for a, b in pairs:
        pj = jax_build_cn_plan(sj, tj, a, 1)
        if pj is None:
            fact_idx, dim_idx = tp.cn_rows(b)
            if fact_idx is not None:
                text = sp.fact.text[fact_idx]
            else:
                (i, rows), = dim_idx.items()
                text = sp.dims[i].text[rows]
            for k in totals:
                totals[k] += tokens_histogram(
                    text, np.ones(text.shape[0], np.int64), sp.vocab_size)
            continue
        joined += 1
        want = jax_run_cn_plan(pj, jmesh)
        p1 = build_cn_plan(sp, tp, b, 1)
        got = run_cn_plan(p1, mesh1)
        np.testing.assert_array_equal(got, want)
        totals["p1"] += got
        p8 = build_cn_plan(sp, tp, b, 8, mode="skew", rho=4)
        got8 = run_cn_plan(p8, mesh8, accum=INT32_CHECKED)
        np.testing.assert_array_equal(got8, want)
        totals["p8"] += got8
        totals["i64"] += run_cn_plan(build_cn_plan(sp, tp, b, 8), mesh8,
                                     accum=INT64_EXACT)
    assert joined >= 3
    oracle = fct_star(sj, kws, 3)
    for k, v in totals.items():
        v[0] = 0
        np.testing.assert_array_equal(v, oracle, err_msg=k)


def test_crafted_int32_overflow_wraps_to_reference_bits():
    sj, kws = overflow_schema()
    sp, tj, tp, pairs = _cn_pairs(sj, kws, 4)
    (a, b), = [(a, b) for a, b in pairs if a.single_dim < 0 and a.included]
    want = jax_run_cn_plan(jax_build_cn_plan(sj, tj, a, 1),
                           jax_worker_mesh(1))
    assert (want < 0).any()                    # the reference wrapped
    for P in (1, 8):
        plan = build_cn_plan(sp, tp, b, P)
        mesh = make_worker_mesh(P, "cpu")
        np.testing.assert_array_equal(run_cn_plan(plan, mesh), want)
        exact = run_cn_plan(plan, mesh, accum=INT64_EXACT)
        exact[0] = 0
        np.testing.assert_array_equal(exact, fct_star(sj, kws, 4))
        assert exact.max() > 2 ** 33


def test_index_helpers_follow_jax_semantics():
    idx = np.array([-1, 7, 2, -9], np.int64)
    x = jnp.arange(5) * 10
    got = (torch.arange(5) * 10)[clamp_index(torch.from_numpy(idx), 5)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(x[idx]))
    want = np.asarray(jnp.zeros(5, jnp.int32).at[idx].add(3, mode="drop"))
    t = torch.zeros(5, dtype=torch.int32)
    scatter_add_drop(t, 0, torch.from_numpy(idx),
                     torch.full((4,), 3, dtype=torch.int32))
    np.testing.assert_array_equal(t.numpy(), want)


def test_route_is_gather_then_all_to_all_with_masked_slots():
    """Routing moves keys and masks; the text the reference routes beside
    them is the two-job path's explicit gather (``_routed_text``), and the
    fused MR² reads the same rows by reference."""
    rng = np.random.default_rng(3)
    P, S, L, C, m = 3, 5, 4, 4, 2
    text = rng.integers(1, 50, (P, S, L)).astype(np.int32)
    keys = rng.integers(0, 9, (P, S, m + 1)).astype(np.int32)
    send = rng.integers(-1, S, (P, P, C)).astype(np.int32)   # -1 = empty slot
    cols = np.array([[2, 0]], np.int32)
    rkeys, mask = _route([torch.from_numpy(keys)],
                         torch.from_numpy(send)[None],
                         torch.from_numpy(cols))
    rtext = _routed_text([torch.from_numpy(text)],
                         torch.from_numpy(send)[None])
    assert rtext.shape == (1, P, P * C, L) and rkeys.shape == (1, P, P * C, m)
    for dst in range(P):
        for src in range(P):
            for c in range(C):
                j, row = src * C + c, send[src, dst, c]
                assert bool(mask[0, dst, j]) == (row >= 0)
                if row >= 0:
                    np.testing.assert_array_equal(rtext[0, dst, j].numpy(),
                                                  text[src, row])
                    np.testing.assert_array_equal(rkeys[0, dst, j].numpy(),
                                                  keys[src, row][[2, 0]])
