"""MR¹ on the card: the hand-written kernels of ``kernels/mr1_volumes``
(num-arrays, fused probe and contributions, dimension volumes) against
their plain version, bit for bit, and the dispatch around them.

On the card (``cuda``-marked; they skip here): int32 and int64 volumes at
P 1 and 8 with m 1, 2 and 3 dimensions; key domains on both sides of the
shared-memory threshold (a probe block's shared contribution plane, or
device memory); every slot a pad (send -1); every fact key on one hot key;
negative and out-of-range keys (scatter-adds drop, gathers clamp);
products that wrap int32; and the three launches captured in a CUDA graph,
whose replays give the eager volumes, also after the inputs change in
place.  Inputs are routed by the port's own ``_route`` from random keys and
send tables, so pads and their clamped rows are as on the main path.

On the CPU: a CPU tensor takes the plain version, ``backend="cuda"``
raises on one, the engine's ``mr1_by_kernel`` is 0 on the CPU and counts
each group whose MR¹ took the kernel path once, eager, captured or
replayed (a capture stub as in ``tests/test_torch_graph_replay.py``), the
shared-memory decision follows the domains and the width, and the port's
lint passes on the new module.  Imports no JAX.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mr1_kernel.py
"""
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis.lint import lint_file
from repro_torch.api import FCTRequest, FCTSession
from repro_torch.core import fct as core_fct
from repro_torch.core.fct import _route
from repro_torch.kernels import _build
from repro_torch.kernels.mr1_volumes import kernel, ops, ref
from repro_torch.runtime.graphs import GraphCache
from test_torch_graph_replay import KWS, _engine, _schema

PACKAGE = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _routed(seed, N, P, domains, S=300, C=64, pad=0.3, key_range=None,
            fact_key=None, device="cpu"):
    """A CN batch's routed fact and dimensions, through ``_route``: random
    keys in ``key_range`` (default ``[0, domain)``) and send tables with a
    ``pad`` share of -1 slots; ``fact_key`` puts every fact key on it."""
    rng = np.random.default_rng(seed)
    m = len(domains)

    def send():
        s = rng.integers(0, S, (N, P, P, C)).astype(np.int32)
        s[rng.random(s.shape) < pad] = -1
        return torch.from_numpy(s).to(device)

    def keys(shape, dom, rng_):
        lo, hi = rng_ if rng_ is not None else (0, dom)
        return rng.integers(lo, hi, shape).astype(np.int32)

    fk = np.stack([keys((N, P, S), dom, key_range) for dom in domains],
                  axis=-1) if m else np.zeros((N, P, S, 0), np.int32)
    if fact_key is not None:
        fk[:] = fact_key
    fact = _route([torch.from_numpy(fk[n]).to(device) for n in range(N)],
                  send())
    dims = []
    for dom in domains:
        dk = keys((N, P, S), dom, key_range)
        dims.append(_route([torch.from_numpy(dk[n]).to(device)
                            for n in range(N)], send()))
    return fact, dims


def _held_to_plain(fact, dims, domains, dtype):
    """The kernels' volumes bit-equal to the plain version's on the same
    inputs, with three launches (one without dimensions)."""
    before = sum(kernel.LAUNCHES.values())
    got = ops.mr1_volumes(fact, dims, domains, dtype)
    want = ops.mr1_volumes(fact, dims, domains, dtype, backend="ref")
    torch.cuda.synchronize()
    assert got[0].dtype == want[0].dtype == dtype
    assert torch.equal(got[0], want[0])
    assert len(got[1]) == len(want[1]) == len(dims)
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)
    assert sum(kernel.LAUNCHES.values()) == before + (3 if dims else 1)
    return want


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc) to build and launch the "
                    "MR¹ kernels")
    return torch.device("cuda")


DTYPES = [torch.int32, torch.int64]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_kernels_match_plain_on_card(cuda_device, dtype, P, m):
    domains = [64, 48, 80][:m]
    fact, dims = _routed(P * 10 + m, 3, P, domains, C=128,
                         device=cuda_device)
    want = _held_to_plain(fact, dims, domains, dtype)
    assert (want[0] != 0).any() and all((v != 0).any() for v in want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_fact_alone_matches_plain_on_card(cuda_device, dtype):
    fact, dims = _routed(5, 2, 2, [], device=cuda_device)
    _held_to_plain(fact, dims, [], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_domains_on_both_sides_of_shared_threshold_on_card(cuda_device,
                                                           dtype):
    """The first domain fills ``SHARED_BYTES`` exactly (its plane in the
    probe block's shared memory), the second is twice that (device
    memory)."""
    fits = kernel.SHARED_BYTES // dtype.itemsize
    domains = [fits, 2 * fits]
    offsets, _ = kernel.shared_planes(domains, dtype.itemsize)
    assert offsets == [0, -1]
    fact, dims = _routed(7, 2, 1, domains, S=4000, C=4096,
                         device=cuda_device)
    _held_to_plain(fact, dims, domains, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P", [1, 8])
def test_every_slot_a_pad_on_card(cuda_device, dtype, P):
    domains = [64, 100, 30]
    fact, dims = _routed(11, 2, P, domains, pad=1.0, device=cuda_device)
    want = _held_to_plain(fact, dims, domains, dtype)
    assert not want[0].any() and not any(v.any() for v in want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("domains", [[64, 100, 30], [70000, 200000, 9]])
def test_every_fact_key_on_one_hot_key_on_card(cuda_device, dtype, domains):
    """Every fact slot adds to key 0 of every dimension: the warp's
    aggregated atomics (large domains) and the shared bins (small ones)."""
    fact, dims = _routed(13, 2, 1, domains, S=3000, C=4096, fact_key=0,
                         device=cuda_device)
    _held_to_plain(fact, dims, domains, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P", [1, 8])
def test_negative_and_out_of_range_keys_on_card(cuda_device, dtype, P):
    """Keys in ``[-400, 400)`` over domains 40, 17 and 300: a negative key
    counts from the end once, what stays outside drops in the scatter-adds
    and clamps in the gathers."""
    domains = [40, 17, 300]
    fact, dims = _routed(17, 2, P, domains, key_range=(-400, 400),
                         device=cuda_device)
    assert (fact[0] < -300).any() and (fact[0] >= 300).any()
    _held_to_plain(fact, dims, domains, dtype)


@pytest.mark.cuda
def test_products_that_wrap_int32_on_card(cuda_device):
    """Thousands of dimension rows on each of two keys: probes in the
    thousands, products of three past 2^31 wrap as the plain version's
    (int64 keeps them)."""
    domains = [2, 2, 2]
    fact, dims = _routed(19, 1, 1, domains, S=6000, C=8192, pad=0.0,
                         device=cuda_device)
    wrapped = _held_to_plain(fact, dims, domains, torch.int32)
    exact = _held_to_plain(fact, dims, domains, torch.int64)
    assert not torch.equal(wrapped[0].long(), exact[0])
    assert exact[0].max() > 2 ** 31


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_replay_in_a_cuda_graph_on_card(cuda_device, dtype):
    """The three launches captured in one CUDA graph: the capture holds
    back their launch counts, a replay gives the eager volumes, and a
    replay after the inputs change in place gives the new inputs'."""
    domains = [1024, 96, 5000]
    fact, dims = _routed(23, 2, 8, domains, device=cuda_device)
    want = _held_to_plain(fact, dims, domains, dtype)   # builds, warms up
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with _build.held_bumps() as held, torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            out = ops.mr1_volumes(fact, dims, domains, dtype)
    torch.cuda.current_stream().wait_stream(stream)
    probe, dimvol = kernel.INSTANTIATIONS[dtype]
    assert sorted(k for c, k in held if c is kernel.LAUNCHES) == sorted(
        [kernel.NUM, probe, dimvol])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], want[0])
    for g, w in zip(out[1], want[1]):
        assert torch.equal(g, w)
    new_fact, new_dims = _routed(29, 2, 8, domains, device=cuda_device)
    for (k, mk), (nk, nm) in zip([fact, *dims], [new_fact, *new_dims]):
        k.copy_(nk)
        mk.copy_(nm)
    graph.replay()
    want = ops.mr1_volumes(fact, dims, domains, dtype, backend="ref")
    torch.cuda.synchronize()
    assert torch.equal(out[0], want[0])
    for g, w in zip(out[1], want[1]):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 8])
def test_warm_groups_take_the_kernels_on_card(cuda_device, P):
    """A session on the card: every group's MR¹ counts in
    ``mr1_by_kernel``, eager, captured and replayed, no plain MR¹ runs, and
    each answer equals the CPU session's."""
    schema = _schema()
    req = FCTRequest(keywords=KWS, top_k=10, r_max=4)
    cpu = FCTSession(schema, device="cpu", n_workers=P, engine=_engine())
    want = cpu.query(req)
    cpu.close()
    session = FCTSession(schema, device=cuda_device, n_workers=P,
                         engine=_engine())
    ops.reset_path_counts()
    groups = 0
    for _ in range(3):
        resp = session.query(req)
        st = resp.engine_stats
        assert st["mr1_by_kernel"] == st["batches_run"] > 0
        groups += st["batches_run"]
        np.testing.assert_array_equal(resp.all_freqs, want.all_freqs)
        np.testing.assert_array_equal(resp.term_ids, want.term_ids)
    assert st["graph_replays"] == st["batches_run"]
    assert ops.PATH_COUNTS == {"ref": 0, "cuda": groups}
    session.close()


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_tensor_takes_plain_version(dtype):
    domains = [64, 100, 30]
    fact, dims = _routed(31, 2, 2, domains)
    ops.reset_path_counts()
    launches = dict(kernel.LAUNCHES)
    got = ops.mr1_volumes(fact, dims, domains, dtype)
    assert ops.PATH_COUNTS == {"ref": 1, "cuda": 0}
    assert kernel.LAUNCHES == launches
    want = ref.mr1_volumes(fact, dims, domains, dtype)
    assert torch.equal(got[0], want[0]) and got[0].dtype == dtype
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)


def test_cuda_backend_raises_on_cpu_tensor():
    domains = [64, 100]
    fact, dims = _routed(37, 1, 1, domains)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.mr1_volumes(fact, dims, domains, torch.int32, backend="cuda")
    with pytest.raises(ValueError, match="unknown mr1_volumes backend"):
        ops.mr1_volumes(fact, dims, domains, torch.int32, backend="tpu")


def test_mr1_by_kernel_present_and_zero_on_cpu():
    session = FCTSession(_schema(), device="cpu", engine=_engine())
    req = FCTRequest(keywords=KWS, top_k=10, r_max=4)
    ops.reset_path_counts()
    groups = 0
    for _ in range(2):
        st = session.query(req).engine_stats
        assert st["mr1_by_kernel"] == 0 and st["batches_run"] > 0
        groups += st["batches_run"]
    assert ops.PATH_COUNTS == {"ref": groups, "cuda": 0}
    session.close()


def test_mr1_by_kernel_counts_each_group_eager_captured_or_replayed(
        monkeypatch):
    """With MR¹'s kernel path stood in by the plain version bumping
    ``"cuda"`` and a capture stub whose replays run nothing: every group
    counts once, eagerly (first query), captured (second) and replayed
    (third), the replay adding what its capture held."""
    def as_kernel(fact, dims, domains, dtype):
        _build.bump(ops.PATH_COUNTS, "cuda")
        return ref.mr1_volumes(fact, dims, domains, dtype)

    def capture(fn, device):
        return types.SimpleNamespace(replay=lambda: None), fn()

    monkeypatch.setattr(core_fct, "mr1_volumes", as_kernel)
    eng = _engine(GraphCache(capture=capture, device_types=("cpu",)))
    session = FCTSession(_schema(), device="cpu", engine=eng)
    req = FCTRequest(keywords=KWS, top_k=10, r_max=4)
    ops.reset_path_counts()
    modes = []
    for _ in range(3):
        st = session.query(req).engine_stats
        modes.append((st["graph_eager"], st["graph_captures"],
                      st["graph_replays"]))
        assert st["mr1_by_kernel"] == st["batches_run"] > 0
    n = modes[0][0]
    assert modes == [(n, 0, 0), (0, n, 0), (0, 0, n)]
    assert ops.PATH_COUNTS == {"ref": 0, "cuda": 3 * n}
    session.close()


@pytest.mark.parametrize("dtype,itemsize", [(torch.int32, 4),
                                            (torch.int64, 8)])
def test_shared_planes_follow_domain_and_width(dtype, itemsize):
    """TPC-H SF1's bucketed domains (PART, SUPPLIER, ORDERS): SUPPLIER's
    plane alone fits a probe block's shared memory, at either width; the
    probe grid covers every fact slot of a plane."""
    assert kernel.shared_planes([262144, 16384, 2097152], itemsize) == (
        [-1, 0, -1], 16384)
    assert kernel.shared_planes([16, 16, 16], itemsize) == ([0, 16, 32], 48)
    limit = kernel.SHARED_BYTES // itemsize
    assert kernel.shared_planes([limit + 1, limit], itemsize) == (
        [-1, 0], limit)
    for planes, rows, shared in [(1, 8388608, 16384 * itemsize),
                                 (8, 524288, 0), (40, 8, 48 * itemsize),
                                 (3, 1, 0)]:
        chunks, per = kernel.probe_shape(planes, rows, shared)
        assert chunks >= 1 and per >= 1
        assert chunks * per >= rows > (chunks - 1) * per


def test_port_lint_clean_on_mr1_module():
    for path in sorted((PACKAGE / "kernels" / "mr1_volumes").glob("*.py")):
        rel = path.relative_to(PACKAGE).as_posix()
        violations, _ = lint_file(path, rel, rel)
        assert violations == [], [v.render() for v in violations]
