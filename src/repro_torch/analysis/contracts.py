"""Layer 2: runtime contract checker for the FCT program families.

The AST lint (layer 1) polices *source* invariants; this module checks the
invariants of the programs the engine runs.  The JAX package traces its
families to jaxprs; the port's families are eager torch code with no
program to trace, so the checker RUNS each family once, on small real
inputs of a representative ``PlanSignature`` (zero texts, a few valid send
rows, on the mesh's device), and observes the run: the families are
``fct_store`` / ``fct_store_percn`` (device-resident columns; their three
stages run eagerly, in order, as the engine runs a group) and the
``fct_topk`` finalize family (device top-k over the aggregated histogram).
On a CUDA mesh their histograms go through the ``fct_count`` kernel and
their MR¹ through the ``mr1_volumes`` kernels; on the CPU through their
plain versions.

C1 (collective census)
    Every movement across the virtual mesh's workers goes through a named
    function of :mod:`repro_torch.launch.mesh`, counted by a
    :func:`~repro_torch.launch.mesh.collective_census` around the run.
    Exactly ONE reduction per dispatch: ``psum_scatter`` under
    reduce-scatter at P > 1, ``psum`` otherwise.  The routing stage makes
    exactly ``1 + m`` ``all_to_all``\\ s: one swap of a relation's send
    table routes its text, keys and mask together, where the JAX package's
    program moves the three buffers separately, ``3 * (1 + m)``.  Nothing
    else moves data across workers.  A second reduction means someone
    re-aggregated an already-aggregated histogram.

C2 (integer closure)
    No floating-point tensor anywhere in the run: a
    ``TorchDispatchMode`` records the output dtype of every aten op.  The
    kernel's own launch (a ctypes call) is invisible to the mode, but its
    output allocation is not.  A single f32 intermediate reintroduces
    silent rounding exactly where the AccumPolicy promises exactness.

C3 (transfer budget)
    The program's output is the histogram and nothing else, in the
    policy's dtype, with the aggregation layout's element count:
    ``vocab_padded(vocab, P)`` under reduce-scatter (each worker owns
    ``vocab/P`` bins), exactly ``vocab`` under psum, with a leading
    ``n_stack`` axis for the per-CN families.  ``fct_topk`` returns O(k):
    ``k_eff`` counts, ``k_eff`` int32 ids and one int32 wrap flag,
    ``2 * k_eff + 1`` elements.

C4 (bucketing)
    Every data-dependent dim (rows, send capacity, text width, key domain)
    is a power of two no smaller than ``BUCKET_MIN``, the per-CN families'
    stack axis is a multiple of ``CN_BUCKET_MIN``, and ``fct_topk``'s
    ``k_bucket`` / keyword width follow ``TOPK_BUCKET_MIN`` /
    ``KW_BUCKET_MIN`` — the shape lattice that keeps the program cache
    finite.

For ``fct_topk`` C1 pins the merge: no reduction, and under
reduce-scatter at P > 1 exactly one ``all_gather`` (of the counts and ids
together; the JAX package gathers values, ids and wrap flags, three),
none otherwise — the port computes the wrap flag over the whole histogram,
so no flag is gathered.

``check_all_contracts()`` runs every family under both policies at P = 1
and P = 8 on one device and returns human-readable failure strings —
empty means the contracts hold.  Corrupting the program (a float
accumulator, a second reduction, an O(vocab) top-k output) must flip it
red: ``tests/test_torch_analysis.py`` does exactly that.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core.accum import INT32_CHECKED, INT64_EXACT, AccumPolicy
from repro_torch.launch.mesh import (VirtualMesh, collective_census,
                                     make_worker_mesh, vocab_padded)
from repro_torch.runtime.batch import BUCKET_MIN, PlanSignature, RelationSig

#: reductions C1 counts (census names)
REDUCTIONS = ("psum", "psum_scatter")

KINDS = ("fct_store", "fct_store_percn")

#: worker counts ``check_all_contracts`` runs when no mesh is given
MESH_SIZES = (1, 8)


class FloatLog(TorchDispatchMode):
    """Records every aten op whose output holds a floating-point tensor."""

    def __init__(self) -> None:
        super().__init__()
        self.floats: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and (t.is_floating_point()
                                                or t.is_complex()):
                self.floats.append(f"{func} -> {t.dtype}{list(t.shape)}")
        return out


# ---------------------------------------------------------------------------
# representative signatures and small real arguments
# ---------------------------------------------------------------------------

def representative_signatures(n_devices: int,
                              policies: Sequence[AccumPolicy]
                              ) -> List[PlanSignature]:
    """One small and one wide bucket per policy, as the JAX package's.

    The small bucket's vocab (100) is deliberately NOT a multiple of P>1 so
    the reduce-scatter vocab pad is exercised; the wide one (512) divides
    any pow-2 P evenly.  m=1 and m=2 cover the single- and multi-dimension
    routing shapes; ``key_width=2`` makes the store path's column gather
    non-trivial.
    """
    sigs = []
    for accum in policies:
        sigs.append(PlanSignature(
            n_devices=n_devices, vocab=100,
            fact=RelationSig(rows=16, cap=8, text_len=8, key_width=2),
            dims=(RelationSig(rows=8, cap=8, text_len=8, domain=8),),
            accum=accum))
        sigs.append(PlanSignature(
            n_devices=n_devices, vocab=512,
            fact=RelationSig(rows=32, cap=16, text_len=16, key_width=2),
            dims=(RelationSig(rows=16, cap=8, text_len=8, domain=16),
                  RelationSig(rows=8, cap=8, text_len=8, domain=8)),
            accum=accum))
    return sigs


def _send_table(n_stack: int, p: int, rsig: RelationSig) -> np.ndarray:
    """``[N, P, P, cap]`` int32, ``-1`` but one valid row per (src, dst)
    pair: sparse, in range, different rows for different pairs."""
    send = np.full((n_stack, p, p, rsig.cap), -1, np.int32)
    src, dst = np.meshgrid(np.arange(p), np.arange(p), indexing="ij")
    send[:, :, :, 0] = (src + dst) % rsig.rows
    return send


def store_args(sig: PlanSignature, n_stack: int, device: torch.device):
    """Arguments shaped as ``store_group_args``'s, all on the device: per
    relation, ``n_stack`` resident ``[P, S, ...]`` columns and ``n_stack``
    ``[1, P, P, cap]`` send tables; the fact adds ``n_stack`` ``[1, m]``
    key-column indices."""
    p = sig.n_devices

    def per_cn(array: np.ndarray) -> List[torch.Tensor]:
        return list(torch.from_numpy(array).to(device).split(1))

    def rel(rsig: RelationSig, key_tail: Tuple[int, ...]) -> Dict:
        text = torch.zeros((p, rsig.rows, rsig.text_len), dtype=torch.int32,
                           device=device)
        keys = torch.zeros((p, rsig.rows) + key_tail, dtype=torch.int32,
                           device=device)
        return {"text": [text] * n_stack, "keys": [keys] * n_stack,
                "send": per_cn(_send_table(n_stack, p, rsig))}

    fact = rel(sig.fact, (sig.fact.key_width,))
    fact["cols"] = per_cn(np.tile(
        np.arange(sig.m, dtype=np.int32) % sig.fact.key_width, (n_stack, 1)))
    return fact, [rel(r, ()) for r in sig.dims]


def _input_floats(args) -> List[str]:
    """Floating-point tensors among a family's arguments."""
    return [f"input {leaf.dtype}{list(leaf.shape)}"
            for leaf in tree_leaves(args)
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]


def run_family(kind: str, sig: PlanSignature, n_stack: int,
               mesh: VirtualMesh):
    """Builds one histogram family as the engine does (same builder, same
    aggregation choice) and runs its stages once, eagerly, in the order the
    engine's loop runs them (``_stage_steps``), on small real arguments.
    Returns ``(output, census, floats)``: the census counts of the run and
    every floating-point value the run made or was given."""
    from repro_torch.runtime import engine

    # mirrors FCTEngine._dispatch_group: reduce-scatter only on
    # multi-worker meshes
    program = engine._build_stages(sig, not kind.endswith("percn"),
                                   sig.n_devices > 1)
    args = store_args(sig, n_stack, mesh.device)
    log = FloatLog()
    with collective_census() as census, log:
        *_, out = engine._stage_steps(program, *args)
    return out, census, _input_floats(args) + log.floats


# ---------------------------------------------------------------------------
# the contracts
# ---------------------------------------------------------------------------

def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def _census_failures(tag: str, census: Dict[str, int],
                     want: Dict[str, int], why: Dict[str, str]) -> List[str]:
    """C1: each collective counted as often as ``want`` says (0 where it is
    not named); ``why`` explains a miscount by name."""
    failures = []
    reductions = sum(census[n] for n in REDUCTIONS)
    want_red = sum(want.get(n, 0) for n in REDUCTIONS)
    got_red = {n: census[n] for n in REDUCTIONS if census[n]}
    if reductions != want_red:
        failures.append(
            f"{tag} C1: {reductions} reductions ({got_red}), expected "
            f"{want_red} — {why['reduction']}")
    elif any(census[n] != want.get(n, 0) for n in REDUCTIONS):
        failures.append(f"{tag} C1: aggregation by {got_red}, expected "
                        f"{ {n: c for n, c in want.items() if n in REDUCTIONS} }")
    for name, n in census.items():
        if name not in REDUCTIONS and n != want.get(name, 0):
            failures.append(
                f"{tag} C1: {n} {name}(s), expected {want.get(name, 0)} — "
                f"{why.get(name, 'unexpected collective')}")
    return failures


def check_contract(kind: str, sig: PlanSignature, n_stack: int,
                   mesh: VirtualMesh) -> List[str]:
    """Check C1-C4 for one (family, signature) pair; returns failure strings
    prefixed ``kind[P=..,vocab=..,m=..,policy]``."""
    from repro_torch.runtime.engine import CN_BUCKET_MIN

    tag = (f"{kind}[P={sig.n_devices},vocab={sig.vocab},m={sig.m},"
           f"{sig.accum.name}]")
    failures: List[str] = []
    reduce_cns = not kind.endswith("percn")
    rs = sig.n_devices > 1

    # C4 first — a malformed signature makes the other checks meaningless
    for label, rsig in [("fact", sig.fact)] + [
            (f"dim{i}", r) for i, r in enumerate(sig.dims)]:
        for dim_name, value in (("rows", rsig.rows), ("cap", rsig.cap),
                                ("text_len", rsig.text_len)):
            if dim_name == "text_len" and value == 0:
                continue        # a relation that carries no text
            if not (_is_pow2(value) and value >= BUCKET_MIN):
                failures.append(
                    f"{tag} C4: {label}.{dim_name}={value} is not a power "
                    f"of two >= BUCKET_MIN={BUCKET_MIN} (signature escaped "
                    f"bucket_pow2)")
        if rsig.domain and not _is_pow2(rsig.domain):
            failures.append(
                f"{tag} C4: {label}.domain={rsig.domain} is not a power of "
                f"two (signature escaped bucket_pow2)")
    if not reduce_cns and n_stack % CN_BUCKET_MIN:
        failures.append(
            f"{tag} C4: per-CN stack axis n_stack={n_stack} is not a "
            f"multiple of CN_BUCKET_MIN={CN_BUCKET_MIN} — every window "
            f"composition builds a fresh program variant")
    if failures:
        return failures

    try:
        out, census, floats = run_family(kind, sig, n_stack, mesh)
    except Exception as exc:  # a family that cannot run is a failure too
        return [f"{tag} run failed: {type(exc).__name__}: {exc}"]

    # C1: collective census
    expected = "psum_scatter" if rs else "psum"
    failures += _census_failures(
        tag, census, {expected: 1, "all_to_all": 1 + sig.m},
        {"reduction": f"exactly one {expected} at P={sig.n_devices}; a "
                      f"second aggregation double-counts",
         "all_to_all": "one send-table swap per relation; the routing "
                       "stage grew extra shuffles"})

    # C2: integer closure
    if floats:
        failures.append(
            f"{tag} C2: {len(floats)} floating-point value(s) in an "
            f"integer-exact program (first: {floats[0]}) — the "
            f"{sig.accum.name} policy promises exact counts")

    # C3: transfer budget
    if not isinstance(out, torch.Tensor):
        failures.append(f"{tag} C3: output {type(out).__name__}, expected "
                        f"the histogram alone")
    else:
        vocab_axis = vocab_padded(sig.vocab, sig.n_devices) if rs \
            else sig.vocab
        want = (vocab_axis,) if reduce_cns else (n_stack, vocab_axis)
        got = tuple(out.shape)
        if got != want:
            failures.append(
                f"{tag} C3: output shape {got}, expected {want} "
                f"({'vocab-sharded, O(vocab/P) per worker' if rs else 'replicated vocab'})")
        if out.dtype != sig.accum.dtype:
            failures.append(
                f"{tag} C3: output dtype {out.dtype} does not advertise the "
                f"accumulation policy ({sig.accum.name} -> "
                f"{sig.accum.dtype})")
        if out.device != mesh.device:
            failures.append(f"{tag} C3: output on {out.device}, expected "
                            f"the mesh's device {mesh.device}")
    return failures


def check_topk_contract(sig: PlanSignature, mesh: VirtualMesh,
                        kw_pad: Optional[int] = None) -> List[str]:
    """C1-C4 variant for the ``fct_topk`` finalize family.

    The family's whole reason to exist is C3: its outputs are O(k), not
    O(vocab/P) — ``k_eff`` counts in the policy dtype, ``k_eff`` int32 term
    ids and one int32 overflow flag, ``2 * k_eff + 1`` elements total.  C1
    pins the merge topology: under reduce-scatter at P > 1 exactly one
    ``all_gather`` over the small k axis and no reduction; on one shard
    (psum layout or P = 1) no collective at all.  C2 and C4 (pow-2
    ``k_bucket`` and keyword width) carry over.
    """
    from repro_torch.runtime import engine

    rs = sig.n_devices > 1
    if kw_pad is None:
        kw_pad = engine.KW_BUCKET_MIN
    tag = (f"fct_topk[P={sig.n_devices},vocab={sig.vocab},"
           f"k_bucket={sig.k_bucket},{sig.accum.name}]")
    failures: List[str] = []

    # C4: the k axis must ride the same bucket lattice as every other
    # data-dependent dim, or the program cache grows per distinct k
    if not (_is_pow2(sig.k_bucket) and sig.k_bucket >= engine.TOPK_BUCKET_MIN):
        failures.append(
            f"{tag} C4: k_bucket={sig.k_bucket} is not a power of two >= "
            f"TOPK_BUCKET_MIN={engine.TOPK_BUCKET_MIN} (signature escaped "
            f"bucket_pow2)")
    if not (_is_pow2(kw_pad) and kw_pad >= engine.KW_BUCKET_MIN):
        failures.append(
            f"{tag} C4: kw_pad={kw_pad} is not a power of two >= "
            f"KW_BUCKET_MIN={engine.KW_BUCKET_MIN}")
    if failures:
        return failures

    vp = vocab_padded(sig.vocab, sig.n_devices) if rs else sig.vocab
    k_eff = engine.k_effective(sig)
    dev = mesh.device
    hist = torch.zeros((vp,), dtype=sig.accum.dtype, device=dev)
    kw = np.full((kw_pad,), -1, np.int32)
    excl = torch.zeros((vp,), dtype=torch.int8, device=dev)
    log = FloatLog()
    try:
        fn = engine._build_topk_fn(sig, mesh, rs)
        with collective_census() as census, log:
            outs = fn(hist, kw, excl)
    except Exception as exc:
        return [f"{tag} run failed: {type(exc).__name__}: {exc}"]

    # C1: merge topology
    failures += _census_failures(
        tag, census, {"all_gather": 1 if rs else 0},
        {"reduction": "the histogram is already aggregated; a second "
                      "reduction double-counts",
         "all_gather": "one gather of the (count, id) candidates over the "
                       "k axis" + ("" if rs else "; one shard needs none")})

    # C2: integer closure
    if log.floats:
        failures.append(
            f"{tag} C2: {len(log.floats)} floating-point value(s) in an "
            f"integer-exact program (first: {log.floats[0]})")

    # C3: O(k) transfer budget
    outs = tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)
    want_shapes = ((k_eff,), (k_eff,), ())
    got_shapes = tuple(tuple(o.shape) for o in outs)
    if got_shapes != want_shapes:
        failures.append(
            f"{tag} C3: output shapes {got_shapes}, expected {want_shapes} "
            f"(counts[k_eff], ids[k_eff], wrap flag)")
    else:
        total = sum(int(o.numel()) for o in outs)
        if total != 2 * k_eff + 1:
            failures.append(
                f"{tag} C3: {total} output elements, expected "
                f"{2 * k_eff + 1} — the device->host transfer must stay "
                f"O(k), not O(vocab/P)")
        if outs[0].dtype != sig.accum.dtype:
            failures.append(
                f"{tag} C3: counts dtype {outs[0].dtype} does not advertise "
                f"the accumulation policy ({sig.accum.name} -> "
                f"{sig.accum.dtype})")
        if any(o.dtype != torch.int32 for o in outs[1:]):
            failures.append(
                f"{tag} C3: ids/wrap dtypes "
                f"{[str(o.dtype) for o in outs[1:]]}, expected int32")
    return failures


def check_all_contracts(mesh: Optional[VirtualMesh] = None,
                        policies: Optional[Sequence[AccumPolicy]] = None,
                        device=None) -> Tuple[List[str], int]:
    """Run C1-C4 for all three families over the representative signature
    buckets; returns (failures, programs_checked).

    ``policies`` defaults to both policies (torch needs no flag for int64).
    ``mesh`` defaults to a virtual mesh of each of :data:`MESH_SIZES` on
    ``device`` (``None`` = CUDA; raises without a card).
    """
    from repro_torch.runtime.engine import CN_BUCKET_MIN, topk_signature

    if policies is None:
        policies = [INT32_CHECKED, INT64_EXACT]
    meshes = [mesh] if mesh is not None else [
        make_worker_mesh(p, device) for p in MESH_SIZES]
    failures: List[str] = []
    checked = 0
    for m in meshes:
        for sig in representative_signatures(m.size, policies):
            for kind in KINDS:
                n_stack = CN_BUCKET_MIN if kind.endswith("percn") else 2
                failures.extend(check_contract(kind, sig, n_stack, m))
                checked += 1
        # the fct_topk finalize family, over the same two vocab buckets
        # (100 exercises the reduce-scatter vocab pad at P>1, 512 divides
        # evenly)
        for accum in policies:
            for vocab in (100, 512):
                tsig = topk_signature(vocab, m.size, accum, k=10)
                failures.extend(check_topk_contract(tsig, m))
                checked += 1
    return failures, checked
