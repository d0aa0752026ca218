"""Operation counts of one call on meta tensors: the port's counterpart of
the reference's ``launch/hlo_analysis.py``.

The reference compiles a program and walks its optimized HLO text.  PyTorch
runs eagerly and has no HLO, so nothing here parses program text: the
counts come from the aten operations one call runs, seen by a
``TorchDispatchMode`` (:func:`count`).  On ``meta`` tensors the call
allocates nothing and computes nothing, so a cell of any size can be
counted on a host.  For one call the counter records:

    flops        the formulas of ``torch.utils.flop_counter.FlopCounterMode``
                 (its ``flop_registry``, with its rule of decomposing an op
                 that has no formula): 2·M·N·K per matrix product, as the
                 reference counts per dot or convolution; elementwise work
                 counts 0 in both.  Equal to ``FlopCounterMode``'s total on
                 the same call when no loop is trip-counted.
    bytes        the operand and result bytes of each aten op.  Views and
                 metadata ops, and allocations that write nothing
                 (``empty``), count 0, as the reference's ``_SKIP_BYTES_OPS``
                 skip parameters, bitcasts and tuples.  Eager PyTorch has
                 no fusion, so these are the bytes eager moves op by op, not
                 what a fused program would move (the reference's count is
                 of XLA's fused program).
    peak_bytes   the most bytes held at once by storages the call allocated
                 and has not freed yet (each storage once, tracked by weak
                 references); the call's arguments are not in it.
    collectives  the virtual mesh's collectives (``launch/mesh.py``
                 ``collective_census``), by name.

Trip counts.  XLA's own cost analysis counts a while loop's body once; the
reference reads each loop's ``known_trip_count`` and scales the body.  The
port's loops are Python loops: the plain versions' block pairs
(``kernels/flash_attention/ref.py``), time steps (``kernels/lru_scan/ref.py``)
and WKV steps or chunks (``models/rwkv6.py``), tens of thousands of trips a
layer at the dry-run's shapes, and the model's repetitions of its unit of
layers (``models/model.py::forward``, the reference's scan).  Each iterates
over :func:`trips`: on CPU and CUDA tensors that is ``range(n)``, today's
path unchanged; on ``meta`` tensors (n >= 5) it runs four trips, the first
counted once, the second ``n - 3`` times and the last two once each.
Every op of those loops has the same shapes on every trip (a mask's values
differ from one block pair to the next, its shape does not), so one trip
stands for any other.  Four rather than one, so that the backward sees
what a full walk's does: a first trip whose carry needs no gradient, middle
trips that pass the carry's gradient on, and, after them, trips whose
gradients autograd sums into the loop's inputs first, so that each later
sum counts its producer's multiple.  A loop that keeps each trip's output
stacks them with :func:`stack_trips`, which counts the stack of ``n`` and
returns the full shape (lru_scan's stack of S steps is one meta tensor
``[B, S, W]``).  In a backward, each autograd node created in a trip runs
once and counts its trip's multiple (the node's ``metadata``, tagged as
the forward creates it); a unit recomputed under activation checkpointing
counts as its trip (:func:`replay_trips`).  The storages a middle trip
still holds when its loop ends count ``n - 3`` times from then on.

``tests/test_torch_dryrun.py`` holds this to full walks on meta: FLOPs and
bytes equal for each plain version's loops, forward and backward, and for
whole models' prefills (their peaks too) and train steps.  Two differences
are known.  The layers the model's trips skip get no parameter gradient in
a train step, and ``train/step.py::param_grads`` zero-fills one for each,
which adds a read and a write of those parameters' bytes (the test counts
them exactly).  Inside a loop the peak is read as the four trips run.

With meta tensors the plain versions run, never the kernels: ``"auto"``
dispatch takes the plain version off the card, as the reference's dry-run
on a CPU host took its ``ref`` path.  The counts are the plain versions' in
both packages.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import mesh

_TRIPS = threading.local()      # the active trips (see _stack), per thread
_META_KEY = "repro_torch.trips"  # autograd node metadata: (multiple, label)
_NO_BYTES = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
             torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
             torch.ops.aten.new_empty_strided.default}
# FlopCounterMode leaves these to the default dispatch (they are not ops on
# data); so does this counter
_SKIP = {torch.ops.aten.is_contiguous.default, torch.ops.aten.is_contiguous.memory_format,
         torch.ops.aten.is_strides_like_format.default,
         torch.ops.aten.is_non_overlapping_and_dense.default, torch.ops.aten.size.default,
         torch.ops.aten.sym_size.default, torch.ops.aten.stride.default,
         torch.ops.aten.sym_stride.default, torch.ops.aten.storage_offset.default,
         torch.ops.aten.sym_storage_offset.default, torch.ops.aten.numel.default,
         torch.ops.aten.sym_numel.default, torch.ops.aten.dim.default,
         torch.ops.prim.layout.default}


def _stack() -> List[list]:
    """The active trips, outermost first: ``[multiple, label, allocations
    or None]`` (a middle trip collects the storages allocated in it)."""
    if not hasattr(_TRIPS, "stack"):
        _TRIPS.stack = []
        _TRIPS.full = 0
        _TRIPS.counter = None
    return _TRIPS.stack


def _current() -> Tuple[int, Optional[str]]:
    """(product of the active trips' multiples, innermost label)."""
    mult, label = 1, None
    for m, lab, _ in _stack():
        mult *= m
        label = lab if lab is not None else label
    return mult, label


@contextlib.contextmanager
def trip_count(n: int, label: Optional[str] = None,
               allocations: Optional[list] = None) -> Iterator[None]:
    """Every op inside counts ``n`` times (nested blocks multiply), and its
    FLOPs are also tallied under ``label``."""
    stack = _stack()
    stack.append([int(n), label, allocations])
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def full_walk() -> Iterator[None]:
    """Inside, :func:`trips` runs every trip on meta tensors too (the
    tests' reference walk)."""
    _stack()
    _TRIPS.full += 1
    try:
        yield
    finally:
        _TRIPS.full -= 1


def trips(n: int, like: torch.Tensor, label: str):
    """The loop index of a loop of ``n`` trips over ``like``'s data:
    ``range(n)`` off meta; on meta, trips 0, 1, n - 2 and n - 1, counted
    once, ``n - 3`` times, once and once (see the module docstring)."""
    if not like.is_meta:
        return range(n)
    return _meta_trips(n, label)


def _meta_trips(n: int, label: str):
    _stack()
    if _TRIPS.full or n < 5:
        for t in range(n):
            with trip_count(1, label):
                yield t
        return
    held: list = []
    for t, mult, allocs in ((0, 1, None), (1, n - 3, held), (n - 2, 1, None),
                            (n - 1, 1, None)):
        with trip_count(mult, label, allocs):
            yield t
    if _TRIPS.counter is not None:   # what the middle trips would still hold
        _TRIPS.counter.scale_live(held, n - 3)


def replay_trips(fn: Callable) -> Callable:
    """``fn``, run under the trips active where it is wrapped: activation
    checkpointing re-runs a unit's forward in the backward, outside the
    loop that counted it, and the recompute counts as that trip's."""
    stack = [list(e) for e in _stack()]

    def replay(*args, **kwargs):
        saved = _TRIPS.stack
        _TRIPS.stack = [list(e) for e in stack]
        try:
            return fn(*args, **kwargs)
        finally:
            _TRIPS.stack = saved
    return replay


def stack_trips(steps: List[torch.Tensor], n: int,
                dim: int = 0) -> torch.Tensor:
    """``torch.stack`` of a loop's ``n`` per-trip outputs.  After a
    trip-counted loop (four outputs), the stack is counted as one of ``n``
    (the second output's part ``n - 3`` times) and its rows are assembled
    by ops that count 0 times, so the full shape comes out."""
    if len(steps) == n:
        return torch.stack(steps, dim)
    first, mid, *last = steps
    with trip_count(1):
        first = torch.stack([first], dim)
    with trip_count(n - 3):
        mid = torch.stack([mid], dim)
    with trip_count(1):
        last = torch.stack(last, dim)
    with trip_count(0):
        size = list(mid.shape)
        size[dim] = n - 3
        return torch.cat([first, mid.expand(size), last], dim)


@dataclasses.dataclass
class OpCounts:
    flops: float = 0.0
    bytes: float = 0.0
    peak_bytes: int = 0
    ops: int = 0
    flops_by_loop: Dict[str, float] = dataclasses.field(default_factory=dict)
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Tagger(TorchFunctionMode):
    """Tags each autograd node with the trips active when the forward
    created it (a node nothing tagged ran outside every trip)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_grad_enabled():
            tag = _current()
            for t in _tensors(out) + _tensors(args):
                _tag_graph(t.grad_fn, tag)
        return out


def _tag_graph(node, tag) -> None:
    todo = [node]
    while todo:
        node = todo.pop()
        if node is None or _META_KEY in node.metadata \
                or type(node).__name__ == "AccumulateGrad":
            continue
        node.metadata[_META_KEY] = tag
        todo.extend(nxt for nxt, _ in node.next_functions)


class _Counter(TorchDispatchMode):
    def __init__(self, counts: OpCounts):
        super().__init__()
        self.counts = counts
        self.live: Dict[int, list] = {}     # storage -> [bytes, serial]
        self.live_bytes = 0
        self.serial = 0
        self.views: Dict[object, bool] = {}   # op -> returns an alias

    def _free(self, key: int) -> None:
        entry = self.live.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[0]

    def _multiple(self) -> Tuple[int, Optional[str]]:
        node = torch._C._current_autograd_node()
        if node is not None and not torch.is_grad_enabled():   # a backward
            return node.metadata.get(_META_KEY, (1, None))
        return _current()          # a forward, or a recompute under remat

    def _aliases(self, func) -> bool:
        v = self.views.get(func)
        if v is None:
            v = self.views[func] = any(
                r.alias_info is not None for r in func._schema.returns)
        return v

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _SKIP:
            return func(*args, **kwargs)
        if func is not torch.ops.prim.device.default \
                and func._overloadpacket not in flop_registry:
            with self:          # FlopCounterMode's rule: decompose if it can
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        mult, label = self._multiple()
        c = self.counts
        c.ops += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            f = formula(*args, **kwargs, out_val=out) * mult
            c.flops += f
            if label is not None:
                c.flops_by_loop[label] = c.flops_by_loop.get(label, 0.0) + f
        if self._aliases(func):     # views, and ops writing into an operand
            if any(r.alias_info.is_write for r in func._schema.returns
                   if r.alias_info is not None):
                c.bytes += mult * (sum(map(_nbytes, _tensors((args, kwargs))))
                                   + sum(map(_nbytes, _tensors(out))))
            return out
        results = _tensors(out)
        if func not in _NO_BYTES:
            c.bytes += mult * (sum(map(_nbytes, _tensors((args, kwargs))))
                               + sum(map(_nbytes, results)))
        collectors = [e[2] for e in _stack() if e[2] is not None]
        for t in results:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                continue
            self.serial += 1
            self.live[key] = [st.nbytes(), self.serial]
            self.live_bytes += st.nbytes()
            weakref.finalize(st, self._free, key)
            for held in collectors:
                held.append((key, self.serial))
        c.peak_bytes = max(c.peak_bytes, self.live_bytes)
        return out

    def scale_live(self, held: List[Tuple[int, int]], mult: int) -> None:
        """The storages of ``held`` still alive stand for ``mult`` each."""
        for key, serial in held:
            entry = self.live.get(key)
            if entry is not None and entry[1] == serial:
                self.live_bytes += entry[0] * (mult - 1)
                entry[0] *= mult
        self.counts.peak_bytes = max(self.counts.peak_bytes, self.live_bytes)


def count(fn: Callable, *args, **kwargs):
    """Runs ``fn(*args, **kwargs)`` once under the counter; returns
    ``(its result, OpCounts)``."""
    counts = OpCounts()
    counter = _Counter(counts)
    _stack()
    outer, _TRIPS.counter = _TRIPS.counter, counter
    try:
        with mesh.collective_census() as census, _Tagger(), counter:
            out = fn(*args, **kwargs)
    finally:
        _TRIPS.counter = outer
    counts.collectives = dict(census)
    return out, counts
