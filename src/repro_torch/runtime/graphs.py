"""CUDA graphs of the engine's repeating signature groups.

A group's device program (``core/fct.py``, run by the engine's
``fct_store`` families in three stages) is hundreds of small aten launches
and one ``fct_count`` launch per relation, enqueued from Python one by
one.  Its inputs are resident tensors that come back dispatch after
dispatch: the store's columns, each memoized plan's send tables and
key-column indices, and the null CN send table.  :class:`GraphCache` captures such a group's
three stages (routing, MR¹, and MR² with the cross-CN and worker
aggregation) as three CUDA graphs, so that a warm dispatch enqueues three
graph launches and one copy instead.  The kernels are the same, in the same
order: replayed answers are bit-identical to eager ones.

**When.**  :meth:`GraphCache.decide` looks at the group's inputs:

* inputs it has not seen: the group runs eagerly, and the cache remembers
  them by weak references;
* a later dispatch of the very same live objects: capture, then replay;
* every dispatch after that: replay.

Inputs that differ (a store eviction, an append that re-assembles a chunk,
a plan dropped and planned anew, a batch of another composition) run
eagerly.  Identity is held by weak references, never by data pointers, so
a freed and reused address cannot match, and an entry is dropped, graphs
and all, when one of its inputs dies.  Only CUDA devices capture
(``device_types``); a storeless call's store of its own dies with the
call, so its groups never capture.

**Memory.**  Every capture of a cache goes into one memory pool per device
(:class:`CudaCapture`).  A group keeps only its final output: the routed
buffers and volumes between its graphs go back to the pool once its three
graphs are captured, and later captures reuse them.  That is safe because a
group's three replays and the copy of its output run back to back on one
stream under :attr:`GraphCache.lock`, each replay writes every pool block
it reads before reading it, and nothing outside the replays reads the pool.
The copy takes the answer out of the pool right after the MR² replay, so a
later replay of the same group cannot overwrite an answer not yet
collected.

**Counts.**  Capturing launches nothing, yet the stages' Python still bumps
the kernels' ``LAUNCHES`` and the ops' ``PATH_COUNTS`` and tallies their
collectives.  The capture holds those back (``kernels/_build.held_bumps``
and a census of its own) and each replay adds them once
(:meth:`GroupGraphs.replay`), so the counts stay counts of work run.
"""
from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.launch.mesh import add_to_census, collective_census

#: how a group ran: the ``graph`` arg of ``engine.dispatch_group``
EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"
#: stages of a group: routing, MR¹, MR²
N_STAGES = 3


class CudaCapture:
    """Captures a callable's work on a CUDA device into a
    ``torch.cuda.CUDAGraph``: on a side stream of the device, into one
    memory pool per device shared by every capture, in ``thread_local``
    capture-error mode (another thread may be collecting an answer
    meanwhile).  Returns ``(graph, outputs)``.

    The allocators release a pool once its last graph dies, and a capture
    into a released pool fails; so each pool opens with an anchor, a
    one-kernel graph held here, which keeps it open for the captures that
    come after every group's graphs were dropped."""

    def __init__(self) -> None:
        # device -> (pool handle, its anchor graph)
        self._pools: Dict[torch.device, tuple] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def _capture(self, fn: Callable, device: torch.device, pool: tuple):
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams.setdefault(device,
                                              torch.cuda.Stream(device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
        return graph, out

    def __call__(self, fn: Callable, device: torch.device):
        pool = self._pools.get(device)
        if pool is None:
            handle = torch.cuda.graph_pool_handle()
            anchor, _ = self._capture(lambda: torch.zeros(1, device=device),
                                      device, handle)
            pool = self._pools[device] = (handle, anchor)
        return self._capture(fn, device, pool[0])


class GroupGraphs:
    """A group's stages captured one graph each, the last one's output, and
    what one run of the stages counts: held-back bumps and collectives."""

    __slots__ = ("graphs", "out", "bumps", "collectives")

    def __init__(self, graphs: Sequence, out: torch.Tensor, bumps,
                 collectives: Dict[str, int]) -> None:
        self.graphs = tuple(graphs)
        self.out = out
        self.bumps = tuple(bumps)
        self.collectives = collectives

    def replay(self, i: int) -> Optional[torch.Tensor]:
        """Launches stage ``i``'s graph on the current stream.  The last
        stage also copies the output out of the pool, on the same stream,
        adds the stages' counts and returns the copy."""
        self.graphs[i].replay()
        if i < len(self.graphs) - 1:
            return None
        _build.add_bumps(self.bumps)
        add_to_census(self.collectives)
        return self.out.clone()


class _Entry:
    """A group's inputs, by weak reference, and its graphs once captured.
    The first input to die takes the entry out of ``entries`` (the entry's
    ``token``, not the entry, tells the callback which one it is, so no
    reference cycle keeps a dropped entry's graphs alive)."""

    __slots__ = ("refs", "graphs", "token")

    def __init__(self, inputs: Sequence[torch.Tensor], entries: Dict,
                 ident: tuple) -> None:
        token = self.token = object()

        def drop(_ref) -> None:
            entry = entries.get(ident)
            if entry is not None and entry.token is token:
                entries.pop(ident, None)

        self.refs = tuple(weakref.ref(t, drop) for t in inputs)
        self.graphs: Optional[GroupGraphs] = None

    def holds(self, inputs: Sequence[torch.Tensor]) -> bool:
        return len(self.refs) == len(inputs) and all(
            r() is t for r, t in zip(self.refs, inputs))


class GraphCache:
    """An engine's groups by input identity, and their graphs.

    ``capture(fn, device) -> (graph, outputs)`` captures one stage (default
    :class:`CudaCapture`); ``graph.replay()`` runs it again on the current
    stream.  ``device_types`` are the devices whose groups capture."""

    def __init__(self, capture: Optional[Callable] = None,
                 device_types: Sequence[str] = ("cuda",)) -> None:
        self.capture = capture if capture is not None else CudaCapture()
        self.device_types = tuple(device_types)
        self._entries: Dict[tuple, _Entry] = {}
        #: held while deciding, capturing and replaying a group
        self.lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def decide(self, key: tuple, device: torch.device,
               inputs: Sequence[torch.Tensor]
               ) -> Tuple[str, Optional[_Entry]]:
        """How the group of program-cache ``key`` over ``inputs`` runs:
        ``(EAGER, None)``, ``(CAPTURE, entry)`` or ``(REPLAY, entry)``.  An
        eager decision on a capturing device remembers the inputs."""
        if device.type not in self.device_types:
            return EAGER, None
        ident = (key, tuple(map(id, inputs)))
        with self.lock:
            entry = self._entries.get(ident)
            if entry is not None and entry.holds(inputs):
                return (REPLAY if entry.graphs is not None
                        else CAPTURE), entry
            self._entries[ident] = _Entry(inputs, self._entries, ident)
        return EAGER, None

    def capture_group(self, entry: _Entry, steps: Iterator,
                      device: torch.device) -> GroupGraphs:
        """Captures a group's stages into ``entry`` (once; call under
        :attr:`lock`): ``steps`` runs one stage a ``next()``, the last
        returning the group's output, and each ``next()`` is captured as
        one graph.  What the stages count is held back for the replays."""
        if entry.graphs is None:
            with _build.held_bumps() as bumps, \
                    collective_census() as collectives:
                captured = [self.capture(lambda: next(steps), device)
                            for _ in range(N_STAGES)]
            entry.graphs = GroupGraphs(
                [g for g, _ in captured], captured[-1][1], bumps,
                {k: n for k, n in collectives.items() if n})
        return entry.graphs
