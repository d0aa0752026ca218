"""Shared configuration of the port's static-analysis pass.

Everything path-shaped in here is **relative to the package root**
``src/repro_torch`` (the lint walks that tree); rule classes read their
scope from this module so the policy lives in one place and the rules stay
pure mechanism.

``EXCLUDED_DIRS`` names the same directories as the JAX package's list:
the LM substrate (model zoo, training loop, DP utilities and their
configs) is not held to the FCT runtime's invariants.  Unlike the JAX
package's list, it is not mirrored into ``pyproject.toml``: ruff's
``extend-exclude`` there is the JAX package's policy (its tests assert the
two agree), and the port's LM directories stay under ruff's checks.
"""
from __future__ import annotations

#: LM-substrate dirs, relative to src/repro_torch — excluded from the lint
EXCLUDED_DIRS = ("models", "configs", "train", "distributed")

# -- R1: trace containment ---------------------------------------------------

#: directories whose modules may build programs or load kernel libraries.
#: Anywhere else, a ``torch.compile`` / CUDA graph capture / direct library
#: load builds code the ``PlanSignature``-keyed program cache and the
#: kernels' build step cannot see.
TRACE_ALLOWED_DIRS = ("runtime", "kernels")

#: program-building and library-loading entry points R1 looks for, as
#: dotted paths resolved through the module's imports
TRACE_ENTRY_POINTS = (
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.cuda.graph", "torch.cuda.CUDAGraph",
    "torch.cuda.make_graphed_callables",
    "ctypes.CDLL", "ctypes.cdll.LoadLibrary",
    "repro_torch.kernels._build.Library",
)

# -- R2: accumulation discipline ---------------------------------------------

#: modules whose device bodies accumulate histogram/volume values: every
#: ``.sum(`` / ``torch.sum(`` passes an explicit ``dtype=``, the target of
#: every ``index_add_`` / ``scatter_add_`` is allocated with an explicit
#: ``dtype=`` in the same function, and the operand of every virtual-mesh
#: reduction (``psum`` / ``psum_scatter``) is explicitly cast in the same
#: function — the AccumPolicy overflow contract must be local, not
#: inherited by accident.
ACCUM_MODULES = ("core/fct.py", "runtime/engine.py",
                 "kernels/mr1_volumes/ref.py")

# -- R3: lock discipline -----------------------------------------------------

#: threaded modules -> the lock attribute names that guard their shared
#: state.  Outside ``__init__``-like constructors, writes to underscore-
#: prefixed ``self._x`` fields and read-modify-write (``+=``) updates of
#: ANY ``self.x`` counter must happen inside ``with self.<lock>:``.
THREADED_MODULES = {
    "api/session.py": ("_plan_lock", "_engine_lock", "_pipeline_lock"),
    "api/pipeline.py": ("_submit_lock",),
    "serve/gateway.py": ("_lock",),
    "serve/batcher.py": ("_cv",),
    "serve/registry.py": ("_lock",),
    "serve/result_cache.py": ("_lock",),
    "runtime/store.py": ("_lock",),
    "runtime/cache.py": ("_lock",),
    # the engine owns no lock: its counters are obs instruments, bumped
    # under the registry's lock, so any read-modify-write of engine state
    # (and any write to an underscore field outside __init__) is flagged
    "runtime/engine.py": (),
    # the metrics registry is the blessed lock owner for counter state:
    # every instrument bumps under the registry's single ``_lock`` (shared
    # via ``self._lock``), so components route shared counters through
    # repro_torch.obs instead of growing new raw ``self.x += 1`` sites
    "obs/metrics.py": ("_lock",),
}

#: constructor-like functions where unlocked writes are fine (the object
#: is not yet shared)
UNLOCKED_FUNCTIONS = ("__init__", "__post_init__", "__new__")

# -- R4: no host sync in hot paths -------------------------------------------

#: module -> function names allowed to wait on the device.  A ``.cpu()`` /
#: ``.item()`` / ``torch.cuda.synchronize()`` anywhere else in the module
#: blocks the asynchronous dispatch.
HOST_SYNC_ALLOWED = {
    # dispatch_topk is allowed only for the OPT-IN threshold-pruning probe:
    # an O(k) read of the running counts between groups, a deliberate
    # latency-for-work trade documented on the method
    "runtime/engine.py": ("_collect", "collect_total", "collect_individual",
                          "dispatch_topk", "collect_topk"),
}

#: call spellings that force a host<->device synchronization
HOST_SYNC_CALLS = ("np.asarray", "numpy.asarray")
#: methods that read a tensor to the host or wait on the device
#: (``torch.cuda.synchronize()`` is the ``synchronize`` method of
#: ``torch.cuda``); ``.to("cpu")`` is matched by its argument
HOST_SYNC_METHODS = ("cpu", "item", "tolist", "numpy", "synchronize")

# -- R5: epoch fencing -------------------------------------------------------

#: module -> (cache attribute names, fence names).  A ``.put(...)`` into
#: one of the named caches must either pass a ``generation=`` keyword or be
#: preceded (in the same function) by a comparison against one of the fence
#: names: results computed from pre-mutation data may be SERVED once but
#: must never be CACHED.
EPOCH_FENCED_CACHES = {
    "api/session.py": (("_tuple_sets", "_plan_cache", "_hf_dev"),
                       ("_data_epoch",)),
    "runtime/store.py": (("_entries",), ("epoch",)),
    "serve/gateway.py": (("results",), ("generation",)),
    "serve/result_cache.py": (("_entries",), ("generation",)),
}
