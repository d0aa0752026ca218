"""SchemaRegistry: named datasets behind one serving front door.

A gateway serves many tenants, each a loaded dataset with its own
:class:`repro_torch.api.FCTSession`.  The registry owns that mapping:

  * ``register(name, source)`` accepts a built :class:`StarSchema` or a
    :class:`repro_torch.data.tpch.TpchConfig` (generated lazily — registering a
    dataset costs nothing until its first query),
  * ``session(name)`` lazily constructs the tenant's FCTSession on first
    use (thread-safe; concurrent first queries build it once),
  * cache budgets are **partitioned across tenants**: the registry-level
    totals (``total_cache_entries`` programs, ``total_plan_entries``
    routing plans, ``total_tuple_set_entries`` tuple sets,
    ``total_store_bytes`` of device-resident relation columns) are split
    evenly over the tenants registered at session-build time, so one
    tenant's working set cannot evict another's.  The store budget bounds
    DEVICE memory: each tenant's RelationStore keeps its uploaded tuple-set
    columns LRU within its share and re-uploads on a later miss.  Setting ``total_cache_entries``
    gives every tenant a *private* engine with an LRU-capped program
    cache (the `SessionConfig.cache_max_entries` mechanism); leaving it
    None shares the process-wide engine across tenants — shared
    program builds, but no program isolation, and the per-query
    ``engine_stats`` deltas / cold flags of concurrent tenants can bleed
    into each other (the counters are engine-global).  Serving deployments
    that read per-tenant metrics should set a program budget.

Register every tenant before taking traffic for an even split — the
partition denominator is the number of registered tenants at the moment a
session is built, and already-built sessions keep their budgets.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from repro_torch.api import FCTSession, SessionConfig
from repro_torch.data.schema import StarSchema
from repro_torch.obs import default_registry


@dataclasses.dataclass
class _Tenant:
    name: str
    source: object                      # StarSchema | TpchConfig
    tokenizer: object
    stop_mask: object
    config: Optional[SessionConfig]     # explicit override; else partitioned
    session: Optional[FCTSession] = None
    # serializes first-query builds so concurrent callers generate the
    # dataset once (held outside the registry lock: builds can be slow)
    build_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock)


def _materialize(source) -> StarSchema:
    if isinstance(source, StarSchema):
        return source
    from repro_torch.data.tpch import TpchConfig, generate
    if isinstance(source, TpchConfig):
        return generate(source)
    raise TypeError(
        f"register() needs a StarSchema or TpchConfig, got {type(source)!r}")


class SchemaRegistry:
    """Name -> lazily-built FCTSession, with partitioned cache budgets."""

    def __init__(self, *, total_cache_entries: Optional[int] = None,
                 total_plan_entries: int = 64,
                 total_tuple_set_entries: int = 32,
                 total_store_bytes: Optional[int] = None,
                 device=None, n_workers: int = 1,
                 metrics=None) -> None:
        self.total_cache_entries = total_cache_entries
        self.total_plan_entries = total_plan_entries
        self.total_tuple_set_entries = total_tuple_set_entries
        self.total_store_bytes = total_store_bytes
        # every tenant session runs on this device with P = n_workers
        # virtual workers (None = CUDA, as FCTSession resolves it)
        self.device = device
        self.n_workers = n_workers
        # every tenant session's instruments carry a schema=<name> label in
        # this registry (gateways default to the same process registry, so
        # one snapshot covers the whole serving stack)
        self.metrics = metrics if metrics is not None else default_registry()
        self._tenants: Dict[str, _Tenant] = {}
        self._lock = threading.Lock()

    # -- registration --------------------------------------------------------

    def register(self, name: str, source, *, tokenizer=None, stop_mask=None,
                 config: Optional[SessionConfig] = None) -> None:
        """Add a tenant.  ``source`` is a StarSchema (served as-is) or a
        TpchConfig (generated on first query).  ``config`` overrides the
        partitioned budgets for this tenant only."""
        if not name or ":" in name or name != name.strip():
            raise ValueError(f"bad schema name {name!r} (no colons/blank)")
        if name == "gateway":
            raise ValueError(
                "schema name 'gateway' is reserved (Gateway.stats() reports "
                "gateway-wide counters under it)")
        with self._lock:
            if name in self._tenants:
                raise ValueError(f"schema {name!r} already registered")
            self._tenants[name] = _Tenant(name, source, tokenizer, stop_mask,
                                          config)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._tenants)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._tenants

    def __len__(self) -> int:
        return len(self._tenants)

    # -- lazy session construction -------------------------------------------

    def _partitioned_config(self, n_tenants: int) -> SessionConfig:
        def share(total, floor=1):
            return None if total is None else max(floor, total // n_tenants)
        return SessionConfig(
            cache_max_entries=share(self.total_cache_entries),
            plan_cache_size=share(self.total_plan_entries, floor=0),
            tuple_set_cache_size=share(self.total_tuple_set_entries),
            store_max_bytes=share(self.total_store_bytes))

    def session(self, name: str) -> FCTSession:
        """The tenant's FCTSession, built (schema generation included) on
        first use.  Unknown names raise KeyError with the catalogue."""
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is None:
                raise KeyError(
                    f"unknown schema {name!r} (registered: "
                    f"{', '.join(self._tenants) or '<none>'})")
            if tenant.session is not None:
                return tenant.session
            n_tenants = len(self._tenants)
        # build under the tenant's own lock, not the registry lock: schema
        # generation can be slow and must not serialize OTHER tenants'
        # traffic, but concurrent first queries to THIS tenant build once
        with tenant.build_lock:
            with self._lock:
                if tenant.session is not None:  # built while we waited
                    return tenant.session
            schema = _materialize(tenant.source)
            config = (tenant.config if tenant.config is not None
                      else self._partitioned_config(n_tenants))
            session = FCTSession(schema, tokenizer=tenant.tokenizer,
                                 device=self.device,
                                 n_workers=self.n_workers, config=config,
                                 stop_mask=tenant.stop_mask,
                                 metrics=self.metrics.labeled(schema=name))
            with self._lock:
                tenant.session = session
                return tenant.session

    def built(self, name: str) -> bool:
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is None:
                raise KeyError(f"unknown schema {name!r}")
            return tenant.session is not None

    # -- lifecycle / introspection ------------------------------------------

    def stats(self) -> Dict[str, dict]:
        """Per-tenant session stats (built tenants only)."""
        with self._lock:
            sessions = {n: t.session for n, t in self._tenants.items()
                        if t.session is not None}
        return {name: s.stats() for name, s in sessions.items()}

    def store_bytes(self) -> int:
        """Device bytes currently resident across every built tenant's
        relation store (each bounded by its ``total_store_bytes`` share)."""
        with self._lock:
            sessions = [t.session for t in self._tenants.values()
                        if t.session is not None]
        return sum(s.store.resident_bytes for s in sessions)

    def close(self) -> None:
        with self._lock:
            sessions = [t.session for t in self._tenants.values()
                        if t.session is not None]
        for s in sessions:
            s.close()
