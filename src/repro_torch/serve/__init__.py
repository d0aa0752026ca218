"""Multi-tenant FCT serving gateway: schema registry, time-windowed dynamic
batching and TTL result caching over ``repro_torch.api`` sessions (the
architecture is in ``gateway.py``'s docstring)."""
from repro_torch.serve.batcher import DynamicBatcher, FlushPool
from repro_torch.serve.gateway import Gateway, GatewayConfig
from repro_torch.serve.registry import SchemaRegistry
from repro_torch.serve.result_cache import ResultCache

__all__ = ["DynamicBatcher", "FlushPool", "Gateway", "GatewayConfig",
           "SchemaRegistry", "ResultCache"]
