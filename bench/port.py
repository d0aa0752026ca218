"""The system under test: the benchmark's tables handed to ``repro_torch``.

Everything the benchmark takes from the program goes through here: the
star schema built over the generated arrays, and the session.
"""
from __future__ import annotations

from typing import Dict


def star_schema(tables: Dict[str, dict], cfg: dict):
    """A ``repro_torch`` StarSchema over the generated arrays (shared, not
    copied)."""
    from repro_torch.data.schema import JoinEdge, Relation, StarSchema
    star = cfg["star"]

    def rel(name: str) -> Relation:
        t = tables[name]
        return Relation(name, keys=dict(t["keys"]),
                        key_domains=dict(t["domains"]), text=t["text"])

    return StarSchema(fact=rel(star["fact"]),
                      dims=[rel(d) for d, _ in star["dims"]],
                      edges=[JoinEdge(d, k, k) for d, k in star["dims"]],
                      vocab_size=cfg["vocab"])


def session_config(cfg: dict, traffic: dict):
    """The ``SessionConfig`` that the configuration and the traffic
    state."""
    from repro_torch.api import SessionConfig
    return SessionConfig(accum_policy=cfg["accum_policy"],
                         **traffic.get("session_config", {}))


def session(schema, cfg: dict, traffic: dict, device):
    """An ``FCTSession`` as the configuration and the traffic state it."""
    from repro_torch.api import FCTSession
    return FCTSession(schema, device=device, n_workers=cfg["workers"],
                      config=session_config(cfg, traffic))


def request(keywords, top_k: int, r_max: int):
    from repro_torch.api import FCTRequest
    return FCTRequest(keywords=tuple(int(k) for k in keywords), top_k=top_k,
                      r_max=r_max)
