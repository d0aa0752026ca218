"""Service API: requests, responses and the long-lived query session (sync
``query``, cross-query-batched ``query_batch``, pipelined ``submit``, and
the ``append`` ingest path)."""
from repro_torch.api.request import AppendResult, FCTRequest, FCTResponse
from repro_torch.api.session import FCTSession, SessionConfig
from repro_torch.core.accum import AccumPolicy

__all__ = ["AccumPolicy", "AppendResult", "FCTRequest", "FCTResponse",
           "FCTSession", "SessionConfig"]
