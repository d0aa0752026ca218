"""Service API: requests, responses and the long-lived query session."""
from repro_torch.api.request import FCTRequest, FCTResponse
from repro_torch.api.session import FCTSession, SessionConfig

__all__ = ["FCTRequest", "FCTResponse", "FCTSession", "SessionConfig"]
