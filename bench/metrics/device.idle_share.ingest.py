"""Share of the whole window in which no kernel or copy ran on the
device, in % (``bench/devtrace.py``)."""
from bench.devtrace import idle_share as read  # noqa: F401
