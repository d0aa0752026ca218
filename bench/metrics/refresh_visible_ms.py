"""Mean over the RF1 refreshes of the window of the time from the call of
a refresh's first ``Gateway.append`` to the return of its last, when the
patched answers are in the result cache."""
import statistics


def read(run):
    return statistics.fmean(run.refresh_ms) if run.refresh_ms else None
