"""95th percentile of the client-side latency of every query completed in
the window of the Zipf-skewed warm cell, each query timed from its
``FCTSession.query`` call to its answer.  Its runs spread with the host's
speed by more than half of the largest bound an end-to-end metric may
have, so there it is a per-layer reading beside ``queries_per_s``."""
import numpy as np


def read(run):
    lat = [a[3] for a in run.answers]
    return float(np.percentile(lat, 95)) if lat else None
