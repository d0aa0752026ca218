"""95th percentile of the client-side latency of every query completed in
the window (numpy's linear interpolation between order statistics)."""
import numpy as np


def read(run):
    lat = [a[3] for a in run.answers]
    return float(np.percentile(lat, 95)) if lat else None
