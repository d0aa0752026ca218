"""95th percentile of the query client's latency in the ingest cell, each
query timed from its ``Gateway.query`` call to its answer.  Queries that
find the result cache drained by a refresh's patch-up re-plan from cold, so
this tail swings with how the two clients' calls fall, and is a per-layer
reading there."""
import numpy as np


def read(run):
    lat = [a[3] for a in run.answers]
    return float(np.percentile(lat, 95)) if lat else None
