"""Mean of ``timings['plan_ms']`` of each pool entry's first query in
set-up: the program's host planning of a keyword set it has not seen
(tuple sets, CN enumeration, routing plans)."""
import statistics


def read(run):
    first = {}
    for i, _, resp in run.setup_answers:
        first.setdefault(i, resp.timings["plan_ms"])
    return statistics.fmean(first.values()) if first else None
