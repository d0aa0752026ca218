"""Mean over the pool's keyword sets of the summed ``plan.schedule`` spans
in each set's first answer of set-up, in ms: the host's time on the task
cost estimates and their packing onto the workers (LPT or round robin)
when it plans a keyword set it has not seen.  None where those answers
hold no such span (uniform mode computes no schedule; a program without
the span)."""
import statistics

NAME = "plan.schedule"


def read(run):
    first = {}
    for i, _, resp in run.setup_answers:
        first.setdefault(i, resp)
    per_set, seen = [], False
    for resp in first.values():
        spans = [s for s in (resp.trace.spans() if resp.trace is not None
                             else []) if s.name == NAME]
        seen = seen or bool(spans)
        per_set.append(sum(s.dur_ns for s in spans) / 1e6)
    return statistics.fmean(per_set) if seen else None
