"""Mean over the pool's keyword sets of the summed ``plan.cn_plan`` spans in
each set's first answer of set-up, in ms: the host's time on the routing
plans of its CNs (one ``build_cn_plan`` each) when it plans a keyword set
it has not seen. Beside ``planner.cold_plan_ms``, which reads the whole
``plan`` span of the same answers. None where those answers hold no
planner step spans (``plan.*``: a program without them)."""
import statistics

NAME = "plan.cn_plan"


def read(run):
    first = {}
    for i, _, resp in run.setup_answers:
        first.setdefault(i, resp)
    per_set, seen = [], False
    for resp in first.values():
        spans = resp.trace.spans() if resp.trace is not None else []
        seen = seen or any(s.name.startswith("plan.") for s in spans)
        per_set.append(sum(s.dur_ns for s in spans if s.name == NAME) / 1e6)
    return statistics.fmean(per_set) if seen else None
