"""The achieved balance of the cold plans: over the ``plan.cn_plan`` spans
in each keyword set's first answer of set-up, the mean of their
``row_imbalance`` (max over mean fact rows a worker; 1 is even, P is one
worker holding all), weighted by each plan's ``fact_rows``.  None where
the spans carry no ``row_imbalance`` (a program without it)."""

NAME = "plan.cn_plan"


def read(run):
    first = {}
    for i, _, resp in run.setup_answers:
        first.setdefault(i, resp)
    weighted = rows = 0.0
    for resp in first.values():
        for s in resp.trace.spans() if resp.trace is not None else []:
            if s.name == NAME and "row_imbalance" in s.args:
                weighted += s.args["row_imbalance"] * s.args["fact_rows"]
                rows += s.args["fact_rows"]
    return weighted / rows if rows else None
