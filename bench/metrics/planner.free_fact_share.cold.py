"""Share of the tuple-set rows the cold plans route that are the free fact
(the fact rows that hold no query keyword), in %: over the
``plan.cn_plan`` spans in each keyword set's first answer of set-up, the
sum of ``fact_rows`` of the CNs whose ``fact_mask`` is 0 over the sum of
``fact_rows`` and ``dim_rows``.  None where the spans carry no
``fact_mask`` (a program without it)."""

NAME = "plan.cn_plan"


def read(run):
    first = {}
    for i, _, resp in run.setup_answers:
        first.setdefault(i, resp)
    free = total = 0
    seen = False
    for resp in first.values():
        for s in resp.trace.spans() if resp.trace is not None else []:
            if s.name == NAME and "fact_mask" in s.args:
                seen = True
                rows = s.args["fact_rows"]
                total += rows + s.args.get("dim_rows", 0)
                free += rows if s.args["fact_mask"] == 0 else 0
    return 100.0 * free / total if seen and total else None
