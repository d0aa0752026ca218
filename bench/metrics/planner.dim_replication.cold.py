"""The dimension rows the cold plans send over the dimension rows they
hold: over the ``plan.cn_plan`` spans in each keyword set's first answer of
set-up, the sum of ``dim_sent`` (replicas to every worker that owns a task
of the row's bucket included) over the sum of ``dim_rows`` (the
dimensions' tuple-set rows).  1 is no replication.  None where the spans
carry no such counts (a program without them)."""

NAME = "plan.cn_plan"


def read(run):
    first = {}
    for i, _, resp in run.setup_answers:
        first.setdefault(i, resp)
    sent = held = 0
    for resp in first.values():
        for s in resp.trace.spans() if resp.trace is not None else []:
            if s.name == NAME and "dim_sent" in s.args:
                sent += s.args["dim_sent"]
                held += s.args["dim_rows"]
    return sent / held if held else None
