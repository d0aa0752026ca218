"""Signature groups the engine dispatched per answer over the window: the
sum of each answer's ``engine_stats['batches_run']`` (one a group, each
its route, MR¹ and MR² stages and its host dispatch) over the number of
answers.  CNs of one signature share a group, so it reads the host's
dispatch work a query asks for.  None where the answers carry no such
count."""


def read(run):
    key = "batches_run"
    if not run.answers or any(key not in a[2].engine_stats
                              for a in run.answers):
        return None
    return sum(a[2].engine_stats[key] for a in run.answers) / len(run.answers)
