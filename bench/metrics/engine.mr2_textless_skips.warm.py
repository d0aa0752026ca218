"""Relations of width 0 that MR² does not read, per signature group the
engine dispatched over the window: the sum of each answer's
``engine_stats['mr2_textless_skips']`` over the sum of its
``batches_run``.  In a star whose fact carries no text it reads 1 when
every group leaves the fact out of MR².  None where the answers carry no
such count (a program that reads every relation) or no group ran."""


def read(run):
    keys = ("mr2_textless_skips", "batches_run")
    if not run.answers or any(k not in a[2].engine_stats
                              for a in run.answers for k in keys):
        return None
    groups = sum(a[2].engine_stats["batches_run"] for a in run.answers)
    skips = sum(a[2].engine_stats["mr2_textless_skips"] for a in run.answers)
    return skips / groups if groups else None
