"""Share of the window's answers that the gateway's result cache gave
(``cache_hit``), in %."""


def read(run):
    if not run.answers:
        return None
    return 100.0 * sum(a[2].cache_hit for a in run.answers) / len(run.answers)
