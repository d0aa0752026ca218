"""Token slots the program hands to MR² over the window (the sum of each
answer's ``engine_stats['fct_count_tokens']``: routed row slots times each
relation's padded ``text_len``, null CNs included) over the tokens MR²
needs for the same queries (the chain reference's ``weighted_tokens``:
each weighted row at its own relation's width), as a ratio.  None where
the answers carry no such count or the reference gives no
``weighted_tokens``."""


def read(run):
    key = "fct_count_tokens"
    if not run.answers or any(key not in a[2].engine_stats
                              for a in run.answers):
        return None
    stats = [run.reference[a[0]][1] for a in run.answers]
    if any("weighted_tokens" not in s for s in stats):
        return None
    launched = sum(a[2].engine_stats[key] for a in run.answers)
    needed = sum(s["weighted_tokens"] for s in stats)
    return launched / needed if needed else None
