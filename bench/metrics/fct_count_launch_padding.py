"""Token slots the program hands to ``weighted_histogram`` over the window
(the sum of each answer's ``engine_stats['fct_count_tokens']``: routed row
slots times the padded ``text_len``, null CNs included) over the tokens MR²
needs for the same queries (the plain reference's ``weighted_rows`` times
``text_len``), as a ratio.  None where the answers carry no such count."""


def read(run):
    key = "fct_count_tokens"
    if not run.answers or any(key not in a[2].engine_stats
                              for a in run.answers):
        return None
    launched = sum(a[2].engine_stats[key] for a in run.answers)
    needed = sum(run.reference[a[0]][1]["weighted_rows"]
                 for a in run.answers) * run.config["text_len"]
    return launched / needed if needed else None
