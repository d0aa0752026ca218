"""Share of the store-path signature groups of the window's answers that
the engine replayed from CUDA graphs: the sum of each answer's
``engine_stats['graph_replays']`` over the sum of ``graph_replays``,
``graph_captures`` and ``graph_eager`` (groups run eagerly), in %.  None
where the answers carry no such counts, or no store-path group ran."""


def read(run):
    keys = ("graph_replays", "graph_captures", "graph_eager")
    if not run.answers or any(k not in a[2].engine_stats
                              for a in run.answers for k in keys):
        return None
    n = {k: sum(a[2].engine_stats[k] for a in run.answers) for k in keys}
    total = sum(n.values())
    return 100.0 * n["graph_replays"] / total if total else None
