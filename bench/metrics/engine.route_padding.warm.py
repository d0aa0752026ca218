"""Gather slots the routing launched over the window over the rows the
plans send (the sum of each answer's ``engine_stats['route_slots']``:
``N·P·P·cap`` of every routed relation, caps as the signature buckets
them, null CNs included; over the sum of ``engine_stats['route_rows']``).
At one worker it reads the buckets' padding alone; at P workers also the
cap that the busiest (source, destination) pair sets.  None where the
answers carry no such counts."""


def read(run):
    keys = ("route_slots", "route_rows")
    if not run.answers or any(k not in a[2].engine_stats
                              for a in run.answers for k in keys):
        return None
    slots = sum(a[2].engine_stats["route_slots"] for a in run.answers)
    rows = sum(a[2].engine_stats["route_rows"] for a in run.answers)
    return slots / rows if rows else None
