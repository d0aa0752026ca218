"""Queries completed in the window over the window's length (from its
opening to the return of its last query)."""


def read(run):
    if not run.window_s:
        return None
    return len(run.answers) / run.window_s
