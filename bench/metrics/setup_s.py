"""Seconds from the process's start to the first timed request: data,
session, planning of the pool, uploads, builds and warm queries."""


def read(run):
    return run.setup_s
