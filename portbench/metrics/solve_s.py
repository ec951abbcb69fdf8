"""Seconds of the window over the problems solved in it (host clock)."""


def read(run):
    return run.window_s / len(run.requests) if run.requests else None
