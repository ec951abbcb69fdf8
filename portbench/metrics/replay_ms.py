"""Milliseconds of one replay of the captured IPM step: the sum of
``RunStats.replay_s`` (first replay's launch to the last fetch) over the sum
of replays, over the window's requests."""


def read(run):
    secs = sum(r["replay_s"] for r in run.requests)
    reps = sum(r["replays"] for r in run.requests)
    return 1e3 * secs / reps if reps else None
