"""Launches of the block-tridiagonal solve kernel per IPM iteration over the
traced requests: the chain of dependent launches that paces a PCG replay."""


def read(run):
    if run.trace is None:
        return None
    solves = sum(r["launches"].get("banded_solve", 0) for r in run.traced)
    its = sum(r["iterations"] for r in run.traced)
    return solves / its if solves and its else None
