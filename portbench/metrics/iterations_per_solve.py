"""IPM iterations of the window's requests (the returned state's ``iter``),
over their count."""


def read(run):
    its = [r["iterations"] for r in run.requests]
    return sum(its) / len(its) if its else None
