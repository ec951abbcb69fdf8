"""Process start to the first timed request: imports, the kernels' build or
load, the problem, the symbolic analysis and the warm-up solve (host clock)."""


def read(run):
    return run.setup_s
