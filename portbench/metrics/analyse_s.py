"""Seconds of the program's symbolic analysis of the KKT pattern: the host
seconds of its ``sbls.analyse`` spans (galahad_tpu_torch/core/trace.py), the
set-up's one miss of the plan cache.  None where the program recorded no such
span."""


def read(run):
    try:
        from galahad_tpu_torch.core import trace
    except ImportError:
        return None
    calls, seconds = trace.totals().get("sbls.analyse", (0, 0.0))
    return seconds if calls else None
