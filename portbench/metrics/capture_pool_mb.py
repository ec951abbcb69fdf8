"""Megabytes that PyTorch's caching allocator takes into reserve for new
CUDA-graph pools, per solve: the program's counter ``stepper.pool_bytes``
(the growth of the reserve across each capture of the IPM step,
galahad_tpu_torch/core/trace.py) over its ``ipm.solve`` spans, both summed
over every solve of the run (the set-up's warm-up, the window's and the traced
requests).  A step captured once and replayed across solves takes this towards
0.  None where the program keeps no such counter."""


def read(run):
    try:
        from galahad_tpu_torch.core import trace
    except ImportError:
        return None
    solves = trace.totals().get("ipm.solve", (0, 0.0))[0]
    pool = trace.counters().get("stepper.pool_bytes")
    return pool / solves / 1e6 if solves and pool is not None else None
