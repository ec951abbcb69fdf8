"""The share of the traced window in which no kernel, copy or memset ran on
the device (torch.profiler)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
