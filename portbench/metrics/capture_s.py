"""The fused stepper's capture of the step as a CUDA graph (``RunStats.capture_s``),
mean over the window's requests that ran on the graph path."""


def read(run):
    caps = [r["capture_s"] for r in run.requests if r["path"] == "graph"]
    return sum(caps) / len(caps) if caps else None
