"""Megabytes that PyTorch's caching allocator takes into reserve during a
solve of the window and still holds when the solve returns, mean over the
requests: device memory a solve leaves behind (each solve's CUDA graph
captures into a memory pool of its own).  Read before the client, where its
traffic says so, releases the cache."""


def read(run):
    if not run.requests:
        return None
    return sum(r["reserved_growth"] for r in run.requests) / len(run.requests) / 1e6
