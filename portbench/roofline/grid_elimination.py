"""The fronts that a sparse LDL' of the 5-point matrix of an nx x ny grid
needs, worked out from the grid alone: the nested dissection that cuts each
box through the middle of its longer side, down to single points, each
separator's points eliminated along the line after both halves of the box.

A separator S of a box B, once B's halves are eliminated, is joined to itself
and to each point outside B that touches a non-empty half (those lie on the
separators of B's ancestors, eliminated later).  A point outside B that
touches only S (beyond an end of S, or beside it where a half is empty) joins
at the point of S it touches.  So S is one dense front, split after its
second-last point where a point lies beyond its far end; where a half is empty
(2 x 2 boxes) every point of S is a front of its own.

Plain numpy; nothing of the program: the yardstick of the rooflines of the
factor and sweep kernels on grid problems."""
from __future__ import annotations

import numpy as np


def _separators(nx: int, ny: int):
    """Per level of the dissection: the boxes (x0, x1, y0, y1) and their
    cuts."""
    boxes = np.array([[0, nx, 0, ny]], np.int64)
    while boxes.size:
        x0, x1, y0, y1 = boxes.T
        w, h = x1 - x0, y1 - y0
        cut_x = w >= h                       # cut by the line x = cx, else y = cy
        cx, cy = x0 + w // 2, y0 + h // 2
        yield boxes, cut_x, cx, cy
        halves = np.concatenate([
            np.where(cut_x[:, None], np.stack([x0, cx, y0, y1], 1),
                     np.stack([x0, x1, y0, cy], 1)),
            np.where(cut_x[:, None], np.stack([cx + 1, x1, y0, y1], 1),
                     np.stack([x0, x1, cy + 1, y1], 1))])
        boxes = halves[(halves[:, 1] > halves[:, 0]) & (halves[:, 3] > halves[:, 2])]


def nested_dissection(nx: int, ny: int):
    """``(nc, nf)``: int64 arrays with one entry a front, its eliminated
    columns and its rows."""
    nc_all, nf_all = [], []
    for boxes, cut_x, cx, cy in _separators(nx, ny):
        x0, x1, y0, y1 = boxes.T
        # in the frame of the cut: the line runs along "a" over [a0, a1); the
        # halves lie before and after it along "b"; b0, b1 the box's sides
        a0, a1 = np.where(cut_x, y0, x0), np.where(cut_x, y1, x1)
        b0, b1 = np.where(cut_x, x0, y0), np.where(cut_x, x1, y1)
        cb = np.where(cut_x, cx, cy)
        na, nb = np.where(cut_x, ny, nx), np.where(cut_x, nx, ny)
        size = a1 - a0
        span = b1 - b0
        lo_half, hi_half = cb > b0, cb + 1 < b1
        lo_side, hi_side = b0 > 0, b1 < nb          # points outside, beside the line
        start, end = a0 > 0, a1 < na                # points outside, beyond its ends
        shared = (size * (lo_side & lo_half) + size * (hi_side & hi_half)
                  + (span - 1) * start + (span - 1) * end)
        own = (lo_side & ~lo_half).astype(np.int64) + (hi_side & ~hi_half)   # per point
        ps, pe = start.astype(np.int64), end.astype(np.int64)
        # dense separators: one front, or two where a point lies beyond the far end
        d = (own == 0) | (size == 1)
        one = d & ((pe == 0) | (size == 1))
        nc_all += [size[one]]
        nf_all += [(size + shared + ps + pe + own)[one]]
        two = d & ~one
        nc_all += [size[two] - 1, np.ones(two.sum(), np.int64)]
        nf_all += [(size + shared + ps)[two], (1 + shared + ps + pe)[two]]
        # a half empty: a front a point, joined by the points beside it so far
        s = ~d
        reps = size[s]
        j = np.arange(reps.sum()) - np.repeat(np.cumsum(reps) - reps, reps)
        last = j == np.repeat(reps, reps) - 1
        r = (np.repeat(reps, reps) - 1 - j + np.repeat(shared[s] + ps[s], reps)
             + np.repeat(own[s], reps) * (j + 1) + np.repeat(pe[s], reps) * last)
        nc_all += [np.ones(r.size, np.int64)]
        nf_all += [r + 1]
    return np.concatenate(nc_all), np.concatenate(nf_all)


def elimination_order(nx: int, ny: int) -> np.ndarray:
    """The order of the points (point (x, y) is x * ny + y) that
    :func:`nested_dissection` eliminates in: deeper separators first, each
    along its line in increasing coordinate."""
    order = []
    for boxes, cut_x, cx, cy in reversed(list(_separators(nx, ny))):
        for (x0, x1, y0, y1), c, a, b in zip(boxes, cut_x, cx, cy):
            pts = [(a, y) for y in range(y0, y1)] if c else [(x, b) for x in range(x0, x1)]
            order.extend(x * ny + y for x, y in pts)
    return np.array(order, np.int64)
