"""The roofline's operation and byte counts against cases worked by hand, and
the grid's nested-dissection fronts against a symbolic elimination."""
import numpy as np
import pytest

from portbench.roofline import counts, grid_elimination, peaks


def test_partial_ldlt_by_hand():
    # nf = 3, one column: r = 2 below it: 2 divisions, 2 * 3 for the 2 x 2
    # lower triangle's update; read 6 entries, write 1 + 2 + 3
    assert counts.partial_ldlt([1], [3], 8) == (8.0, 12 * 8)
    # two columns: (2 + 6) + (1 + 2); write 3 + 2 + 1
    assert counts.partial_ldlt([2], [3], 8) == (11.0, 12 * 8)
    # a front that eliminates nothing counts nothing
    assert counts.partial_ldlt([0, 1], [5, 3], 4) == (8.0, 12 * 4)


def test_partial_ldlt_full_front_is_a_cholesky():
    n = 50
    ops, _ = counts.partial_ldlt([n], [n], 8)
    want = sum(r + r * (r + 1) for r in range(n))
    assert ops == want


def test_sweeps_by_hand():
    # one front of 3 rows eliminating 2 columns: L entries below the
    # diagonal 2 + 1 = 3; a right-hand side of 4 rows
    ops, nbytes = counts.triangular_sweeps([2], [3], 4, 8, "bwd")
    assert ops == 6 and nbytes == 3 * 8 + 4 * 3 + 2 * 4 * 8
    ops, nbytes = counts.triangular_sweeps([2], [3], 4, 8, "fwd")
    assert ops == 6 + 2 and nbytes == 3 * 8 + 4 * 3 + 2 * 4 * 8 + 2 * 8


def test_block_tridiagonal_by_hand():
    # k = 2 blocks of b = 2: Cholesky 2 * 8/3, one off-diagonal solve 8 and
    # product 2 * 2 * 3; diagonal lower triangles 3 each, one 2 x 2 block
    ops, nbytes = counts.block_tridiagonal_cholesky(2, 2, 8)
    assert ops == pytest.approx(16 / 3 + 8 + 12)
    assert nbytes == 2 * (2 * 3 + 4) * 8


def test_bound_is_the_larger_term():
    assert peaks.bound_s(67e12, 0, "float64") == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12, "float64") == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 6.7e12, "float32") == pytest.approx(2.0)


def eliminated_structure(nx, ny, order):
    """Per point in ``order``: how many later points its column of L holds,
    by eliminating the grid's graph point by point."""
    n = nx * ny
    adj = [set() for _ in range(n)]
    for x in range(nx):
        for y in range(ny):
            p = x * ny + y
            if x + 1 < nx:
                adj[p].add(p + ny)
                adj[p + ny].add(p)
            if y + 1 < ny:
                adj[p].add(p + 1)
                adj[p + 1].add(p)
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)
    out = []
    for p in order:
        later = {q for q in adj[p] if pos[q] > pos[p]}
        out.append(len(later))
        for q in later:
            adj[q] |= later - {q}
    return out


@pytest.mark.parametrize("nx, ny", [(1, 1), (2, 1), (2, 2), (3, 2), (5, 7), (2, 9), (17, 6),
                                    (12, 12), (30, 31)])
def test_nested_dissection_fronts_are_the_elimination(nx, ny):
    order = grid_elimination.elimination_order(nx, ny)
    assert sorted(order) == list(range(nx * ny))
    nc, nf = grid_elimination.nested_dissection(nx, ny)
    assert nc.sum() == nx * ny
    # each front's column j holds nf - 1 - j later rows: the same multiset
    # as the point-by-point elimination in the same order
    fronts = sorted(int(f - 1 - j) for c, f in zip(nc, nf) for j in range(c))
    assert fronts == sorted(eliminated_structure(nx, ny, order))


def test_nested_dissection_of_the_cell():
    nc, nf = grid_elimination.nested_dissection(700, 700)
    assert nc.sum() == 490_000 and nf.max() == 1049
    # the top separator: a line of 700 points with nothing outside
    assert (nc[0], nf[0]) == (700, 700)
