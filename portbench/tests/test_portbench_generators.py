"""The benchmark's problem generators: the same seed gives the same problem; a
new request index gives new values in the same pattern; the structure is the
published problem's at a size worked by hand."""
import numpy as np
import torch

from portbench.families import banded_lp, ept_torsion
from portbench.harness import load_json, request_generator
from conftest import ROOT

GRID = load_json(f"{ROOT}/portbench/configs/ept-torsion-700.json")
BAND = load_json(f"{ROOT}/portbench/configs/lpband-1m.json")


def draw(fam, cfg, st, seed, index):
    return {k: v.numpy() for k, v in
            fam.values(cfg, st, request_generator(seed, index, "cpu"), "cpu").items()}


def test_torsion_structure_by_hand():
    cfg = dict(GRID, nx=3, ny=2)
    st = ept_torsion.structure(cfg)
    assert (st["n"], st["m"]) == (6, 0)
    H = np.zeros((6, 6))
    np.add.at(H, (st["h_rows"], st["h_cols"]), st["h_vals"])
    assert (st["h_rows"] >= st["h_cols"]).all()
    hx, hy = 1 / 4, 1 / 3
    want = (2 / hx ** 2 + 2 / hy ** 2) * np.eye(6)
    for i in range(3):              # point (i, j) is i * 2 + j
        for j in range(2):
            if i + 1 < 3:
                want[2 * (i + 1) + j, 2 * i + j] = -1 / hx ** 2
            if j + 1 < 2:
                want[2 * i + j + 1, 2 * i + j] = -1 / hy ** 2
    np.testing.assert_allclose(H, want, rtol=1e-15)
    # the distance of (i hx, j hy) to the unit square's boundary
    d = [min(x, 1 - x, y, 1 - y) for x in (1 / 4, 2 / 4, 3 / 4) for y in (1 / 3, 2 / 3)]
    np.testing.assert_allclose(st["x_u"], d, rtol=1e-15)
    np.testing.assert_array_equal(st["x_l"], -st["x_u"])
    p = ept_torsion.host_problem(st, draw(ept_torsion, cfg, st, 3, 0))
    assert p["A"].shape == (0, 6)
    np.testing.assert_allclose(p["H"].toarray(), want + np.tril(want, -1).T, rtol=1e-15)


def test_torsion_sizes():
    st = ept_torsion.structure(GRID)
    assert (st["n"], st["m"]) == (490_000, 0)
    assert len(st["h_vals"]) == 490_000 + 2 * 700 * 699


def test_band_structure():
    st = banded_lp.structure(dict(BAND, n=10))
    assert (st["n"], st["m"], st["a_offsets"], st["block"]) == (10, 8, (0, 2), 8)
    vals = draw(banded_lp, BAND, st, 5, 0)
    A = banded_lp.host_problem(st, vals)["A"].toarray()
    assert A.shape == (8, 10)
    for i in range(8):
        assert set(np.flatnonzero(A[i])) == {i, i + 2}
        assert A[i, i] == vals["a_val"][0, i] and A[i, i + 2] == vals["a_val"][1, i]


def test_same_seed_same_values_new_index_new_values():
    for fam, cfg in ((ept_torsion, dict(GRID, nx=6, ny=5)), (banded_lp, dict(BAND, n=50))):
        st = fam.structure(cfg)
        a = draw(fam, cfg, st, 2 ** 31 + 7, 3)
        b = draw(fam, cfg, st, 2 ** 31 + 7, 3)
        c = draw(fam, cfg, st, 2 ** 31 + 7, 4)
        d = draw(fam, cfg, st, 2 ** 31 + 8, 3)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert not np.array_equal(a[k], c[k]) and not np.array_equal(a[k], d[k])
        # the pattern does not depend on the request
        p, q = fam.host_problem(st, a), fam.host_problem(st, c)
        assert (p["A"] != 0).toarray().tolist() == (q["A"] != 0).toarray().tolist()


def test_value_ranges():
    st = ept_torsion.structure(dict(GRID, nx=5, ny=4))
    twists = [-draw(ept_torsion, GRID, st, 11, i)["g"] for i in range(200)]
    assert all((t == t[0]).all() for t in twists)
    c = np.array([t[0] for t in twists])
    assert 4.0 <= c.min() and c.max() <= 6.0 and c.max() - c.min() > 1.8
    st = banded_lp.structure(dict(BAND, n=5000))
    v = draw(banded_lp, BAND, st, 11, 0)
    assert 0.8 <= v["a_val"].min() and v["a_val"].max() <= 1.2
    assert -1.0 <= v["g"].min() and v["g"].max() <= 1.0 and (v["g"] > 0).mean() > 0.45


def test_seeds_past_32_bits():
    g1 = request_generator(2 ** 33 + 1, 0, "cpu")
    g2 = request_generator(1, 0, "cpu")
    assert not torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
