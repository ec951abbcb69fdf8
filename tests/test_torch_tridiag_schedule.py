"""The layouts of the tridiagonal kernels (csrc/tridiag.cu) on the CPU:
``tridiag_kernels.tridiag_schedule`` at the shapes the bench times and at
the edges, its critical path against a direct count over the chunked
solve's dependency graph, and the chunked solve's plain mirror
(``cholesky.tridiag_solve_chunked_plain``: the kernel's chunk boundaries,
zero-inflow pass, carried inflows and rerun, in plain PyTorch) against the
JAX package's ``tridiag_solve`` (galahad_tpu/linalg/cholesky.py:109) on
numpy-seeded systems: relative residual within 10 x the sequential solve's
+ 1e-15 in f64, and the same bits with one chunk.  The cases are loops in a
few tests; 5.4 s in the six-worker tier-1 run."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galahad_tpu.linalg.cholesky import tridiag_factor as j_factor
from galahad_tpu.linalg.cholesky import tridiag_solve as j_solve

from galahad_tpu_torch.linalg import tridiag_kernels as tk
from galahad_tpu_torch.linalg.cholesky import tridiag_solve_chunked_plain

from _torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F64, F32 = torch.float64, torch.float32


def test_schedule_at_the_bench_shapes_and_edges():
    """(a) 1,024 x 64: both kernels in the batch layout, 4 systems a block
    (256 blocks), 32 rows a stage, z resident; (b) one system of 64: the factor's chain
    layout (one stage of 64 rows), the batch solve; (c) 64 x 5,000 and (d)
    one chain of 10^6: the chain factor in stages of 512 rows and the
    chunked solve in WALKERS / B chunks a system; and the edges."""
    for dtype in (F64, F32):
        s = tk.tridiag_schedule(1024, 64, dtype)
        f, v = s["factor"], s["solve"]
        assert (f["layout"], f["rows_per_stage"], f["slots"], f["blocks"],
                f["systems_per_block"]) == ("batch", 32, 2, 256, 4)
        assert (v["layout"], v["rows_per_stage"], v["resident"], v["blocks"]) == \
            ("batch", 32, True, 256)
        assert (f["critical_path_steps"], v["critical_path_steps"]) == (63, 127)
        assert v["smem_bytes"] == 128 + 2 * 3 * 4 * (32 * (8 if dtype == F64 else 4) + 16)
    s = tk.tridiag_schedule(1, 64, F64)
    assert (s["factor"]["layout"], s["factor"]["rows_per_stage"], s["factor"]["slots"]) == \
        ("chain", 64, 1)
    assert (s["solve"]["layout"], s["solve"]["resident"]) == ("batch", True)
    s = tk.tridiag_schedule(64, 5000, F64)
    assert (s["factor"]["layout"], s["factor"]["rows_per_stage"], s["factor"]["stages"]) == \
        ("chain", 512, 10)
    assert (s["solve"]["layout"], s["solve"]["chunk"], s["solve"]["chunks"],
            s["solve"]["grid"]) == ("chunked", 625, 8, [8, 64])
    s = tk.tridiag_schedule(1, 1_000_000, F64)
    assert (s["factor"]["layout"], s["factor"]["slots"], s["factor"]["stages"]) == \
        ("chain", 4, 1954)
    assert (s["solve"]["layout"], s["solve"]["chunk"], s["solve"]["chunks"],
            s["solve"]["rows_per_stage"]) == ("chunked", 1894, 528, 256)
    # edges: k = 1 and 2; B not a multiple of 32; k not a multiple of the stage rows
    for B, k in ((1, 1), (5, 2), (1000, 1), (300, 2)):
        s = tk.tridiag_schedule(B, k, F32)
        assert s["factor"]["rows_per_stage"] == (4 if B < tk.CHAIN_MAX_B else 32)
        assert s["factor"]["slots"] == 1 and s["solve"]["slots"] == 1
        assert s["factor"]["critical_path_steps"] == k - 1
        assert s["solve"]["critical_path_steps"] == 2 * k - 1
    s = tk.tridiag_schedule(33, 97, F32)
    assert (s["factor"]["layout"], s["factor"]["rows_per_stage"], s["factor"]["stages"]) == \
        ("chain", 100, 1)
    s = tk.tridiag_schedule(257, 97, F32)
    assert (s["factor"]["blocks"], s["factor"]["stages"], s["factor"]["slots"]) == (257, 4, 4)
    assert (s["solve"]["blocks"], s["solve"]["slots"], s["solve"]["resident"]) == (257, 4, True)
    assert [tk.batch_systems(B) for B in (1, 264, 265, 1024, 8448, 10**6)] == [1, 1, 2, 4, 32, 32]
    # the batch solve leaves its slots beyond what its ring holds
    for dtype, resident in ((F64, 256), (F32, 256)):
        assert tk.solve_layout(5000, resident, dtype, "batch")["resident"]
        big = tk.solve_layout(5000, resident + 1, dtype, "batch")
        assert not big["resident"] and big["slots"] == tk.RING
        assert big["smem_bytes"] <= tk.SMEM_MAX
    assert tk.tridiag_schedule(65, 5000, F64)["solve"]["layout"] == "batch"
    assert tk.tridiag_schedule(64, 1023, F64)["solve"]["layout"] == "batch"
    assert tk.solve_layout(3, 10, F64, "chunked", 4)["chunks"] == 3
    assert tk.solve_layout(3, 10, F64, "chunked", 40)["chunks"] == 1
    for name in ("factor_layout", "solve_layout"):
        with pytest.raises(ValueError):
            getattr(tk, name)(4, 10, F64, "thread")


def direct_steps(k: int, m: int) -> int:
    """The longest chain of the chunked solve's dependency graph, counted
    node by node: each row of each pass is a node, each hop between chunks
    one; a backward item starts once its chunk's forward rows are written."""
    P = -(-k // m)
    rows = [list(range(j * m, min(k, (j + 1) * m))) for j in range(P)]
    preds = {}
    for j in range(P):
        r = rows[j]
        if j:
            for a, i in enumerate(r):
                preds[("f1", j, i)] = [("f1", j, r[a - 1])] if a else []
            preds[("fh", j)] = [("f1", j, r[-1]),
                                ("f3", 0, rows[0][-1]) if j == 1 else ("fh", j - 1)]
        for a, i in enumerate(r):
            preds[("f3", j, i)] = [("f3", j, r[a - 1])] if a else ([("fh", j)] if j else [])
    for j in range(P):
        r = rows[j][::-1]
        written = ("f3", j, rows[j][-1])
        if j < P - 1:
            for a, i in enumerate(r):
                preds[("b1", j, i)] = [("b1", j, r[a - 1])] if a else [written]
            preds[("bh", j)] = [("b1", j, r[-1]),
                                ("b3", P - 1, rows[P - 1][0]) if j == P - 2 else ("bh", j + 1)]
        for a, i in enumerate(r):
            first = [("bh", j)] if j < P - 1 else [written]
            preds[("b3", j, i)] = [("b3", j, r[a - 1])] if a else first

    depth = {}
    for node in preds:                   # longest path, by an explicit depth-first stack
        stack = [node]
        while stack:
            top = stack[-1]
            pending = [p for p in preds[top] if p not in depth]
            if pending:
                stack.extend(pending)
                continue
            depth[top] = 1 + max((depth[p] for p in preds[top]), default=0)
            stack.pop()
    return max(depth.values())


def test_critical_path_against_a_direct_count():
    for k, m in ((1, 1), (2, 1), (7, 3), (10, 4), (10, 10), (64, 9), (100, 7), (200, 13),
                 (5000, 625)):
        assert tk.chunked_steps(k, m) == direct_steps(k, m), (k, m)
        assert tk.solve_layout(2, k, F64, "chunked", m)["critical_path_steps"] == \
            direct_steps(k, m)
    # the default chunk shortens the path well below the sequential 2 k
    s = tk.solve_layout(1, 1_000_000, F64, "chunked")
    assert s["critical_path_steps"] < 0.03 * 2_000_000


def residual(d, e, b, x) -> float:
    """max |T x - b| / (||T||_inf max |x|), float64."""
    d, e, b, x = (np.asarray(a, np.float64) for a in (d, e, b, x))
    r = d * x - b
    r[..., 1:] += e * x[..., :-1]
    r[..., :-1] += e * x[..., 1:]
    norm = np.abs(d).max() + (2 * np.abs(e).max() if e.size else 0.0)
    return float(np.abs(r).max() / (norm * np.abs(x).max()))


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


def test_chunked_mirror_against_the_jax_solve():
    """The mirror at several chunk sizes on numpy-seeded diagonally dominant
    systems (those the kernels' card checks use), held to the JAX package's
    solve."""
    rng = np.random.default_rng(16)
    for shape, chunks in (((4, 200), (1, 7, 13, 50, 199, 200)), ((3, 61), (2, 8, 61, 100)),
                          ((2, 150), (5, 12, 150)), ((97,), (10, 97)), ((1,), (1, 3))):
        k = shape[-1]
        d = rng.uniform(2.0, 4.0, shape) * np.where(rng.random(shape) < 0.2, -1.0, 1.0)
        e = rng.uniform(-1.0, 1.0, shape[:-1] + (k - 1,))
        b = rng.normal(size=shape)
        jd, jl = j_factor(jnp.asarray(d), jnp.asarray(e))
        jx = np.asarray(j_solve(jd, jl, jnp.asarray(b)))
        seq = residual(d, e, b, jx)
        for m in chunks:
            x = tridiag_solve_chunked_plain(torch.as_tensor(np.array(jd)),
                                            torch.as_tensor(np.array(jl)),
                                            torch.as_tensor(b), m).numpy()
            if m >= k:
                np.testing.assert_array_equal(bits(x), bits(jx))
            res = residual(d, e, b, x)
            assert res <= 10 * seq + 1e-15, (shape, m, res, seq)
