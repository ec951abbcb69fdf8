"""Block-angular KKT solve over a device mesh (per-slot factors, one
fixed-order sum).

Counterpart of galahad_tpu/parallel/schur.py.  K independent scenario
blocks coupled by a small set of linking constraints:

    [ G_1              A_1' ] [x_1]   [b_1]
    [      ...              ] [...] = [...]
    [           G_K    A_K' ] [x_K]   [b_K]
    [ A_1  ...  A_K    -C   ] [ y ]   [ d ]

Each slot factors ITS scenario blocks (batched ``cholesky_ex`` and
``solve_triangular``, library calls as ``jnp.linalg.cholesky`` is in the
JAX package) and contributes S_k = A_k G_k^-1 A_k' and r_k = A_k G_k^-1 b_k
to the coupling Schur complement; ONE fixed-order sum over the slots
(parallel/mesh.py ``psum``, the JAX package's ``psum``) assembles
S = C + sum_k S_k and the reduced right-hand side, the small coupling
system is solved on every slot, and the back-substitution is local again:
the SCU / BSC Schur-complement pattern of the reference (src/scu/scu.f90,
src/bsc/bsc.f90:372).
"""
from __future__ import annotations

import torch

from .._device import as_device_tensor
from ..linalg.cholesky import chol_factor, chol_solve
from .mesh import Mesh, fixed_order_sum, psum, shard_batch


def _local_contrib(G, A, b):
    """A slot's blocks: batched factors, and the sums over its blocks of
    S_k = A_k G_k^-1 A_k' and r_k = A_k G_k^-1 b_k."""
    L, _ = chol_factor(G)
    S_k = A @ chol_solve(L, A.mT)                    # A G^-1 A'
    r_k = (A @ chol_solve(L, b)[..., None])[..., 0]
    return L, fixed_order_sum(list(S_k)), fixed_order_sum(list(r_k))


def block_angular_solve(mesh: Mesh, G, A, b, C, d, axis: str = "batch",
                        use_psum: bool = True):
    """Solve the block-angular KKT system over a device mesh.

    G (K, n, n) SPD scenario blocks, A (K, m, n) coupling rows, b (K, n)
    scenario right-hand sides: split along K over the slots of ``axis``
    (contiguous shards; K a multiple of the slots); C (m, m) PSD coupling
    block and d (m,) on every slot.  Returns (x (K, n), y (m,)) on the
    axis's first device: the system solved is
        G_k x_k + A_k' y = b_k,   sum_k A_k x_k - C y = d.
    One fixed-order sum assembles the coupling Schur complement; the rest is
    local to each slot.  ``use_psum=False`` replaces that sum by the slot's
    own terms times the mesh's device count (the JAX package's switch:
    numerically wrong on more than one slot, used only to measure the sum's
    share of the time)."""
    slots = mesh.axis_devices(axis)
    home = slots[0]
    G, A, b, C, d = (as_device_tensor(v, home) for v in (G, A, b, C, d))
    shards = shard_batch((G, A, b), mesh, axis)
    local = [_local_contrib(*s) for s in shards]
    if use_psum:
        S_all = psum([loc[1] for loc in local], slots)
        r_all = psum([loc[2] for loc in local], slots)
    else:
        count = len(mesh.devices.flat)
        S_all = [loc[1] * count for loc in local]
        r_all = [loc[2] * count for loc in local]
    xs, ys = [], []
    for (Gl, Al, bl), (L, _, _), S_sum, r_sum, slot in zip(shards, local, S_all, r_all, slots):
        # replicated small solve:  (C + sum A G^-1 A') y = sum r - d
        Ls, _ = chol_factor(S_sum + C.to(slot))
        y = chol_solve(Ls, r_sum - d.to(slot))
        # local back-substitution
        xs.append(chol_solve(L, bl - (Al.mT @ y)))
        ys.append(y)
    return torch.cat([x.to(home) for x in xs]), ys[0]


def block_angular_residual(G, A, b, C, d, x, y):
    """Monolithic residual of the block-angular system (for tests)."""
    r1 = G @ x[..., None] + A.mT @ y[:, None] - b[..., None]
    r2 = torch.einsum("kmn,kn->m", A, x) - C @ y - d
    return torch.maximum(r1.abs().max(), r2.abs().max())
