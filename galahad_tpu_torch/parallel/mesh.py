"""Device-mesh scale-out for batched optimization.

Counterpart of galahad_tpu/parallel/mesh.py.  The reference has no
distributed backend (SURVEY §5.8); the JAX package scales out the TPU way,
one process driving a ``jax.sharding.Mesh`` with XLA inserting the
collectives.  The port does the same in one process:

  * a :class:`Mesh` is a 2-D array of ``torch.device`` with the axis names
    ("batch", "model") and a ``.shape`` dict, as in JAX;
  * each shard's tensors live on their slot's device;
  * the one collective, the counterpart of ``psum``, is a fixed-order sum
    (:func:`fixed_order_sum`, :func:`psum`): the shards' partial results are
    added in slot order on the axis's first device, and the sum is copied
    back to each slot.  No reduction whose order can vary (``scatter_add``,
    a collective library's all-reduce) is used, so two runs give the same
    bits.

Two scaling axes, as in the JAX package: ``batch`` (independent problems,
no communication: :func:`batch_ipm_solve`) and ``model`` (one problem's
operators split over the slots: :func:`model_sharded_step`).  A slot may
name a device that another slot names too (``make_mesh(devices=["cpu"] * 8)``
in the tests, ``[cuda:0] * 4`` to lay a mesh over one card): each shard's
work and the fixed-order sums are then checked, the traffic between cards is
not.  Several hosts (``torch.distributed``) are not ported.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass
class Mesh:
    """A 2-D array of devices with named axes (``jax.sharding.Mesh``'s
    role).  ``devices`` is a numpy object array of ``torch.device``."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The slots of ``axis``: its devices at index 0 of every other axis
        (the axis is replicated over the others)."""
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[k] = slice(None)
        return list(self.devices[tuple(index)])


def make_mesh(n_devices: int | None = None, batch: int | None = None,
              axis_names=("batch", "model"), devices=None) -> Mesh:
    """Build a 2-D (batch, model) mesh.  ``devices``: the devices in slot
    order (default every visible CUDA device; without one this raises: there
    is no CPU fallback).  ``n_devices`` keeps the first ones; ``batch`` fixes
    the size of the batch axis (it must divide ``n_devices``; default all on
    the batch axis, model = 1)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh lays its mesh over the CUDA devices by default "
                               "and none is available; pass devices=['cpu'] * k to run "
                               "on the host")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devs)
    if not 0 < n_devices <= len(devs):
        raise ValueError(f"{n_devices} devices asked for, {len(devs)} given")
    devs = devs[:n_devices]
    if batch is None:
        batch = n_devices
    if n_devices % batch:
        raise ValueError(f"batch axis {batch} must divide {n_devices} devices")
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(batch, n_devices // batch), tuple(axis_names))


def on_device(device):
    """A context in which ``device`` is the current CUDA device (a capture
    runs on the current device; parallel/mesh.py drives several)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _shard(x, k: int, parts: int, device):
    x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    if x.dim() == 0:
        return x.to(device)
    if x.shape[0] % parts:
        raise ValueError(f"the leading axis {x.shape[0]} does not split into {parts} shards")
    size = x.shape[0] // parts
    return x[k * size:(k + 1) * size].to(device)


def shard_batch(tree, mesh: Mesh, axis: str = "batch") -> list:
    """Split a stacked tree of problems (a tensor or array, or a tuple /
    list / dict of them; None stays None) along the leading axis into
    contiguous shards, one per slot of ``axis``, each moved to its slot's
    device.  Returns the list of the shards' trees, in slot order."""
    slots = mesh.axis_devices(axis)

    def split(node, k, device):
        if node is None:
            return None
        if isinstance(node, dict):
            return {key: split(v, k, device) for key, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(split(v, k, device) for v in node)
        return _shard(node, k, len(slots), device)

    return [split(tree, k, device) for k, device in enumerate(slots)]


def fixed_order_sum(parts, device=None) -> torch.Tensor:
    """Sum of ``parts`` added in their order on ``device`` (default the
    first part's): the port's reduction, whose order never varies."""
    device = parts[0].device if device is None else device
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def psum(parts, devices) -> list:
    """The ``psum`` of the JAX package over one axis: the fixed-order sum of
    the slots' ``parts`` on the axis's first device, copied back to every
    slot's device."""
    total = fixed_order_sum(parts, devices[0])
    return [total if d == total.device else total.to(d) for d in devices]


# ---------------------------------------------------------------------------
# The batch axis: same-shape problems, no communication
# ---------------------------------------------------------------------------


def _stacked_qp(arrays, h_kind: str, device):
    from ..core.problem import make_qp

    H, g, A, c_l, c_u, x_l, x_u = arrays
    return make_qp(H=H, g=g, A=A, c_l=c_l, c_u=c_u, x_l=x_l, x_u=x_u, h_kind=h_kind,
                   device=device)


def run_together(solves) -> None:
    """Run the :class:`~galahad_tpu_torch.qp.ipm.BatchedSolve` of every shard
    to its end, a fetch at a time in slot order: each shard's step is enqueued
    on its device before any monitor is read, so shards on different cards
    run at once."""
    pending = [s for s in solves if s.stepper is not None]
    while pending:
        for s in pending:
            with on_device(s.state.x.device):
                s.stepper.advance(1)
        still = []
        for s in pending:
            with on_device(s.state.x.device):
                if not s.stop(s.stepper.fetch()):
                    still.append(s)
        pending = still


def batch_ipm_solve(Hs, gs, As, c_ls, c_us, x_ls, x_us, ctl=None,
                    mesh: Mesh | None = None, h_kind: str = "dense", device=None):
    """Solve a stacked batch of same-shape QPs, sharded over the mesh's
    batch axis when a mesh is given (contiguous shards, one per slot), else
    on ``device`` (None: the card).  Each shard runs its problems through the
    batched ``ipm_solve_compiled`` (qp/ipm.py ``BatchedSolve``: one vmapped
    step per shard, captured once on the card); the shards share nothing.
    Returns (xs, ys, zs, state): the problems in their order on the first
    slot's device, the state's fields stacked per problem and ``state.run``
    the list of the shards' ``RunStats``."""
    from ..qp.ipm import TENSOR_FIELDS, BatchedSolve, IPMControl

    ctl = ctl or IPMControl()
    if h_kind in ("zero", "identity"):
        Hs = None
    arrays = (Hs, gs, As, c_ls, c_us, x_ls, x_us)
    if mesh is None:
        return BatchedSolve(_stacked_qp(arrays, h_kind, device), ctl).run()
    slots = mesh.axis_devices("batch")
    solves = []
    for shard, slot in zip(shard_batch(arrays, mesh), slots):
        with on_device(slot):
            solves.append(BatchedSolve(_stacked_qp(shard, h_kind, slot), ctl))
    run_together(solves)
    outs = [s.finish() for s in solves]
    home = slots[0]

    def gather(parts):
        return torch.cat([p.to(home) for p in parts])

    xs, ys, zs = (gather([o[i] for o in outs]) for i in range(3))
    st = dataclasses.replace(outs[0][3], **{f: gather([getattr(o[3], f) for o in outs])
                                            for f in TENSOR_FIELDS})
    st.run = [o[3].run for o in outs]
    return xs, ys, zs, st


# ---------------------------------------------------------------------------
# The model axis: one problem's H and A split over the slots
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedQP:
    """A dense QP whose H is split by rows and A by columns over the slots
    of the mesh's "model" axis (slot k holds ``H[r_k]`` and ``A[:, r_k]``,
    the same contiguous ranges ``r_k`` of the variables); the vectors and the
    iterate live on the axis's first device.  ``ipm_step`` takes it as a
    structured problem: its products are formed shard by shard (H x a
    gather of the row blocks' products; A x a fixed-order sum of the column
    blocks'; A'y a gather) and :meth:`build_kkt` gives the KKT solve."""

    g: torch.Tensor
    c_l: torch.Tensor
    c_u: torch.Tensor
    x_l: torch.Tensor
    x_u: torch.Tensor
    H_blocks: list
    A_blocks: list
    ranges: list
    x: Any = None                      # starting point (ipm_init's)
    y: Any = None
    h_kind: str = "model_sharded"

    @property
    def n(self) -> int:
        return self.g.shape[-1]

    @property
    def m(self) -> int:
        return self.c_l.shape[-1]

    @property
    def home(self):
        return self.g.device

    def Hx(self, v):
        return torch.cat([(Hk @ v.to(Hk.device)).to(self.home) for Hk in self.H_blocks])

    def Ax(self, v):
        return fixed_order_sum([Ak @ v[a:b].to(Ak.device)
                                for Ak, (a, b) in zip(self.A_blocks, self.ranges)], self.home)

    def Aty(self, y):
        return torch.cat([(Ak.T @ y.to(Ak.device)).to(self.home) for Ak in self.A_blocks])

    def build_kkt(self, D_x, C_diag, ctl):
        """The dense IPM's KKT solve (qp/ipm.py ``_dense_kkt``: SBLS's Schur
        complement with ``ctl.refine`` sweeps of refinement) with the
        sharded products.  G = H + D_x is assembled from the row blocks and
        factorized on the first device (the escalating shift of the JAX
        package, one host read a try); S = C + delta I + sum_k A_k W_k, with
        W = G^-1 A' and W_k its rows of slot k, is joined by the fixed-order
        sum and factorized there too.  No distributed Cholesky."""
        from ..linalg.cholesky import chol_factor_shifted, chol_solve, scalar_like
        from ..qp.ipm import CHOL_MAX_TRIES

        home = self.home
        G = torch.cat([Hk.to(home) for Hk in self.H_blocks]) + torch.diag(D_x)
        L_G, rho, _ = chol_factor_shifted(G, scalar_like(ctl.rho, G), max_tries=CHOL_MAX_TRIES)

        def apply_G(v):
            return self.Hx(v) + D_x * v

        if self.m == 0:
            return lambda b1, b2: (chol_solve(L_G, b1), b2)
        W = chol_solve(L_G, torch.cat([Ak.T.to(home) for Ak in self.A_blocks]))
        S = fixed_order_sum([Ak @ W[a:b].to(Ak.device)
                             for Ak, (a, b) in zip(self.A_blocks, self.ranges)], home)
        S = S + torch.eye(self.m, dtype=S.dtype, device=home) * scalar_like(ctl.delta, S)
        S.diagonal().add_(C_diag)
        L_S, _, _ = chol_factor_shifted(S, 0.0, max_tries=CHOL_MAX_TRIES)

        def solve_once(b1, b2):
            w = chol_solve(L_G, b1)
            y = chol_solve(L_S, self.Ax(w) - b2)
            return chol_solve(L_G, b1 - self.Aty(y)), y

        def kkt_solve(b1, b2):
            x, y = solve_once(b1, b2)
            for _ in range(ctl.refine):
                dx, dy = solve_once(b1 - (apply_G(x) + self.Aty(y)),
                                    b2 - (self.Ax(x) - C_diag * y))
                x, y = x + dx, y + dy
            return x, -y                   # the system is in terms of -dy

        return kkt_solve


def shard_model(qp_arrays, mesh: Mesh) -> ShardedQP:
    """The :class:`ShardedQP` of (H, g, A, c_l, c_u, x_l, x_u) over the slots
    of the mesh's "model" axis (contiguous variable ranges, as
    ``numpy.array_split`` cuts them)."""
    from .._device import as_device_tensor

    slots = mesh.axis_devices("model")
    home = slots[0]
    H, g, A, c_l, c_u, x_l, x_u = (as_device_tensor(a, home).to(home) for a in qp_arrays)
    n = g.shape[-1]
    bounds = np.cumsum([0] + [len(r) for r in np.array_split(np.arange(n), len(slots))])
    ranges = [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]
    return ShardedQP(g=g, c_l=c_l, c_u=c_u, x_l=x_l, x_u=x_u,
                     H_blocks=[H[a:b].to(d) for (a, b), d in zip(ranges, slots)],
                     A_blocks=[A[:, a:b].to(d) for (a, b), d in zip(ranges, slots)],
                     ranges=ranges)


def model_sharded_step(qp_arrays, mesh: Mesh, ctl=None):
    """One IPM iteration with the problem itself sharded over the "model"
    axis: H split by rows and A by columns across the slots
    (:class:`ShardedQP`), the tensor-parallel analogue for problems larger
    than one device.  Returns the state after one ``ipm_step`` from
    ``ipm_init``'s point, on the axis's first device; it equals ``ipm_step``
    on the whole QP up to the rounding of the sums' order."""
    from ..core.problem import classify_bounds
    from ..qp.ipm import IPMControl, ipm_init, ipm_step

    ctl = ctl or IPMControl()
    qp = shard_model(qp_arrays, mesh)
    masks = classify_bounds(qp, ctl.infinity)
    return ipm_step(qp, masks, ipm_init(qp, masks, ctl), ctl)
