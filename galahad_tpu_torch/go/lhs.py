"""Latin hypercube sampling.

Counterpart of galahad_tpu/go/lhs.py (GALAHAD's LHS, reference
src/lhs/lhs.f90, BGO's multistart seeding): one sample per stratum per
dimension, the strata permuted independently per dimension.  The numbers
come from an explicit ``torch.Generator`` on the host (``torch.rand``, then
one ``torch.randperm`` per dimension) and then go to the requested device,
so a seed gives the same points on every device.  The JAX package draws
from ``jax.random`` (threefry), whose stream torch cannot reproduce: the
same seed gives other points in the two packages.
"""
from __future__ import annotations

import torch

from .._device import resolve_device, resolve_dtype
from ..tr.trs import as_tensors


def _generator(gen) -> torch.Generator:
    """A host ``torch.Generator``: given, or seeded from an int."""
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator().manual_seed(int(gen))


def lhs_sample(gen, npoints: int, dims: int, dtype=None, device=None):
    """npoints x dims Latin hypercube on [0, 1]^dims from ``gen`` (a host
    ``torch.Generator`` or an int seed), drawn on the host and moved to
    ``resolve_device(device)``."""
    g = _generator(gen)
    dt = resolve_dtype(dtype)
    u = torch.rand((npoints, dims), generator=g, dtype=dt)
    perms = torch.stack([torch.randperm(npoints, generator=g) for _ in range(dims)], dim=1)
    return ((perms.to(dt) + u) / npoints).to(resolve_device(device))


def lhs_sample_box(gen, npoints: int, x_l, x_u, device=None):
    """Latin hypercube over the box [x_l, x_u] (tensors keep their device,
    numpy goes to ``resolve_device(device)``)."""
    x_l, x_u = as_tensors(x_l, x_u, device=device)
    u = lhs_sample(gen, npoints, x_l.shape[-1], x_l.dtype, x_l.device)
    return x_l + u * (x_u - x_l)
