"""Device and dtype resolution shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``torch.device("cuda")`` and raises when there is
none.  Nothing here switches a global default device.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_DTYPE = torch.float64


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card (raises without one); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "galahad_tpu_torch entry points run on a CUDA device by "
                "default and none is available; pass device='cpu' to run "
                "on the host")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but none is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_dtype(dtype=None) -> torch.dtype:
    """Accepts None (float64), a torch dtype, a numpy dtype or a name."""
    if dtype is None:
        return DEFAULT_DTYPE
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name == "float64":
        return torch.float64
    if name == "float32":
        return torch.float32
    raise ValueError(f"unsupported dtype {dtype!r}")


def tiny16(dtype: torch.dtype) -> float:
    """Pivot guard shared by the factor kernel, its plain version and the
    solves: 16 x the smallest normal number of the working type."""
    return float(torch.finfo(dtype).tiny) * 16.0


def as_device_tensor(a, device=None, dtype=None) -> torch.Tensor:
    """A tensor stays on its device (cast to ``dtype`` if one is given);
    anything else (numpy, lists, numbers) goes to ``device`` (``None``: the
    card) as ``dtype`` (``None``: float64)."""
    if torch.is_tensor(a):
        return a if dtype is None else a.to(resolve_dtype(dtype))
    return torch.as_tensor(np.asarray(a, np.float64),
                           device=resolve_device(device)).to(resolve_dtype(dtype))
