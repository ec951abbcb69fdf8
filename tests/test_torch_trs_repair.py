"""TRS's e_1 (galahad_tpu_torch/tr/trs.py::_trs_from_eigen) is made on the
device by a comparison with an index range, not by writing a Python number
into a tensor (a host copy on the card, and one that a CUDA graph capture
refuses): the same bits as the written version, and the same TRS results
as the JAX package on a batch with hard cases (1e-12; x only where the
problem is not a hard case, where it is defined up to the eigenvector's
sign, as tests/test_torch_trs.py holds it)."""
import jax.numpy as jnp
import numpy as np
import torch

from galahad_tpu.tr import trs as J
from galahad_tpu_torch.tr import trs as T


def test_e1_has_the_written_bits():
    ct2 = torch.rand(3, 5, 7, dtype=torch.float64)
    written = torch.zeros_like(ct2)
    written[..., 0] = 1.0
    made = (torch.arange(ct2.shape[-1]) == 0).to(ct2.dtype).expand_as(ct2)
    assert torch.equal(written, made)


def test_trs_hard_cases_match_jax():
    r = np.random.default_rng(0)
    B = r.normal(size=(16, 8, 8))
    H = (B + B.transpose(0, 2, 1)) / 2
    c = r.normal(size=(16, 8))
    c[::3] = 0.0
    radius = np.full(16, 2.0)
    ij = J.trs_solve(jnp.asarray(H), jnp.asarray(c), jnp.asarray(radius))
    it = T.trs_solve(H, c, radius, device="cpu")
    assert np.array_equal(np.asarray(ij.hard_case), it.hard_case.numpy())
    assert bool(it.hard_case.any())
    easy = ~np.asarray(ij.hard_case)
    for k in ("x", "obj", "multiplier"):
        ref = np.asarray(getattr(ij, k))
        got = getattr(it, k).numpy()
        if k == "x":
            ref, got = ref[easy], got[easy]
        assert np.abs(ref - got).max() <= 1e-12 * max(1.0, np.abs(ref).max()), k
