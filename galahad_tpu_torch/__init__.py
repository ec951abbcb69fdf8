"""galahad_tpu_torch: the PyTorch/CUDA port of galahad_tpu, slice by slice.

The JAX package ``galahad_tpu`` is the reference and is not imported from
here; this package imports ``torch`` and keeps its own copy of what it
needs.  Ported so far: the interior-point QP solve (``qp.ipm_solve``,
Mehrotra or a series arc) of a sparse problem (``make_sparse_qp`` /
``io.qplib.read_sparse_qp``) over the flat supernodal LDL^T and its
hand-written CUDA kernels, of a dense one (``make_qp`` /
``io.qplib.read_qp``) over SBLS's Schur-complement Cholesky pair, and of a
banded one (``qp.make_banded_qp``) over the block-tridiagonal kernels; the
dual projection solvers DQP, CCQP and DLP (``qp.dqp``); the front end
``qp.qp_solve`` with scaling and presolve (``pre``), LSQP, WCP and L1QP; the
command line ``python -m galahad_tpu_torch solve|batch`` (``cli``); and the
trust-region and regularization subproblems (``tr``: TRS, RQS, DPS, GLTR/GLRT,
LSTR/LSRT/L2RT, LQR/LQT, LLST/LLS and the sparse TRS on the flat LDL^T); the
quasi-Newton kit (``qn``: LMS, SEC, SHA), the NLP solvers (``nlp``: TRU, TRB,
ARC, NLS dense and sparse, CHECK / FDH, with ``core.problem.NLP``) and the
sparse normal-matrix assembly BSC (``linalg.bsc``).

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``); float64 is the default precision.
"""
from .core.config import apply_specfile, read_specfile  # noqa: F401
from .core.problem import INFINITY, QP, BoundMasks, check_qp, classify_bounds, make_qp  # noqa: F401
from .core.sparse import COOPattern, SparseQP, make_sparse_qp  # noqa: F401
from .core.status import Status, status_message  # noqa: F401

__all__ = [
    "INFINITY", "QP", "BoundMasks", "COOPattern", "SparseQP", "Status",
    "apply_specfile", "check_qp", "classify_bounds", "make_qp", "make_sparse_qp",
    "read_specfile", "status_message",
]
