"""Linear algebra of the port: the flat supernodal LDL^T, its hand-written
kernels (factor, extend-add, sweeps), and the sparse KKT layer."""
from .cholesky import (  # noqa: F401
    chol_factor, chol_factor_shifted, chol_ok, chol_solve,
    tridiag_factor, tridiag_solve,
)
