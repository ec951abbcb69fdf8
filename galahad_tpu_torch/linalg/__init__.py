"""Linear algebra of the port: the flat and the inline supernodal LDL^T,
their hand-written kernels (factor, extend-add, sweeps), the sparse KKT
layer, and the services SLS, PSLS, SCU, ULS, IR, MIQR, MOP and CONVERT."""
from .cholesky import (  # noqa: F401
    chol_factor, chol_factor_shifted, chol_ok, chol_solve,
    tridiag_factor, tridiag_solve,
)
