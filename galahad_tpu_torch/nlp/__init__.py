"""Nonlinear optimization: TRU / TRB (``tru``), ARC (``arc``), NLS dense and
sparse (``nls``), CHECK / FDH (``check``), on the card unless the caller asks
for the CPU.  LANCELOT and FILTRANE are not ported yet."""
from .arc import ARCControl, arc_solve  # noqa: F401
from .check import (  # noqa: F401
    CheckControl, CheckInfo, FDHPattern,
    check_derivatives, fdh_analyse, fdh_estimate,
)
from .nls import NLSControl, nls_solve, nls_solve_sparse  # noqa: F401
from .tru import TRBControl, TRUControl, TRUState, trb_solve, tru_solve  # noqa: F401
