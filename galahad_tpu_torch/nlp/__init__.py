"""Nonlinear optimization: TRU / TRB (``tru``), ARC (``arc``), NLS dense and
sparse (``nls``), CHECK / FDH (``check``), LANCELOT (``lancelot``,
``lancelot_simple``) and FILTRANE with its filter (``filtrane``), on the card
unless the caller asks for the CPU."""
from .arc import ARCControl, arc_solve  # noqa: F401
from .check import (  # noqa: F401
    CheckControl, CheckInfo, FDHPattern,
    check_derivatives, fdh_analyse, fdh_estimate,
)
from .filtrane import (  # noqa: F401
    Filter, FiltraneControl, FiltraneInfo,
    filter_acceptable, filter_add, filter_init, filtrane_solve,
)
from .lancelot import LancelotControl, LancelotInfo, lancelot_solve  # noqa: F401
from .lancelot_simple import lancelot_simple  # noqa: F401
from .nls import NLSControl, nls_solve, nls_solve_sparse  # noqa: F401
from .tru import TRBControl, TRUControl, TRUState, trb_solve, tru_solve  # noqa: F401
