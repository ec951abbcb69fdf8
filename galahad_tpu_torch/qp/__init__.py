"""QP solvers of the port (the sparse interior-point method)."""
from .ipm import (  # noqa: F401
    IPMControl,
    IPMInform,
    IPMState,
    PhaseTimes,
    extract_solution,
    ipm_indicators,
    ipm_init,
    ipm_solve,
    ipm_solve_compiled,
)
