"""QP solvers of the port (the interior-point method, sparse and dense)."""
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
    ipm_step,
)
