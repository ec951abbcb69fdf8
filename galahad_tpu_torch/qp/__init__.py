"""QP solvers of the port (the interior-point method: sparse, banded and dense)."""
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
from .ipm_banded import (  # noqa: F401
    BandedQP,
    ipm_solve_banded,
    ipm_solve_banded_compiled,
    make_banded_qp,
)
from .wrappers import bqpb_solve, lpb_solve  # noqa: F401
