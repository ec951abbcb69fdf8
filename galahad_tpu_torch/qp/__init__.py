"""QP solvers of the port: the interior-point method (sparse, banded and
dense), DQP / CCQP, the named wrappers, the ``qp_solve`` front end, BQP /
BLLS and EQP, the QCQP, the active-set QPA / QPC, QPB, the simplex LPA,
the crossover CRO and the LPQP reformulation."""
from .bqp import BLLSControl, BQPControl, BQPInfo, blls_solve, bqp_solve  # noqa: F401
from .eqp import EQPControl, EQPInfo, eqp_solve  # noqa: F401
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
from .dqp import DQPControl, DQPInfo, ccqp_solve, dqp_solve  # noqa: F401
from .frontend import (  # noqa: F401
    L1QPControl, QPControl, QPInfo, WCPControl,
    l1qp_solve, lsqp_solve, qp_solve, wcp_solve,
)
from .wrappers import bqpb_solve, dlp_solve, lpb_solve  # noqa: F401
from .qcqp import QCQP, QCQPControl, QCQPInfo, qcqp_solve  # noqa: F401
from .cro import CROControl, CROInfo, cro_crossover  # noqa: F401
from .lpa import LPAControl, LPAInfo, lpa_solve  # noqa: F401
from .lpqp import lpqp_formulate, lpqp_restore, lpqp_violation  # noqa: F401
from .qpa import QPAControl, QPAInfo, qpa_solve, qpc_solve  # noqa: F401
from .qpb import QPBControl, QPBInfo, qpb_solve  # noqa: F401
