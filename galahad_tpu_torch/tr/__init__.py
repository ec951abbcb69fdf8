"""Trust-region and regularization subproblems: TRS, RQS, DPS and the
factorization TRS (``trs``), the sparse TRS on the flat LDL^T
(``trs_sparse``), GLTR / GLRT (``gltr``), LSTR / LSRT / L2RT (``lstr``),
LQR / LQT (``lqr``) and LLST / LLS (``llst``).  The secular Newton
iterations run as hand-written kernels on the card (``secular_kernels``)."""
from .trs import (  # noqa: F401
    TRSControl, TRSInfo, RQSControl,
    trs_solve, trs_solve_diagonal, rqs_solve, dps_solve, trs_solve_chol,
)
from .gltr import GLTRControl, GLRTControl, GLTRInfo, gltr_solve, glrt_solve  # noqa: F401
from .lstr import (  # noqa: F401
    L2RTControl, LSRTControl, LSTRControl, LSTRInfo,
    l2rt_solve, lsrt_solve, lstr_solve,
)
from .llst import LLSTControl, LLSTInfo, llst_solve, lls_solve  # noqa: F401
from .lqr import LQRControl, LQRInfo, lqr_solve, lqt_solve  # noqa: F401
from .trs_sparse import (  # noqa: F401
    TRSSparseControl, TRSSparseInfo, trs_solve_sparse, trs_contract,
)
