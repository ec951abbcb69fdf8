"""Quasi-Newton kit: limited-memory secant Hessians (``lms``), dense secant
updates (``sec``) and sparse Hessian recovery from secant pairs (``sha``)."""
from .lms import (  # noqa: F401
    LMSControl,
    LMSData,
    lms_apply,
    lms_apply_inverse,
    lms_operator,
    lms_setup,
    lms_update,
)
from .sec import bfgs_update, sec_initial, sr1_update  # noqa: F401
from .sha import SHAPattern, sha_analyse, sha_estimate  # noqa: F401
