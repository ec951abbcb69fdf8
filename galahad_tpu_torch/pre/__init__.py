"""Problem preprocessing of the port: scaling and presolve (dense QP), and
FDC, the detection of dependent equality constraints.

Counterpart of galahad_tpu/pre/."""
from .presolve import (  # noqa: F401
    PresolveControl,
    PresolveInfo,
    PresolveTransform,
    presolve_apply,
    presolve_reduce,
    presolve_restore,
)
from .scale import ScaleControl, Scaling, scale_apply, scale_get, scale_recover  # noqa: F401
from .fdc import FDCControl, FDCInfo, fdc_find_dependent  # noqa: F401
