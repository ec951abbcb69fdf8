"""Problem preprocessing of the port: scaling and presolve (dense QP).

Counterpart of galahad_tpu/pre/ without ``fdc.py`` (not ported yet)."""
from .presolve import (  # noqa: F401
    PresolveControl,
    PresolveInfo,
    PresolveTransform,
    presolve_apply,
    presolve_reduce,
    presolve_restore,
)
from .scale import ScaleControl, Scaling, scale_apply, scale_get, scale_recover  # noqa: F401
