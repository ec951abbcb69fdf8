"""Global optimization: LHS sampling, UGO (univariate), BGO (multistart TRB)
and DGO (box trisection), on the card unless the caller asks for the CPU."""
from .bgo import BGOControl, BGOInfo, bgo_solve  # noqa: F401
from .dgo import DGOControl, DGOInfo, dgo_solve  # noqa: F401
from .lhs import lhs_sample, lhs_sample_box  # noqa: F401
from .ugo import UGOControl, UGOInfo, ugo_solve  # noqa: F401
