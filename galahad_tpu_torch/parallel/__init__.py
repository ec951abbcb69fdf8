from .mesh import (  # noqa: F401
    batch_ipm_solve,
    make_mesh,
    model_sharded_step,
    shard_batch,
)
from .schur import block_angular_residual, block_angular_solve  # noqa: F401,E402
