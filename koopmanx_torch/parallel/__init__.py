"""Several cards: the scenario mesh, sharded loops and reductions
(counterparts of ``koopmanx/parallel/``)."""
from .mesh import (
    DATA_AXIS,
    data_sharding,
    initialize_multihost,
    make_mesh,
    replicated,
    shard_batch,
)
from .sharded import distributed_edmd_fit, psum_mean, sharded_closed_loop
