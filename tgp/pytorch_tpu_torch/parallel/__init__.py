from .mesh import (
    make_mesh,
    batch_sharding,
    param_sharding,
    replicate,
    shard_batch,
    make_sharded_train_step,
)
from . import multihost
