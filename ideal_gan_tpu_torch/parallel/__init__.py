"""The data mesh, multi-process execution and multi-device serving (port
of `ideal_gan_tpu/parallel/`): one process per card under
`torch.distributed` for training, one process over the local cards for
serving."""

from .mesh import (
    batch_sharding,
    data_mesh,
    data_mesh_for_batch,
    replicate,
    shard_batch,
)
from .multihost import (
    global_data_mesh,
    host_local_to_global,
    initialize_distributed,
    process_batch_slice,
)
from .serving import make_sharded_fit

__all__ = ["data_mesh", "data_mesh_for_batch", "batch_sharding",
           "shard_batch", "replicate", "make_sharded_fit",
           "initialize_distributed", "global_data_mesh",
           "process_batch_slice", "host_local_to_global"]
