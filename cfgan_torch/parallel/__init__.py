"""Data parallelism over a device mesh (mirrors `cfgan/parallel`): one
process per device in a `torch.distributed` world (`mesh`), and the rows,
replication and collectives of the sharded step (`sharding`)."""
from cfgan_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    local_device_count,
    multihost_initialize,
    spawn_world,
)
from cfgan_torch.parallel.sharding import (
    batch_sharding,
    replicate,
    replicate_sharding,
    shard_batch,
)

__all__ = [
    "Mesh",
    "create_mesh",
    "local_device_count",
    "multihost_initialize",
    "spawn_world",
    "batch_sharding",
    "replicate_sharding",
    "shard_batch",
    "replicate",
]
