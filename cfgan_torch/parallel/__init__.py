"""Data parallelism over a device mesh (mirrors `cfgan/parallel`): one
process per device in a `torch.distributed` world (`mesh`, 1-D or
("data", "model")), and the rows, replication, channel-sharded layout and
collectives of the sharded step (`sharding`)."""
from cfgan_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    local_device_count,
    multihost_initialize,
    spawn_world,
)
from cfgan_torch.parallel.sharding import (
    batch_sharding,
    channel_sharding_spec,
    replicate,
    replicate_sharding,
    shard_batch,
    shard_leaves,
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
    "channel_sharding_spec",
    "shard_leaves",
]
