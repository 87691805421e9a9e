"""Distribution: logical meshes and sharded tensors (``placement``), the
sharding rules for parameters, caches and activations (``sharding``),
``shard_map``'s collectives over a logical mesh (``collectives``), and the
shard-native, gather-free dump and restore plumbing (``shard_dump``)."""
from . import collectives, placement, shard_dump, sharding
from .placement import Mesh, NamedSharding, PartitionSpec, ShardedTensor, device_put, from_blocks
from .shard_dump import ShardedTensorState, TilePlan

__all__ = [
    "Mesh",
    "NamedSharding",
    "PartitionSpec",
    "ShardedTensor",
    "ShardedTensorState",
    "TilePlan",
    "collectives",
    "device_put",
    "from_blocks",
    "placement",
    "shard_dump",
    "sharding",
]
