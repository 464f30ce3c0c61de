"""Scale-out: device meshes, sharded state, event routing.

Port of the JAX package's ``parallel/``.  The reference's scale axis is
key-partitioned parallelism (``partition with (key of S)``); here:

- the partition axis is sharded over a mesh, an ordered list of
  devices (``make_mesh``): per-key NFA, window and aggregator state
  rows live on the devices, each shard owning a contiguous range of
  keys as its own dict of tensors;
- the step runs once a shard on the shard's rows: a shard owns its
  keys, so the hot path needs no collective; the shards' match counts
  are summed on the first shard's device (the reference's ``psum``)
  and their outputs fetched with one coalesced copy a device;
- events are routed on the host to their owning shard
  (``route_to_shards``);
- multi-process bring-up wraps ``torch.distributed``
  (``distributed_initialize``).

The reference's ``ensure_virtual_devices`` and ``get_shard_map`` are
JAX plumbing and have no counterpart (``parallel/mesh.py``).
"""

from siddhi_tpu_torch.parallel.device_shard import ShardedDeviceQueryEngine
from siddhi_tpu_torch.parallel.mesh import (
    ShardedPatternEngine,
    distributed_initialize,
    make_mesh,
    route_to_shards,
)

__all__ = [
    "ShardedDeviceQueryEngine",
    "ShardedPatternEngine",
    "distributed_initialize",
    "make_mesh",
    "route_to_shards",
]
