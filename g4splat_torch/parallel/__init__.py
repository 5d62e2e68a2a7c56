"""Multi-device paths on one controller: device meshes, view and tile
fan-out, depth-slab composition and slab-sharded training."""
from g4splat_torch.parallel.mesh import (
    DeviceMesh,
    available_devices,
    data_parallel_train_step,
    make_mesh,
    replicate,
    shard_batch,
)
