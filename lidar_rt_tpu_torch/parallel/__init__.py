"""Scale-out: column-band ray sharding and frame data parallelism over
`torch.distributed` (counterpart of `lidar_rt_tpu.parallel`).

  * "rays": a scan's azimuth axis is split into contiguous column bands;
    each rank bins and traces its own band against the replicated
    surfels, and the bundle's gradients are summed over the bands.
  * "dp": frames are data-parallel; gradients are summed over the world
    as the loss is (a global masked mean, a mean of per-cell terms).

Parameters are replicated: a scene's parameters are tens of MB.

- sharding:    `Mesh`, `make_mesh`, `trace_ray_sharded`, `gather_bands`
- train_step:  the sharded loss, bin cache and training step
- trainer:     `ShardedTrainer`, the `Trainer` schedule on the mesh
- world:       `run_world`, a world of spawned ranks on this host
"""

from lidar_rt_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh, gather_bands, make_mesh, trace_ray_sharded)
from lidar_rt_tpu_torch.parallel.train_step import (  # noqa: F401
    band_width, fresh_bins, make_sharded_bin_fn, make_sharded_loss_fn,
    make_sharded_train_step, stack_batches)
from lidar_rt_tpu_torch.parallel.trainer import ShardedTrainer  # noqa: F401
from lidar_rt_tpu_torch.parallel.world import run_world  # noqa: F401
