"""Support utilities (counterpart of `lidar_rt_tpu.utils`): checkpoints,
the training recorder, console logging, export, profiling hooks and the
import of the original LiDAR-RT checkpoints."""
