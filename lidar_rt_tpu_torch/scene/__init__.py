"""Scene state: padded surfel assets, actor tracks, frame composition, and
the numpy loader that carries scenes into the port."""

from lidar_rt_tpu_torch.scene.asset import GaussianAsset  # noqa: F401
from lidar_rt_tpu_torch.scene.convert import scene_from_numpy  # noqa: F401
from lidar_rt_tpu_torch.scene.scene import (Scene, compose,  # noqa: F401
                                           split_by_asset)
from lidar_rt_tpu_torch.scene.tracks import ActorTrack  # noqa: F401
