"""Rigid actor tracks: per-frame box poses (counterpart of
`lidar_rt_tpu.scene.tracks`).  Every frame has a pose; missing observations
are filled when the track is built.

`TrackBuilder` gathers a dataset's sparse observations on the host in
numpy float32, as the reference does, so both packages size and place the
same boxes to the bit; `build` puts the dense track on a device:

  * Waymo: box center in the ego frame + yaw -> world pose;
  * KITTI-360: a 3x4 obj2world transform, split by SVD into rotation and
    size (the size grows to the largest over frames).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lidar_rt_tpu_torch.core import quaternions as quat_lib
from lidar_rt_tpu_torch.core import transforms

Tensor = torch.Tensor


@dataclass(frozen=True)
class ActorTrack:
    """One actor's box and trajectory, or M stacked ones (leading axis M).

    size (3,); translations (F, 3) world box centers; quats (F, 4) world
    box orientations (wxyz); present (F,) bool: observed (vs filled).
    Stacked tracks join their ids and types with "|".
    """

    size: Tensor
    translations: Tensor
    quats: Tensor
    present: Tensor
    object_id: str = ""
    object_type: str = "vehicle"

    @property
    def num_frames(self) -> int:
        return self.translations.shape[-2]

    @property
    def min_xyz(self) -> Tensor:
        """Box corner in the box frame, (..., 3)."""
        return -self.size / 2.0

    @property
    def max_xyz(self) -> Tensor:
        return self.size / 2.0

    def pose(self, frame: int) -> tuple[Tensor, Tensor]:
        """(translation (..., 3), quaternion (..., 4)) at a frame index."""
        return self.translations[..., frame, :], self.quats[..., frame, :]

    def mean_speed(self) -> Tensor:
        """Mean center displacement per frame over pairs of observed
        frames (the reference's dynamic-actor gate)."""
        d = torch.linalg.vector_norm(self.translations.diff(dim=0), dim=-1)
        both = self.present[1:] & self.present[:-1]
        return (d * both).sum() / both.sum().clamp_min(1)


def _quat_of(r: np.ndarray) -> np.ndarray:
    return quat_lib.from_rotation_matrix(torch.from_numpy(r)).numpy()


class TrackBuilder:
    """Accumulates sparse per-frame observations, emits a dense track."""

    def __init__(self, num_frames: int, size, object_id: str = "",
                 object_type: str = "vehicle"):
        self.num_frames = num_frames
        self.size = np.asarray(size, np.float32)
        self.object_id = object_id
        self.object_type = object_type
        self._t = np.zeros((num_frames, 3), np.float32)
        self._q = np.tile(np.array([1, 0, 0, 0], np.float32), (num_frames, 1))
        self._present = np.zeros((num_frames,), bool)

    def add_frame_waymo(self, frame: int, center_ego, yaw: float,
                        ego2world) -> None:
        """Ego-frame yaw box -> world pose."""
        ego2world = np.asarray(ego2world, np.float32)
        center = ego2world[:3, :3] @ np.asarray(center_ego, np.float32) \
            + ego2world[:3, 3]
        c, s = np.cos(yaw), np.sin(yaw)
        r_yaw = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        self._set(frame, center, _quat_of(ego2world[:3, :3] @ r_yaw))

    def add_frame_kitti(self, frame: int, transform) -> None:
        """Full 3x4/4x4 obj2world: the SVD's U is the rotation, its
        singular values the size (grown to the largest over frames)."""
        transform = np.asarray(transform, np.float32)
        u, s, _ = np.linalg.svd(transform[:3, :3])
        self.size = np.maximum(self.size, s.astype(np.float32))
        self._set(frame, transform[:3, 3], _quat_of(u))

    def add_frame_pose(self, frame: int, translation, quat_wxyz) -> None:
        self._set(frame, np.asarray(translation, np.float32),
                  np.asarray(quat_wxyz, np.float32))

    def _set(self, frame: int, t, q) -> None:
        self._t[frame] = t
        self._q[frame] = q
        self._present[frame] = True

    def build(self, device: str | torch.device = "cuda") -> ActorTrack:
        """The dense track on `device`, the card unless the caller names
        another."""
        t, q = transforms.forward_fill_poses(self._present, self._t, self._q)
        return ActorTrack(
            size=torch.tensor(self.size, device=device),
            translations=torch.tensor(t, device=device),
            quats=torch.tensor(q, device=device),
            present=torch.tensor(self._present, device=device),
            object_id=self.object_id, object_type=self.object_type)


def stack_tracks(tracks: list[ActorTrack]) -> ActorTrack:
    """Stack M tracks into one with leading axis M."""
    return ActorTrack(
        size=torch.stack([t.size for t in tracks]),
        translations=torch.stack([t.translations for t in tracks]),
        quats=torch.stack([t.quats for t in tracks]),
        present=torch.stack([t.present for t in tracks]),
        object_id="|".join(t.object_id for t in tracks),
        object_type="|".join(t.object_type for t in tracks))
