"""Rigid actor tracks: per-frame box poses (counterpart of
`lidar_rt_tpu.scene.tracks`).  Every frame has a pose; missing observations
were filled when the track was built."""

from __future__ import annotations

from dataclasses import dataclass

import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class ActorTrack:
    """One actor's box and trajectory, or M stacked ones (leading axis M).

    size (3,); translations (F, 3) world box centers; quats (F, 4) world
    box orientations (wxyz); present (F,) bool: observed (vs filled).
    """

    size: Tensor
    translations: Tensor
    quats: Tensor
    present: Tensor

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
