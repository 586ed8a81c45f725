"""Scene = background surfel cloud + rigid dynamic actors, composed per
frame (counterpart of `lidar_rt_tpu.scene.scene`).

Actors are stacked into one asset (leading axis M, equal capacity A), so the
flattened world-frame bundle has B + M*A surfels whatever the alive counts.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from lidar_rt_tpu_torch.core import quaternions as quat_lib
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scene.asset import GaussianAsset
from lidar_rt_tpu_torch.scene.tracks import ActorTrack
from lidar_rt_tpu_torch.utils import profiling

Tensor = torch.Tensor


@dataclass(frozen=True)
class Scene:
    """background: GaussianAsset in world coordinates; actors/tracks:
    stacked with leading axis M, or None for a static scene."""

    background: GaussianAsset
    actors: GaussianAsset | None = None
    tracks: ActorTrack | None = None

    @property
    def num_actors(self) -> int:
        return 0 if self.actors is None else self.actors.xyz.shape[0]

    @property
    def num_frames(self) -> int:
        """Length of the actor timeline (1 for a static scene)."""
        return 1 if self.tracks is None else self.tracks.num_frames

    @property
    def total_capacity(self) -> int:
        """Surfel slots of the composed bundle: B + M*A."""
        cap = self.background.capacity
        if self.actors is not None:
            cap += self.actors.xyz.shape[0] * self.actors.xyz.shape[1]
        return cap

    def one_up_sh_degree(self) -> "Scene":
        return dataclasses.replace(
            self, background=self.background.one_up_sh_degree(),
            actors=None if self.actors is None
            else self.actors.one_up_sh_degree())


def _actor_world(actors: GaussianAsset, tracks: ActorTrack, frame: int
                 ) -> tuple[Tensor, Tensor]:
    """World positions and rotations of all actors at `frame`:

        xyz_world = R_box @ xyz_local + T_box
        q_world   = q_box * normalize(q_local)

    Returns ((M, A, 3), (M, A, 4)).  The rotation is an elementwise sum,
    full f32 whatever the matmul precision setting."""
    t_box, q_box = tracks.pose(frame)                         # (M, 3), (M, 4)
    r_box = quat_lib.to_rotation_matrix(q_box)                # (M, 3, 3)
    xyz_world = ((r_box[:, None] * actors.xyz[:, :, None, :]).sum(-1)
                 + t_box[:, None, :])
    q_world = quat_lib.multiply(q_box[:, None, :],
                                quat_lib.normalize(actors.quat))
    return xyz_world, q_world


def compose(scene: Scene, frame: int, decomp: str | None = None
            ) -> tuple[SurfelBundle, Tensor]:
    """Flatten the scene at a frame into a world-frame render bundle.

    Returns (bundle, alive): background slots first, then actors; dead
    slots carry opacity 0.  The frame index is clamped to the timeline.
    decomp: None renders everything; "background" / "object" zero the
    other subset's opacities.
    """
    with profiling.span("compose"):
        if decomp not in (None, "background", "object"):
            raise ValueError(f"unknown decomp {decomp!r}")
        frame = min(int(frame), scene.num_frames - 1)
        bg = scene.background
        bg_gate = 0.0 if decomp == "object" else 1.0
        ac_gate = 0.0 if decomp == "background" else 1.0
        means = [bg.xyz]
        quats = [bg.rotation]
        scales = [bg.scales]
        opac = [torch.where(bg.alive, bg.opacity * bg_gate, 0.0)]
        shs = [bg.sh]
        alive = [bg.alive]

        if scene.actors is not None:
            ac = scene.actors
            xyz_w, q_w = _actor_world(ac, scene.tracks, frame)
            m, a = ac.xyz.shape[:2]
            means.append(xyz_w.reshape(m * a, 3))
            quats.append(q_w.reshape(m * a, 4))
            scales.append(ac.scales.reshape(m * a, 2))
            opac.append(torch.where(ac.alive, ac.opacity * ac_gate,
                                    0.0).reshape(m * a))
            shs.append(ac.sh.reshape(m * a, 16, 3))
            alive.append(ac.alive.reshape(m * a))

        bundle = SurfelBundle(
            means=torch.cat(means), rotations=torch.cat(quats),
            scales=torch.cat(scales), opacities=torch.cat(opac),
            sh=torch.cat(shs))
        return bundle, torch.cat(alive)


def split_by_asset(scene: Scene, flat: Tensor) -> list[Tensor]:
    """Split a per-splat (B + M*A, ...) tensor into per-asset views ordered
    background first, then each actor (routes tracer gradients and weights
    to each asset's densify statistics)."""
    sizes = [scene.background.capacity]
    if scene.actors is not None:
        m, a = scene.actors.xyz.shape[:2]
        sizes.extend([a] * m)
    return list(torch.split(flat, sizes))
