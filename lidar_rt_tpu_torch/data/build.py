"""Scene assembly: sensor frames + actor tracks -> initialized Scene
(counterpart of `lidar_rt_tpu.data.build`), on the frames' device.

Every frame is back-projected to world points, given PCA normals, and its
points inside a moving actor's box are carved into that box's frame.  The
background is voxel-downsampled (or subsampled), actors are padded or
subsampled to `model.obj_pt_num` points, and each becomes a
`GaussianAsset` through `from_points`.

Normals are estimated per frame with the cloud padded to a multiple of
32,768 points by filler at 1e7 m, as the reference pads it to reuse one
compiled program.  The filler stretches the Morton bounding box, so every
real point gets the same Morton code and its neighbourhood is its +-32
neighbours in raster order: the port pads the same way so that it picks
the same neighbours.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidar_rt_tpu_torch.core import quaternions as quat_lib
from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.data.frames import LiDARFrames
from lidar_rt_tpu_torch.ops import knn as knn_lib
from lidar_rt_tpu_torch.scene.asset import GaussianAsset, from_points
from lidar_rt_tpu_torch.scene.scene import Scene
from lidar_rt_tpu_torch.scene.tracks import ActorTrack, stack_tracks

Tensor = torch.Tensor

DYNAMIC_SPEED_THRESHOLD = 0.01   # mean displacement per frame
DYNAMIC_TYPES = ("vehicle", "1", "car", "truck", "bus")

_NORMAL_PAD_BUCKET = 32768


def _estimate_normals_padded(pts: Tensor, center: Tensor) -> Tensor:
    """6-NN PCA normals of one frame's points, the cloud padded with far
    filler to a multiple of the bucket size (see the module docstring)."""
    n = pts.shape[0]
    padded = -(-max(n, 1) // _NORMAL_PAD_BUCKET) * _NORMAL_PAD_BUCKET
    if padded != n:
        filler = torch.full((padded - n, 3), 1e7, device=pts.device) \
            + torch.arange(padded - n, dtype=torch.float32,
                           device=pts.device)[:, None]
        pts = torch.cat([pts, filler])
    return knn_lib.estimate_normals(pts, center, k=6)[:n]


def voxel_downsample(points: Tensor, attrs: list[Tensor], voxel_size: float
                     ) -> tuple[Tensor, list[Tensor]]:
    """Average points and their attributes per occupied voxel, voxels in
    lexicographic order of their integer coordinates.  Sums are taken in
    float64 and rounded to float32."""
    ids = torch.floor(points / voxel_size).to(torch.int64)
    lo = ids.amin(0)
    span = ids.amax(0) - lo + 1
    if float(span.double().prod()) >= 2.0 ** 62:
        raise ValueError(f"voxel grid {span.tolist()} too large to key")
    rel = ids - lo
    key = (rel[:, 0] * span[1] + rel[:, 1]) * span[2] + rel[:, 2]
    _, inverse, counts = torch.unique(key, return_inverse=True,
                                      return_counts=True)

    def seg_mean(x):
        out = torch.zeros((counts.shape[0],) + x.shape[1:],
                          dtype=torch.float64, device=x.device)
        out.index_add_(0, inverse, x.double())
        return (out / counts.view(-1, *([1] * (x.dim() - 1)))).float()

    return seg_mean(points), [seg_mean(a) for a in attrs]


def round_capacity(n: int, headroom: float, multiple: int = 1024) -> int:
    """Padded capacity: n * headroom rounded up to a multiple, never below
    n itself."""
    target = max(n, int(n * max(headroom, 1.0)))
    return max(multiple, -(-target // multiple) * multiple)


def select_dynamic_tracks(tracks: list[ActorTrack]) -> list[ActorTrack]:
    """Actors worth modelling: moving vehicles."""
    return [t for t in tracks
            if float(t.mean_speed()) > DYNAMIC_SPEED_THRESHOLD
            and t.object_type in DYNAMIC_TYPES]


def _init_color(inten: Tensor) -> Tensor:
    """The seed color triplet (intensity, hit = 1, drop = 0)."""
    return torch.stack([inten, torch.ones_like(inten),
                        torch.zeros_like(inten)], dim=1)


def assemble_scene(frames: LiDARFrames, tracks: list[ActorTrack] | None,
                   args, generator: torch.Generator | None = None,
                   capacity_headroom: float = 4.0) -> Scene:
    """The initialized Scene on the frames' device.

    args: options with `model.*` and `opt.use_normal_init` /
    `opt.use_voxel_init` (`train.options.rehearsal_options`).  The
    rotations are drawn from `generator` (default: seed 0 on the frames'
    device), the background's first and then each actor's; the
    subsampling and actor padding draw from numpy generators seeded 0 and
    1, as the reference does."""
    dev = frames.range1.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = args.model
    use_normals = bool(args.opt.use_normal_init)
    dynamic = select_dynamic_tracks(tracks or [])

    bg_pts, bg_int, bg_nrm = [], [], []
    actor_data = [([], [], []) for _ in dynamic]
    for f in range(frames.num_frames):
        pts, inten = frames.inverse_projection(f)
        nrm = (_estimate_normals_padded(pts, frames.sensor_center(f))
               if use_normals else torch.zeros_like(pts))
        keep = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
        for a, track in enumerate(dynamic):
            r_box = quat_lib.to_rotation_matrix(track.quats[f])
            local = rays_lib.rotate_points(r_box.T,
                                           pts - track.translations[f])
            inside = (local.abs() < track.size / 2.0).all(dim=1)
            actor_data[a][0].append(local[inside])
            actor_data[a][1].append(inten[inside])
            actor_data[a][2].append(rays_lib.rotate_points(r_box.T,
                                                           nrm[inside]))
            keep &= ~inside
        bg_pts.append(pts[keep])
        bg_int.append(inten[keep])
        bg_nrm.append(nrm[keep])

    pts, nrm = torch.cat(bg_pts), torch.cat(bg_nrm)
    color = _init_color(torch.cat(bg_int))
    if bool(args.opt.use_voxel_init):
        pts, (color, nrm) = voxel_downsample(pts, [color, nrm],
                                             float(model.voxel_size))
    else:
        n_keep = max(1, pts.shape[0] // max(1, frames.num_frames) * 5)
        sel = torch.as_tensor(np.random.default_rng(0).permutation(
            pts.shape[0])[:n_keep], device=dev)
        pts, color, nrm = pts[sel], color[sel], nrm[sel]

    # Scene extent: the 90th percentile diameter times a factor.
    center = pts.double().mean(0).float()
    diam = 2.0 * torch.linalg.vector_norm(pts - center, dim=1)
    extent = float(model.bkgd_extent_factor) * float(
        torch.quantile(diam.double(), 0.90))
    background = from_points(
        pts, color, generator,
        capacity=round_capacity(pts.shape[0], capacity_headroom),
        normals=nrm if use_normals else None,
        max_sh_degree=int(model.sh_degree), extent=extent)
    if not dynamic:
        return Scene(background=background)

    obj_pt_num = int(model.obj_pt_num)
    actor_assets: list[GaussianAsset] = []
    rng = np.random.default_rng(1)
    for a, track in enumerate(dynamic):
        a_pts, a_int, a_nrm = (torch.cat(x) for x in actor_data[a])
        size = track.size.cpu().numpy()
        if a_pts.shape[0] < obj_pt_num:
            extra = obj_pt_num - a_pts.shape[0]
            extra_pts = rng.uniform(size=(extra, 3)).astype(np.float32) \
                * size - size / 2.0
            extra_int = rng.uniform(size=(extra,)).astype(np.float32)
            theta = rng.uniform(0, 2 * np.pi, extra)
            phi = rng.uniform(0, np.pi, extra)
            extra_nrm = np.stack([np.sin(phi) * np.cos(theta),
                                  np.sin(phi) * np.sin(theta),
                                  np.cos(phi)], axis=1).astype(np.float32)
            a_pts = torch.cat([a_pts, torch.as_tensor(extra_pts, device=dev)])
            a_int = torch.cat([a_int, torch.as_tensor(extra_int, device=dev)])
            a_nrm = torch.cat([a_nrm, torch.as_tensor(extra_nrm, device=dev)])
        elif a_pts.shape[0] > obj_pt_num:
            sel = torch.as_tensor(rng.permutation(a_pts.shape[0])[
                :obj_pt_num], device=dev)
            a_pts, a_int, a_nrm = a_pts[sel], a_int[sel], a_nrm[sel]
        actor_assets.append(from_points(
            a_pts, _init_color(a_int), generator,
            capacity=round_capacity(obj_pt_num, capacity_headroom / 2.0),
            normals=a_nrm if use_normals else None,
            max_sh_degree=int(model.sh_degree),
            extent=float(np.linalg.norm(size))
            * float(model.object_extent_factor)))

    # One stacked actor asset (equal capacities by construction) with the
    # largest extent; each actor's box lives in its track.
    stacked = dataclasses.replace(
        actor_assets[0], extent=max(a.extent for a in actor_assets),
        **{f.name: torch.stack([getattr(a, f.name) for a in actor_assets])
           for f in dataclasses.fields(GaussianAsset)
           if isinstance(getattr(actor_assets[0], f.name), torch.Tensor)})
    return Scene(background=background, actors=stacked,
                 tracks=stack_tracks(dynamic))
