"""KITTI-360 dataset loader (counterpart of `lidar_rt_tpu.data.kitti`;
frames and tracks land on a device, the card unless the caller names
another).

Equivalent of the reference's kitti_loader
(lib/dataloader/kitti_loader/__init__.py): velodyne `.bin` point clouds
rasterized into 66x1030 single-return range images (per-pixel min depth,
max 80 m), hardcoded velo->ego calibration, `poses.txt` ego->world with
forward-fill for missing frames, and 3D bounding-box XML for car/truck/bus
actors.  Differences: the per-point rasterization loop is vectorized numpy
(same binning: round to nearest cell, keep min range), and no cv2/pickle
cache dependency.

Layout expected under `base_dir` (KITTI-360 standard):
    data_3d_raw/<seq>/velodyne_points/data/??????????.bin
    data_pose/<seq>/poses.txt
    data_3d_bboxes/train/<seq>.xml
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET

import numpy as np

import torch

from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.data.frames import LiDARFrames
from lidar_rt_tpu_torch.scene.tracks import ActorTrack, TrackBuilder

W, H = 1030, 66
INC_BOTTOM, INC_TOP = math.radians(-24.9), math.radians(2.0)
MAX_DEPTH = 80.0

# Hardcoded calibration (kitti_loader/__init__.py:15-58).
_CAM2VELO = np.array([
    [0.04307104361, -0.08829286498, 0.995162929, 0.8043914418],
    [-0.999004371, 0.007784614041, 0.04392796942, 0.2993489574],
    [-0.01162548558, -0.9960641394, -0.08786966659, -0.1770225824],
    [0.0, 0.0, 0.0, 1.0]], np.float64)
_CAM2EGO = np.array([
    [0.0371783278, -0.0986182135, 0.9944306009, 1.5752681039],
    [0.9992675562, -0.0053553387, -0.0378902567, 0.0043914093],
    [0.0090621821, 0.9951109327, 0.0983468786, -0.65],
    [0.0, 0.0, 0.0, 1.0]], np.float64)


def velo2ego() -> np.ndarray:
    return _CAM2EGO @ np.linalg.inv(_CAM2VELO)


def load_ego2world(path: str) -> dict[int, np.ndarray]:
    """poses.txt: `frame r00 r01 ... t2` 3x4 rows (kitti:61-73)."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            m = np.eye(4)
            m[:3] = np.asarray([float(x) for x in parts[1:13]]).reshape(3, 4)
            out[int(parts[0])] = m
    return out


def rasterize_points(points: np.ndarray, intensities: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Point cloud -> (range, intensity) 66x1030 raster, min-depth per cell
    (kitti:186-241, vectorized: sort by descending range so nearer points
    overwrite farther ones)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    dist = np.linalg.norm(points, axis=1)
    azimuth = np.arctan2(y, x)
    incl = np.arctan2(z, np.sqrt(x * x + y * y))
    h_res = (-np.pi - np.pi) / W
    v_res = (INC_BOTTOM - INC_TOP) / H
    w_idx = np.round((azimuth - np.pi) / h_res).astype(np.int64)
    h_idx = np.round((incl - INC_TOP) / v_res).astype(np.int64)
    ok = ((dist <= MAX_DEPTH) & (w_idx >= 0) & (w_idx < W)
          & (h_idx >= 0) & (h_idx < H))
    w_idx, h_idx = w_idx[ok], h_idx[ok]
    dist, inten = dist[ok], intensities[ok]
    order = np.argsort(-dist)          # nearest written last wins
    rng = np.zeros((H, W), np.float32)
    im = np.zeros((H, W), np.float32)
    rng[h_idx[order], w_idx[order]] = dist[order]
    im[h_idx[order], w_idx[order]] = inten[order]
    return rng, im


def load_bboxes(xml_path: str, frame_range: tuple[int, int],
                num_frames: int, device: str | torch.device = "cuda"
                ) -> list[ActorTrack]:
    """3D bbox XML -> car/truck/bus tracks (kitti:84-148).  Box size is the
    SVD singular values of the transform's 3x3 (grown to the max over
    frames); the rotation is the SVD's U factor."""
    with open(xml_path) as f:
        root = ET.fromstring(f.read())
    builders: dict[str, TrackBuilder] = {}
    for obj in root:
        label = obj.find("label").text
        if label not in ("car", "truck", "bus"):
            continue
        ts = int(obj.find("timestamp").text)
        if ts < frame_range[0] or ts > frame_range[1]:
            continue
        rows = int(obj.find("transform/rows").text)
        cols = int(obj.find("transform/cols").text)
        data = [float(v) for v in obj.find("transform/data").text.split()]
        transform = np.asarray(data).reshape(rows, cols)
        oid = obj.find("instanceId").text
        if oid not in builders:
            _, s, _ = np.linalg.svd(transform[:3, :3])
            builders[oid] = TrackBuilder(num_frames, s, object_id=oid,
                                         object_type="vehicle")
        builders[oid].add_frame_kitti(ts - frame_range[0], transform)
    return [b.build(device) for b in builders.values()]


def load(base_dir: str, args, device: str | torch.device = "cuda"
         ) -> tuple[LiDARFrames, list[ActorTrack] | None]:
    """-> (LiDARFrames, tracks) on `device`.  args needs frame_length
    [a, b] and optionally seq (default "0000") (kitti:169-183)."""
    seq = str(getattr(args, "seq", "0000"))
    f0, f1 = (int(v) for v in args.frame_length)
    full_seq = f"2013_05_28_drive_{seq}_sync"
    num_frames = f1 - f0 + 1

    v2e = velo2ego()
    ego2world = load_ego2world(
        os.path.join(base_dir, "data_pose", full_seq, "poses.txt"))

    grid = rays_lib.SensorGrid.from_bounds(
        H, (INC_BOTTOM, INC_TOP), pixel_offset=0.0, angle_offset=0.0,
        device=device)

    poses = np.zeros((num_frames, 4, 4), np.float32)
    r1 = np.zeros((num_frames, H, W), np.float32)
    i1 = np.zeros((num_frames, H, W), np.float32)

    # forward-fill missing ego poses, searching backward for the first
    # (kitti:200-206)
    last = None
    for pre in range(f0, -1, -1):
        if pre in ego2world:
            last = ego2world[pre]
            break

    lidar_dir = os.path.join(base_dir, "data_3d_raw", full_seq,
                             "velodyne_points", "data")
    for f in range(f0, f1 + 1):
        pts = np.fromfile(os.path.join(lidar_dir, f"{f:010d}.bin"),
                          dtype=np.float32).reshape(-1, 4)
        r1[f - f0], i1[f - f0] = rasterize_points(pts[:, :3], pts[:, 3])
        if f in ego2world:
            last = ego2world[f]
        poses[f - f0] = (last @ v2e).astype(np.float32)

    frames = LiDARFrames.from_numpy(grid, poses, r1, i1, device=device,
                                    frame_numbers=range(f0, f1 + 1))
    ef = getattr(args, "eval_frames", None)
    if ef:
        frames.eval_frames = [int(e) - f0 for e in ef]
        frames.train_frames = [i for i in range(num_frames)
                               if i not in frames.eval_frames]
    else:
        frames.split_train_eval()

    xml_path = os.path.join(base_dir, "data_3d_bboxes", "train",
                            full_seq + ".xml")
    tracks = None
    if bool(getattr(args, "dynamic", False)) and os.path.exists(xml_path):
        tracks = load_bboxes(xml_path, (f0, f1), num_frames, device)
    return frames, tracks
