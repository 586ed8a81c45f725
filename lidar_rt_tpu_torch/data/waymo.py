"""Waymo Open Dataset loader — TFRecord + protobuf, no TensorFlow
(counterpart of `lidar_rt_tpu.data.waymo`; frames and tracks land on a
device, the card unless the caller names another).

Equivalent of the reference's waymo_loader
(lib/dataloader/waymo_loader/__init__.py:36-131) with its TF dependency
replaced by the wire parser in data/proto_wire.py and `zlib` (the reference
itself flags this as the desired direction — it only used
tf.io.decode_compressed, i.e. ZLIB).

Extracted per frame (TOP lidar, name == 1):
  * calibration: extrinsic lidar->ego 4x4, beam inclinations (or min/max)
  * ego pose 4x4 -> sensor2world
  * both returns' range images (H, W, 4): channel 0 = range, 1 = intensity
    (clamped to 1; -1 "no return" re-coded to 0, waymo_loader:92-102)
  * laser_labels -> vehicle `ActorTrack`s (yaw boxes in ego frame,
    size = (length, width, height), waymo_loader:108-127)

Field numbers follow the public Waymo Open Dataset schema
(dataset.proto / label.proto).
"""

from __future__ import annotations

import os
import zlib

import numpy as np

import torch

from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.data import proto_wire as pw
from lidar_rt_tpu_torch.data.frames import LiDARFrames
from lidar_rt_tpu_torch.scene.tracks import ActorTrack, TrackBuilder

# dataset.proto
F_FRAME_CONTEXT = 1
F_FRAME_POSE = 3
F_FRAME_LASERS = 5
F_FRAME_LASER_LABELS = 6
F_CONTEXT_LASER_CALIBRATIONS = 3
F_CALIB_NAME = 1
F_CALIB_BEAM_INCLINATIONS = 2
F_CALIB_BEAM_INCLINATION_MIN = 3
F_CALIB_BEAM_INCLINATION_MAX = 4
F_CALIB_EXTRINSIC = 5
F_TRANSFORM = 1
F_LASER_NAME = 1
F_LASER_RI_RETURN1 = 2
F_LASER_RI_RETURN2 = 3
F_RI_COMPRESSED = 2
F_MATRIX_DATA = 1
F_MATRIX_SHAPE = 2
F_SHAPE_DIMS = 1
# label.proto
F_LABEL_BOX = 1
F_LABEL_TYPE = 3
F_LABEL_ID = 4
F_BOX_CX, F_BOX_CY, F_BOX_CZ = 1, 2, 3
F_BOX_WIDTH, F_BOX_LENGTH, F_BOX_HEIGHT = 4, 5, 6
F_BOX_HEADING = 7

TOP_LIDAR = 1
TYPE_VEHICLE = 1


def _transform_4x4(msg: bytes | None) -> np.ndarray | None:
    if msg is None:
        return None
    vals = pw.packed_doubles(pw.fields(msg), F_TRANSFORM)
    return np.asarray(vals, np.float32).reshape(4, 4)


def _decompress_matrix(compressed: bytes) -> np.ndarray:
    """zlib MatrixFloat -> ndarray (decompress_range_image equivalent,
    waymo_loader:16-33)."""
    raw = zlib.decompress(compressed)
    f = pw.fields(raw)
    data = np.asarray(pw.packed_floats(f, F_MATRIX_DATA), np.float32)
    shape = pw.packed_int32s(pw.fields(pw.first(f, F_MATRIX_SHAPE)),
                             F_SHAPE_DIMS)
    return data.reshape(shape)


class _FrameParse:
    """Lazy views over one Frame proto."""

    def __init__(self, record: bytes):
        self.f = pw.fields(record)

    def top_calibration(self):
        ctx = pw.fields(pw.first(self.f, F_FRAME_CONTEXT, b""))
        for calib_bytes in ctx.get(F_CONTEXT_LASER_CALIBRATIONS, []):
            c = pw.fields(calib_bytes)
            if pw.first(c, F_CALIB_NAME, 0) != TOP_LIDAR:
                continue
            extrinsic = _transform_4x4(pw.first(c, F_CALIB_EXTRINSIC))
            beams = pw.packed_doubles(c, F_CALIB_BEAM_INCLINATIONS)
            if not beams:
                beams = None
                lo = pw.as_double(pw.first(c, F_CALIB_BEAM_INCLINATION_MIN))
                hi = pw.as_double(pw.first(c, F_CALIB_BEAM_INCLINATION_MAX))
                bounds = (lo, hi)
            else:
                bounds = None
            return extrinsic, beams, bounds
        raise ValueError("no TOP lidar calibration in frame")

    def pose(self) -> np.ndarray:
        return _transform_4x4(pw.first(self.f, F_FRAME_POSE))

    def top_range_images(self) -> tuple[np.ndarray, np.ndarray]:
        for laser_bytes in self.f.get(F_FRAME_LASERS, []):
            laser = pw.fields(laser_bytes)
            if pw.first(laser, F_LASER_NAME, 0) != TOP_LIDAR:
                continue
            r1 = _decompress_matrix(pw.first(
                pw.fields(pw.first(laser, F_LASER_RI_RETURN1)),
                F_RI_COMPRESSED))
            r2 = _decompress_matrix(pw.first(
                pw.fields(pw.first(laser, F_LASER_RI_RETURN2)),
                F_RI_COMPRESSED))
            return r1, r2
        raise ValueError("no TOP lidar return in frame")

    def labels(self):
        """Yield (id, type, center, size_lwh, heading)."""
        for lbl_bytes in self.f.get(F_FRAME_LASER_LABELS, []):
            lbl = pw.fields(lbl_bytes)
            box = pw.fields(pw.first(lbl, F_LABEL_BOX, b""))

            def d(num, default=0.0):
                v = pw.first(box, num)
                return pw.as_double(v) if v is not None else default

            yield (pw.first(lbl, F_LABEL_ID, b"").decode(),
                   pw.first(lbl, F_LABEL_TYPE, 0),
                   np.array([d(F_BOX_CX), d(F_BOX_CY), d(F_BOX_CZ)],
                            np.float32),
                   np.array([d(F_BOX_LENGTH), d(F_BOX_WIDTH),
                             d(F_BOX_HEIGHT)], np.float32),
                   d(F_BOX_HEADING))


def _iter_frames_python(record_path: str, f0: int, f1: int):
    """Yield (idx, pose, (extrinsic, beams, bounds), ri_fn, labels_iter)
    using the pure-Python wire parser."""
    for idx, record in enumerate(pw.tfrecord_iter(record_path)):
        if idx < f0:
            continue
        if idx > f1:
            break
        frame = _FrameParse(record)
        yield (idx, frame.pose(), frame.top_calibration,
               frame.top_range_images, frame.labels)


def _iter_frames_native(record_path: str, f0: int, f1: int):
    """Same protocol via the C++ ingest extension (`native`)."""
    from lidar_rt_tpu_torch import native

    with open(record_path, "rb") as fp:
        buf = fp.read()
    offs, lens = native.tfrecord_index(buf)
    for idx in range(f0, min(f1 + 1, len(offs))):
        rec = buf[offs[idx]:offs[idx] + lens[idx]]
        fd = native.waymo_decode_frame(rec)

        def calib(fd=fd):
            beams = fd.beams if fd.beams.size else None
            bounds = None if beams is not None else fd.beam_minmax
            return fd.extrinsic.astype(np.float32), beams, bounds

        def images(fd=fd):
            return fd.r1, fd.r2

        def labels(fd=fd):
            # native box layout: cx cy cz  width length height  heading type
            for b, oid in zip(fd.boxes, fd.box_ids):
                yield (oid, int(b[7]),
                       np.asarray(b[0:3], np.float32),
                       np.asarray([b[4], b[3], b[5]], np.float32),  # l,w,h
                       float(b[6]))

        yield idx, fd.pose.astype(np.float32), calib, images, labels


def load(base_dir: str, args, use_native: bool | None = None,
         device: str | torch.device = "cuda"
         ) -> tuple[LiDARFrames, list[ActorTrack] | None]:
    """Load frames [frame_length[0], frame_length[1]] of the segment's
    .tfrecord in `base_dir` onto `device`.  Decompressed images are cached
    to `<base_dir>/cache/*.npz` like the reference's .pt cache
    (waymo_loader:82-102).  use_native: force the C++ ingest path on (a
    failed build then raises) or off (default: use it when it builds)."""
    record_path = None
    for name in sorted(os.listdir(base_dir)):
        if name.endswith(".tfrecord"):
            record_path = os.path.join(base_dir, name)
    if record_path is None:
        raise FileNotFoundError(f"no .tfrecord under {base_dir}")
    f0, f1 = (int(v) for v in args.frame_length)
    num_frames = f1 - f0 + 1
    cache_dir = os.path.join(base_dir, "cache")
    os.makedirs(cache_dir, exist_ok=True)

    from lidar_rt_tpu_torch import native
    if use_native is None:
        use_native = native.available()
    elif use_native and not native.available():
        raise RuntimeError(f"native ingest unavailable: "
                           f"{native.build_error()}")
    frame_iter = (_iter_frames_native if use_native
                  else _iter_frames_python)(record_path, f0, f1)

    grid = None
    extrinsic = None
    poses = np.zeros((num_frames, 4, 4), np.float32)
    r1s = i1s = r2s = i2s = None
    builders: dict[str, TrackBuilder] = {}
    label_obs: list[tuple] = []

    for idx, ego2world, calib_fn, images_fn, labels_fn in frame_iter:
        if grid is None:
            extrinsic, beams, bounds = calib_fn()
            angle_offset = float(np.arctan2(extrinsic[1, 0],
                                            extrinsic[0, 0]))
            if beams is not None:
                grid = rays_lib.SensorGrid.from_beams(
                    np.asarray(beams, np.float32), pixel_offset=0.5,
                    angle_offset=angle_offset, device=device)
            else:
                # linear bounds fallback (waymo_loader:63-70)
                grid = None, bounds, angle_offset  # resolved after H known

        poses[idx - f0] = ego2world @ extrinsic

        cache_path = os.path.join(cache_dir, f"frame_{idx}_top.npz")
        if os.path.exists(cache_path):
            with np.load(cache_path) as z:
                ri1, ri2 = z["r1"], z["r2"]
        else:
            ri1, ri2 = images_fn()
            np.savez_compressed(cache_path, r1=ri1, r2=ri2)

        if isinstance(grid, tuple):   # bounds fallback needs H
            _, bounds, angle_offset = grid
            grid = rays_lib.SensorGrid.from_bounds(
                ri1.shape[0], bounds, pixel_offset=0.5,
                angle_offset=angle_offset, device=device)
        if r1s is None:
            h, w = ri1.shape[:2]
            r1s = np.zeros((num_frames, h, w), np.float32)
            i1s = np.zeros((num_frames, h, w), np.float32)
            r2s = np.zeros((num_frames, h, w), np.float32)
            i2s = np.zeros((num_frames, h, w), np.float32)

        # channel 0 = range, 1 = intensity; -1 -> 0, intensity clamp <= 1
        rng1 = np.where(ri1[..., 0] == -1, 0.0, ri1[..., 0])
        int1 = np.clip(np.where(ri1[..., 1] == -1, 0.0, ri1[..., 1]), 0, 1)
        rng2 = np.where(ri2[..., 0] == -1, 0.0, ri2[..., 0])
        int2 = np.clip(np.where(ri2[..., 1] == -1, 0.0, ri2[..., 1]), 0, 1)
        r1s[idx - f0], i1s[idx - f0] = rng1, int1
        r2s[idx - f0], i2s[idx - f0] = rng2, int2

        for oid, tp, center, size_lwh, heading in labels_fn():
            if tp != TYPE_VEHICLE:
                continue
            label_obs.append((oid, idx - f0, center, size_lwh, heading,
                              ego2world))

    # build tracks after sizes known (the reference grows size-maps in place)
    for oid, fi, center, size_lwh, heading, ego2world in label_obs:
        if oid not in builders:
            builders[oid] = TrackBuilder(num_frames, size_lwh,
                                         object_id=oid,
                                         object_type="vehicle")
        builders[oid].add_frame_waymo(fi, center, heading, ego2world)

    frames = LiDARFrames.from_numpy(
        grid, poses, r1s, i1s, device=device, range2=r2s, intensity2=i2s,
        frame_numbers=range(f0, f1 + 1))
    ef = getattr(args, "eval_frames", None)
    if ef:
        frames.eval_frames = [int(e) - f0 for e in ef]
        frames.train_frames = [i for i in range(num_frames)
                               if i not in frames.eval_frames]
    else:
        frames.split_train_eval()

    tracks = [b.build(device) for b in builders.values()] or None
    return frames, tracks
