"""Dataset writers: emit scans in the real datasets' wire formats
(counterpart of `lidar_rt_tpu.data.writers`: given the same arrays, the
same bytes).

The inverse of the loaders (data/waymo.py, data/kitti.py): encode range
images / point clouds / poses / boxes as a Waymo Open Dataset TFRecord
segment or a KITTI-360 directory tree.  Two uses:

  * format-true end-to-end rehearsal — generate a synthetic segment at the
    real workload shapes (Waymo 64x2650 dual-return per
    lib/dataloader/waymo_loader/__init__.py:92-102; KITTI-360 66x1030 per
    kitti_loader/__init__.py:186-189) and drive the actual train.py /
    eval.py CLI against it;
  * re-simulation export — write a trained model's re-rendered scans back
    out in the original sensor format for downstream consumers.

The protobuf encoding mirrors the field numbers in data/waymo.py (the
minimal subset of the vendored Waymo `Frame` proto the loader reads).
"""

from __future__ import annotations

import os
import struct
import xml.etree.ElementTree as ET
import zlib

import numpy as np

import torch

from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.data import kitti, waymo


# ---------------------------------------------------------------- protobuf
def _varint(x: int) -> bytes:
    out = b""
    while True:
        b = x & 0x7F
        x >>= 7
        out += bytes([b | (0x80 if x else 0)])
        if not x:
            return out


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def enc_len(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def enc_varint(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def enc_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", float(v))


def enc_packed_doubles(field: int, vals) -> bytes:
    return enc_len(field, b"".join(struct.pack("<d", float(v))
                                   for v in vals))


def enc_packed_floats(field: int, vals) -> bytes:
    return enc_len(field, np.asarray(vals, "<f4").tobytes())


def enc_packed_int32(field: int, vals) -> bytes:
    return enc_len(field, b"".join(_varint(int(v)) for v in vals))


def write_tfrecord(path: str, records: list[bytes]) -> None:
    """TFRecord framing: <u64 len><4B crc><payload><4B crc>.  The loaders
    (proto_wire.tfrecord_iter, native/ingest.cpp) skip the crc fields."""
    with open(path, "wb") as f:
        for r in records:
            f.write(struct.pack("<Q", len(r)) + b"\0" * 4 + r + b"\0" * 4)


# ------------------------------------------------------------------- Waymo
def _matrix_float(arr: np.ndarray) -> bytes:
    """MatrixFloat message: packed float data + shape."""
    shape = enc_packed_int32(waymo.F_SHAPE_DIMS, list(arr.shape))
    return (enc_packed_floats(waymo.F_MATRIX_DATA, arr.reshape(-1))
            + enc_len(waymo.F_MATRIX_SHAPE, shape))


def _range_image(arr: np.ndarray) -> bytes:
    """RangeImage message: zlib-compressed MatrixFloat
    (waymo_loader decompress_range_image, __init__.py:16-33)."""
    return enc_len(waymo.F_RI_COMPRESSED, zlib.compress(_matrix_float(arr)))


def _ri4(rng: np.ndarray, inten: np.ndarray) -> np.ndarray:
    """(H, W) range/intensity -> the 4-channel range image tensor with -1
    marking no-return pixels (channels 2-3 unused by the loader)."""
    out = np.full(rng.shape + (4,), -1.0, np.float32)
    hit = rng > 0
    out[..., 0] = np.where(hit, rng, -1.0)
    out[..., 1] = np.where(hit, inten, -1.0)
    return out


def encode_waymo_frame(*, ego2world: np.ndarray, extrinsic: np.ndarray,
                       beam_inclinations: np.ndarray,
                       range1: np.ndarray, intensity1: np.ndarray,
                       range2: np.ndarray, intensity2: np.ndarray,
                       labels: list[tuple[str, np.ndarray, np.ndarray,
                                          float]]) -> bytes:
    """One Frame message (the subset data/waymo.py reads).

    labels: (object_id, center_ego (3,), size_lwh (3,), heading) per
    vehicle — box centers in the EGO frame, as in the real dataset
    (waymo_loader:108-127).
    """
    calib = (enc_varint(waymo.F_CALIB_NAME, waymo.TOP_LIDAR)
             + enc_packed_doubles(waymo.F_CALIB_BEAM_INCLINATIONS,
                                  np.asarray(beam_inclinations, np.float64))
             + enc_len(waymo.F_CALIB_EXTRINSIC,
                       enc_packed_doubles(
                           waymo.F_TRANSFORM,
                           np.asarray(extrinsic, np.float64).reshape(-1))))
    context = enc_len(waymo.F_CONTEXT_LASER_CALIBRATIONS, calib)

    laser = (enc_varint(waymo.F_LASER_NAME, waymo.TOP_LIDAR)
             + enc_len(waymo.F_LASER_RI_RETURN1,
                       _range_image(_ri4(range1, intensity1)))
             + enc_len(waymo.F_LASER_RI_RETURN2,
                       _range_image(_ri4(range2, intensity2))))

    out = (enc_len(waymo.F_FRAME_CONTEXT, context)
           + enc_len(waymo.F_FRAME_POSE,
                     enc_packed_doubles(
                         waymo.F_TRANSFORM,
                         np.asarray(ego2world, np.float64).reshape(-1)))
           + enc_len(waymo.F_FRAME_LASERS, laser))

    for oid, center, size_lwh, heading in labels:
        box = (enc_double(waymo.F_BOX_CX, center[0])
               + enc_double(waymo.F_BOX_CY, center[1])
               + enc_double(waymo.F_BOX_CZ, center[2])
               + enc_double(waymo.F_BOX_LENGTH, size_lwh[0])
               + enc_double(waymo.F_BOX_WIDTH, size_lwh[1])
               + enc_double(waymo.F_BOX_HEIGHT, size_lwh[2])
               + enc_double(waymo.F_BOX_HEADING, heading))
        label = (enc_len(waymo.F_LABEL_BOX, box)
                 + enc_varint(waymo.F_LABEL_TYPE, waymo.TYPE_VEHICLE)
                 + enc_len(waymo.F_LABEL_ID, oid.encode()))
        out += enc_len(waymo.F_FRAME_LASER_LABELS, label)
    return out


def write_waymo_segment(base_dir: str, *, ego2world: np.ndarray,
                        extrinsic: np.ndarray,
                        beam_inclinations: np.ndarray,
                        range1: np.ndarray, intensity1: np.ndarray,
                        range2: np.ndarray, intensity2: np.ndarray,
                        labels_per_frame: list[list] | None = None,
                        name: str = "segment-synthetic.tfrecord") -> str:
    """Write a full segment: arrays are (F, ...) stacked per frame.
    Returns the tfrecord path.  `base_dir` is what the loader's
    `source_dir` should point at (data/waymo.py load())."""
    os.makedirs(base_dir, exist_ok=True)
    f_total = range1.shape[0]
    labels_per_frame = labels_per_frame or [[] for _ in range(f_total)]
    records = [
        encode_waymo_frame(
            ego2world=ego2world[f], extrinsic=extrinsic,
            beam_inclinations=beam_inclinations,
            range1=range1[f], intensity1=intensity1[f],
            range2=range2[f], intensity2=intensity2[f],
            labels=labels_per_frame[f])
        for f in range(f_total)
    ]
    path = os.path.join(base_dir, name)
    write_tfrecord(path, records)
    return path


# --------------------------------------------------------------- KITTI-360
def write_kitti360_sequence(base_dir: str, *, seq: str,
                            sensor2world: np.ndarray,
                            range1: np.ndarray, intensity1: np.ndarray,
                            frame0: int = 0,
                            boxes: list[tuple[str, dict[int, np.ndarray]]]
                            | None = None) -> str:
    """Write a KITTI-360 tree the loader (data/kitti.py) reads back:

        data_3d_raw/<seq>/velodyne_points/data/??????????.bin
        data_pose/<seq>/poses.txt          (ego2world 3x4 rows)
        data_3d_bboxes/train/<seq>.xml     (car tracks)

    range1/intensity1: (F, 66, 1030) rasters at the KITTI grid — back-
    projected to velodyne-frame points for the .bin files (the loader
    re-rasterizes them, kitti.py rasterize_points).  sensor2world (F,4,4)
    is the velodyne->world pose; poses.txt rows store ego2world =
    sensor2world @ inv(velo2ego) (kitti_loader/__init__.py:61-73).
    The ray directions are computed on the CPU, so the points are the
    reference writer's to the bit.

    boxes: (instance_id, {dataset_frame: obj2world 4x4 with R @ diag(size)
    in the linear part}) per actor (the XML transform convention the
    loader SVDs apart, kitti.py load_bboxes).
    """
    full_seq = f"2013_05_28_drive_{seq}_sync"
    lidar_dir = os.path.join(base_dir, "data_3d_raw", full_seq,
                             "velodyne_points", "data")
    pose_dir = os.path.join(base_dir, "data_pose", full_seq)
    bbox_dir = os.path.join(base_dir, "data_3d_bboxes", "train")
    for d in (lidar_dir, pose_dir, bbox_dir):
        os.makedirs(d, exist_ok=True)

    grid = rays_lib.SensorGrid.from_bounds(
        kitti.H, (kitti.INC_BOTTOM, kitti.INC_TOP), pixel_offset=0.0,
        angle_offset=0.0, device="cpu")
    with torch.no_grad():
        dirs = rays_lib.sensor_dirs(grid, kitti.W).numpy()   # (H, W, 3)

    f_total = range1.shape[0]
    for f in range(f_total):
        hit = range1[f] > 0
        pts = dirs * range1[f][..., None]
        rec = np.concatenate(
            [pts[hit], intensity1[f][hit][:, None]],
            axis=-1).astype(np.float32)
        rec.tofile(os.path.join(lidar_dir, f"{frame0 + f:010d}.bin"))

    v2e = kitti.velo2ego()
    e_from_s = np.linalg.inv(v2e)
    with open(os.path.join(pose_dir, "poses.txt"), "w") as fp:
        for f in range(f_total):
            ego2world = np.asarray(sensor2world[f], np.float64) @ e_from_s
            row = " ".join(f"{v:.9f}" for v in ego2world[:3].reshape(-1))
            fp.write(f"{frame0 + f} {row}\n")

    root = ET.Element("opencv_storage")
    for oid, per_frame in (boxes or []):
        for ts, transform in sorted(per_frame.items()):
            obj = ET.SubElement(root, "object")
            ET.SubElement(obj, "label").text = "car"
            ET.SubElement(obj, "timestamp").text = str(ts)
            ET.SubElement(obj, "instanceId").text = oid
            tr = ET.SubElement(obj, "transform")
            ET.SubElement(tr, "rows").text = "4"
            ET.SubElement(tr, "cols").text = "4"
            ET.SubElement(tr, "data").text = " ".join(
                f"{v:.9f}" for v in np.asarray(transform,
                                               np.float64).reshape(-1))
    ET.ElementTree(root).write(os.path.join(bbox_dir, full_seq + ".xml"))
    return os.path.join(base_dir)
