"""Native (C++) Waymo ingest, bound with ctypes (a copy of
`lidar_rt_tpu.native`; the port imports nothing of that package).

`ingest.cpp` is built at first use with
`g++ -O2 -shared -fPIC ... -lz` into `lidar_rt_tpu_torch/_build/`
(git-ignored), keyed by a hash of the source.  Without a compiler or zlib
`available()` is False and callers parse with `data/proto_wire.py`;
`build_error()` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "ingest.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"

_lib = None
_build_error: str | None = None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"ingest_{digest}.so"


def _build(so: Path) -> None:
    global _build_error
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC),
           "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        os.replace(tmp, so)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as e:
        detail = getattr(e, "stderr", b"")
        _build_error = f"{e}: {detail[:500] if detail else ''}"


def _load():
    global _lib, _build_error
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        _build(so)
    if not so.exists():
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        _build_error = str(e)
        return None
    lib.tfrecord_index.restype = ctypes.c_int64
    lib.tfrecord_index.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64]
    lib.waymo_decode_frame.restype = ctypes.c_int32
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def tfrecord_index(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Record (offsets, lengths) of a TFRecord buffer."""
    lib = _load()
    max_rec = max(16, len(data) // 1024)
    offs = np.zeros(max_rec, np.int64)
    lens = np.zeros(max_rec, np.int64)
    n = lib.tfrecord_index(
        data, len(data),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_rec)
    if n < 0:
        raise ValueError("malformed TFRecord")
    return offs[:n], lens[:n]


class FrameData:
    """Decoded TOP-lidar frame contents."""

    __slots__ = ("pose", "extrinsic", "beams", "beam_minmax", "r1", "r2",
                 "boxes", "box_ids")


def waymo_decode_frame(record: bytes, max_hw: int = 64 * 2700 * 4,
                       max_beams: int = 256, max_boxes: int = 512
                       ) -> FrameData:
    lib = _load()
    pose = np.zeros(16, np.float64)
    extr = np.zeros(16, np.float64)
    beams = np.zeros(max_beams, np.float64)
    beam_count = ctypes.c_int64(0)
    beam_minmax = np.zeros(2, np.float64)
    r1 = np.zeros(max_hw, np.float32)
    r2 = np.zeros(max_hw, np.float32)
    r1_dims = np.zeros(3, np.int64)
    r2_dims = np.zeros(3, np.int64)
    boxes = np.zeros((max_boxes, 8), np.float64)
    box_count = ctypes.c_int64(0)
    ids_buf = ctypes.create_string_buffer(max_boxes * 64)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    ret = lib.waymo_decode_frame(
        record, len(record),
        ptr(pose, ctypes.c_double), ptr(extr, ctypes.c_double),
        ptr(beams, ctypes.c_double), max_beams, ctypes.byref(beam_count),
        ptr(beam_minmax, ctypes.c_double),
        ptr(r1, ctypes.c_float), ptr(r2, ctypes.c_float), max_hw,
        ptr(r1_dims, ctypes.c_int64), ptr(r2_dims, ctypes.c_int64),
        ptr(boxes, ctypes.c_double), max_boxes, ctypes.byref(box_count),
        ids_buf, len(ids_buf))
    if ret != 0:
        raise ValueError(f"waymo_decode_frame failed: {ret}")

    out = FrameData()
    out.pose = pose.reshape(4, 4)
    out.extrinsic = extr.reshape(4, 4)
    out.beams = beams[:beam_count.value].copy()
    out.beam_minmax = (float(beam_minmax[0]), float(beam_minmax[1]))

    def img(buf, dims):
        if dims[0] <= 0:
            return None
        shape = tuple(int(d) for d in dims if d > 0)
        n = int(np.prod(shape))
        return buf[:n].reshape(shape).copy()

    out.r1 = img(r1, r1_dims)
    out.r2 = img(r2, r2_dims)
    nb = box_count.value
    out.boxes = boxes[:nb].copy()
    ids = ids_buf.value.decode(errors="replace")
    out.box_ids = ids.split("\n")[:nb] if ids else []
    return out
