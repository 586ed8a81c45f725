"""Minimal protobuf wire-format reader (decode-only, schema-free).

The Waymo Open Dataset ships TFRecords of `Frame` protos; the reference
parses them with TensorFlow + generated protobuf stubs
(lib/dataloader/waymo_loader/__init__.py:1-33).  Loading data should not
need TensorFlow, so this module implements the five wire types of proto3
directly; the Waymo field numbers live in data/waymo.py.  A copy of
`lidar_rt_tpu.data.proto_wire`: the port imports nothing of that package.

API: `fields(buf)` -> {field_number: [raw values]} where raw values are
ints (varint), bytes (length-delimited) or 4/8-byte chunks (fixed), plus
typed helpers for doubles/floats/packed arrays.
"""

from __future__ import annotations

import struct

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def fields(buf: bytes) -> dict[int, list]:
    """Parse one message's fields.  Length-delimited values come back as
    bytes (caller decides: submessage, string, packed array)."""
    out: dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 0x7
        if wt == _WT_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wt == _WT_I64:
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == _WT_LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == _WT_I32:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} at {pos}")
        out.setdefault(field, []).append(val)
    return out


def first(f: dict[int, list], num: int, default=None):
    v = f.get(num)
    return v[0] if v else default


def as_double(v) -> float:
    return struct.unpack("<d", v)[0]


def as_float(v) -> float:
    return struct.unpack("<f", v)[0]


def packed_doubles(f: dict[int, list], num: int) -> list[float]:
    """Repeated double: either packed blobs or repeated I64 entries."""
    out: list[float] = []
    for v in f.get(num, []):
        if isinstance(v, (bytes, bytearray)) and len(v) != 8:
            out.extend(struct.unpack(f"<{len(v) // 8}d", v))
        else:
            out.append(as_double(v))
    return out


def packed_floats(f: dict[int, list], num: int) -> list[float]:
    out: list[float] = []
    for v in f.get(num, []):
        if isinstance(v, (bytes, bytearray)) and len(v) != 4:
            out.extend(struct.unpack(f"<{len(v) // 4}f", v))
        else:
            out.append(as_float(v))
    return out


def packed_int32s(f: dict[int, list], num: int) -> list[int]:
    out: list[int] = []
    for v in f.get(num, []):
        if isinstance(v, (bytes, bytearray)):
            pos = 0
            while pos < len(v):
                x, pos = _read_varint(v, pos)
                out.append(x)
        else:
            out.append(v)
    return out


def tfrecord_iter(path: str):
    """Iterate raw records of an (uncompressed) TFRecord file.

    Framing: uint64le length, uint32 length-crc, payload, uint32 data-crc.
    CRCs are not verified (the reference's tf.data path verifies them; for
    ingest we prefer speed and trust the filesystem)."""
    with open(path, "rb") as fp:
        while True:
            header = fp.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            fp.seek(4, 1)
            data = fp.read(length)
            if len(data) < length:
                raise EOFError("truncated TFRecord")
            fp.seek(4, 1)
            yield data
