"""Point-cloud / image export helpers (no external deps): a copy of
`lidar_rt_tpu.utils.export` (the port imports nothing of that package).

Replaces the reference's Open3D-based PLY/PNG writing (eval.py:478-486,
viewer.py) with a binary-little-endian PLY writer and a minimal PNG encoder
(zlib).  Every writer takes numpy arrays; `write_splat_ply` takes the
port's `GaussianAsset` and copies its tensors to the host.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_ply(path: str, points: np.ndarray,
              colors: np.ndarray | None = None) -> None:
    """points (N, 3) float; colors (N, 3) in [0, 1] optional."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    has_color = colors is not None
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if has_color:
            rgb = np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8)
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                     ("rgb", np.uint8, 3)])
            rec["xyz"] = points
            rec["rgb"] = rgb
            f.write(rec.tobytes())
        else:
            f.write(points.tobytes())


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Read back PLYs written by write_ply (and simple ascii/binary files)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode().strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(h.split()[-1]) for h in header
                 if h.startswith("element vertex"))
        has_color = any("red" in h for h in header)
        if has_color:
            rec = np.frombuffer(
                f.read(n * 15), dtype=[("xyz", np.float32, 3),
                                       ("rgb", np.uint8, 3)])
            return rec["xyz"].copy(), rec["rgb"].astype(np.float32) / 255.0
        pts = np.frombuffer(f.read(n * 12), np.float32).reshape(n, 3)
        return pts.copy(), None


def write_png(path: str, img: np.ndarray) -> None:
    """img: (H, W) grayscale in [0,1] or (H, W, 3) RGB in [0,1]."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    data = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    h, w = data.shape[:2]
    raw = b"".join(b"\x00" + data[i].tobytes() for i in range(h))

    def chunk(typ: bytes, payload: bytes) -> bytes:
        c = struct.pack(">I", len(payload)) + typ + payload
        return c + struct.pack(">I", zlib.crc32(typ + payload))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


_TURBO_ANCHORS = np.array([
    [0.19, 0.07, 0.23], [0.28, 0.35, 0.95], [0.11, 0.74, 0.72],
    [0.63, 0.95, 0.23], [0.99, 0.70, 0.10], [0.90, 0.20, 0.05],
    [0.48, 0.02, 0.01]], np.float32)


def colormap(values: np.ndarray) -> np.ndarray:
    """Map [0,1] scalars to a turbo-like RGB ramp (the reference uses cv2
    colormaps for depth/intensity snapshots, train.py:281-300)."""
    v = np.clip(np.asarray(values, np.float32), 0.0, 1.0)
    x = v * (len(_TURBO_ANCHORS) - 1)
    i = np.clip(x.astype(np.int32), 0, len(_TURBO_ANCHORS) - 2)
    frac = (x - i)[..., None]
    return _TURBO_ANCHORS[i] * (1 - frac) + _TURBO_ANCHORS[i + 1] * frac


def write_splat_ply(path: str, asset) -> None:
    """Export a GaussianAsset's alive splats in the 3DGS PLY convention
    (x,y,z, nx,ny,nz, f_dc_*, f_rest_*, opacity, scale_*, rot_*) so scenes
    interoperate with external splat tooling (the reference stores .pth
    pickles; PLY is the de-facto interchange format).  `asset` is the
    port's GaussianAsset (one cloud: the background, or one actor)."""
    import numpy as _np

    def host(t):
        return t.detach().cpu().numpy()

    alive = host(asset.alive)
    xyz = host(asset.xyz)[alive]
    f_dc = host(asset.f_dc)[alive].reshape(len(xyz), -1)
    f_rest = host(asset.f_rest)[alive].reshape(len(xyz), -1)
    opac = host(asset.opacity_logit)[alive].reshape(len(xyz), 1)
    log_scale = host(asset.log_scale)[alive]
    quat = host(asset.quat)[alive]
    n = len(xyz)

    fields = ["x", "y", "z", "nx", "ny", "nz"]
    fields += [f"f_dc_{i}" for i in range(f_dc.shape[1])]
    fields += [f"f_rest_{i}" for i in range(f_rest.shape[1])]
    fields += ["opacity"]
    fields += [f"scale_{i}" for i in range(log_scale.shape[1])]
    fields += [f"rot_{i}" for i in range(4)]
    data = _np.concatenate(
        [xyz, _np.zeros_like(xyz), f_dc, f_rest, opac, log_scale, quat],
        axis=1).astype(np.float32)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {f}" for f in fields]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(data.tobytes())


def read_splat_ply(path: str) -> dict:
    """Read back write_splat_ply output -> dict of arrays."""
    import numpy as _np

    with open(path, "rb") as f:
        fields = []
        n = 0
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                fields.append(line.split()[-1])
            elif line == "end_header":
                break
        data = _np.frombuffer(f.read(n * len(fields) * 4),
                              _np.float32).reshape(n, len(fields))
    out = {name: data[:, i].copy() for i, name in enumerate(fields)}
    out["__fields__"] = fields
    return out


def write_apng(path: str, frames_seq, fps: int = 5) -> None:
    """Animated PNG of (H, W[,3]) float frames in [0,1] — the eval video
    artifact (the reference writes 5 fps mp4s, eval.py:522-524; eval hosts
    have no ffmpeg, and APNG plays in any browser)."""
    frames_list = [np.asarray(f) for f in frames_seq]
    if not frames_list:
        raise ValueError("no frames")

    def to_rgb(img):
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return np.clip(img * 255.0, 0, 255).astype(np.uint8)

    rgb = [to_rgb(f) for f in frames_list]
    h, w = rgb[0].shape[:2]

    def chunk(typ: bytes, payload: bytes) -> bytes:
        c = struct.pack(">I", len(payload)) + typ + payload
        return c + struct.pack(">I", zlib.crc32(typ + payload))

    def scanlines(img):
        return zlib.compress(b"".join(b"\x00" + img[i].tobytes()
                                      for i in range(h)))

    seq = 0
    out = [b"\x89PNG\r\n\x1a\n",
           chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
           chunk(b"acTL", struct.pack(">II", len(rgb), 0))]
    for i, img in enumerate(rgb):
        out.append(chunk(b"fcTL", struct.pack(
            ">IIIIIHHBB", seq, w, h, 0, 0, 1, fps, 0, 0)))
        seq += 1
        data = scanlines(img)
        if i == 0:
            out.append(chunk(b"IDAT", data))
        else:
            out.append(chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))
