"""Spherical range-image ray model (counterpart of `lidar_rt_tpu.core.rays`).

    col j:  x = (W - j - pixel_offset) / W
            azimuth = 2*pi*x - pi - angle_offset
    row i:  inclination = row_inclinations[i]   (monotone decreasing in i)

The same mapping feeds the tile binner's footprint bounds.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class SensorGrid:
    """Static description of a LiDAR scan raster.

    row_inclinations: (H,) inclination per row, strictly decreasing (row 0 is
    the top beam), on the device the render runs on.
    """

    row_inclinations: Tensor
    pixel_offset: float
    angle_offset: float

    @property
    def height(self) -> int:
        return self.row_inclinations.shape[0]

    @staticmethod
    def from_bounds(height: int, inclination_bounds: tuple[float, float],
                    pixel_offset: float = 0.0, angle_offset: float = 0.0,
                    device: str | torch.device = "cuda") -> "SensorGrid":
        """Linear inclination raster on `device` (the card unless the
        caller names another): row i -> ((H - i - off)/H) * (hi - lo) +
        lo."""
        lo, hi = inclination_bounds
        i = np.arange(height, dtype=np.float32)
        grid_y = (height - i - pixel_offset) / float(height)
        rows = (grid_y * (hi - lo) + lo).astype(np.float32)
        return SensorGrid(torch.as_tensor(rows, device=device),
                          float(pixel_offset), float(angle_offset))

    @staticmethod
    def from_beams(beam_inclinations, pixel_offset: float = 0.5,
                   angle_offset: float = 0.0,
                   device: str | torch.device = "cuda") -> "SensorGrid":
        """Beam-table raster on `device` (the card unless the caller names
        another); beams given bottom-up (Waymo calibration order), stored
        top-down."""
        rows = torch.as_tensor(np.asarray(beam_inclinations, np.float32),
                               device=device).flip(0)
        return SensorGrid(rows, float(pixel_offset), float(angle_offset))


def azimuth_of_col(grid: SensorGrid, col: Tensor, width: int) -> Tensor:
    """Column index (float ok) -> azimuth in radians."""
    x = (width - col - grid.pixel_offset) / float(width)
    return x * (2.0 * math.pi) - math.pi - grid.angle_offset


def col_of_azimuth(grid: SensorGrid, azimuth: Tensor, width: int) -> Tensor:
    """Azimuth -> fractional column index, wrapped into [0, W) (floor-mod)."""
    x = (azimuth + math.pi + grid.angle_offset) / (2.0 * math.pi)
    col = width - grid.pixel_offset - x * width
    return torch.remainder(col, float(width))


def row_of_inclination(grid: SensorGrid, inclination: Tensor) -> Tensor:
    """Inclination -> fractional row index.

    Piecewise-linear over the (monotone decreasing) row table, extrapolating
    linearly past both edges: binning needs a finite, order-preserving
    answer for footprints that poke past the first/last beam.  The bracket
    is the count of table entries below x, clipped to [1, H-1] (not
    `searchsorted`, whose edge behaviour differs from the reference's).
    """
    rows_rev = grid.row_inclinations.flip(0)  # increasing
    h = rows_rev.shape[0]
    hi = (rows_rev < inclination[..., None]).sum(-1).clamp(1, h - 1)
    lo = hi - 1
    x0 = rows_rev[lo]
    x1 = rows_rev[hi]
    frac = (inclination - x0) / (x1 - x0).clamp_min(1e-12)
    return (h - 1) - (lo.to(inclination.dtype) + frac)


@functools.cache
def _libm_f32_trig():
    """The C math library's float32 (cosf, sinf), or None."""
    name = ctypes.util.find_library("m")
    if name is None:
        return None
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    fns = []
    for fn_name in ("cosf", "sinf"):
        fn = getattr(lib, fn_name)
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float]
        fns.append(fn)
    return fns


def cos_sin(x: Tensor) -> tuple[Tensor, Tensor]:
    """(cos x, sin x) of a small float32 tensor.  On the CPU they come from
    the C library's cosf/sinf, which XLA's CPU backend calls too, so the
    sensor raster's directions (and the points, voxels and Morton codes
    made from them) match the reference's to the bit; torch's own CPU
    trig differs from them in the last bit of ~5% of values.  On a card,
    torch's."""
    fns = _libm_f32_trig() if x.device.type == "cpu" else None
    if fns is None or x.dtype != torch.float32:
        return torch.cos(x), torch.sin(x)
    vals = x.reshape(-1).tolist()
    return tuple(torch.tensor([fn(v) for v in vals],
                              dtype=torch.float32).view(x.shape)
                 for fn in fns)


def sensor_dirs(grid: SensorGrid, width: int) -> Tensor:
    """Unit ray directions in the sensor frame, (H, W, 3)."""
    dev = grid.row_inclinations.device
    cols = torch.arange(width, dtype=torch.float32, device=dev)
    cos_a, sin_a = cos_sin(azimuth_of_col(grid, cols, width)[None, :])
    cos_i, sin_i = cos_sin(grid.row_inclinations[:, None])
    shape = (grid.height, width)
    d = torch.stack(
        [
            cos_i.expand(shape) * cos_a,
            cos_i.expand(shape) * sin_a,
            sin_i.expand(shape) * torch.ones_like(cos_a),
        ],
        dim=-1,
    )
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def range_rays(grid: SensorGrid, width: int, sensor2world: Tensor
               ) -> tuple[Tensor, Tensor]:
    """World-frame rays for a frame: origin (3,), directions (H, W, 3).

    All rays share the sensor center as origin.  The rotation is applied as
    an elementwise sum, full f32 whatever the matmul precision setting."""
    d = sensor_dirs(grid, width)
    rot = sensor2world[:3, :3]
    world_d = (rot * d[..., None, :]).sum(-1)
    world_d = world_d / torch.linalg.vector_norm(world_d, dim=-1,
                                                 keepdim=True)
    return sensor2world[:3, 3], world_d


def rotate_points(rot: Tensor, p: Tensor) -> Tensor:
    """rot (3, 3) @ p (..., 3) in f32, each output a chain of fused
    multiply-adds: every product exact in f64, rounded to f32 after each
    add, as a CPU dot of length 3 rounds (the reference's einsum).  The
    result does not depend on the matmul precision setting."""
    r = rot.double()
    p64 = p.double()
    acc = (p64[..., 0:1] * r[:, 0]).float()
    for j in (1, 2):
        acc = (acc.double() + p64[..., j:j + 1] * r[:, j]).float()
    return acc


def range_to_points(grid: SensorGrid, range_map: Tensor,
                    sensor2world: Tensor) -> Tensor:
    """Back-project a range image (H, W) to world points (H, W, 3)."""
    d = sensor_dirs(grid, range_map.shape[1])
    return (rotate_points(sensor2world[:3, :3], d * range_map[..., None])
            + sensor2world[:3, 3])


def project_points(grid: SensorGrid, points_world: Tensor,
                   world2sensor: Tensor, width: int
                   ) -> tuple[Tensor, Tensor, Tensor]:
    """World points (..., 3) -> fractional (row, col) in the raster and
    range; callers quantize and clip."""
    p = rotate_points(world2sensor[:3, :3], points_world) \
        + world2sensor[:3, 3]
    rng = (p * p).sum(-1).sqrt()
    azimuth = torch.atan2(p[..., 1], p[..., 0])
    horiz = (p[..., :2] * p[..., :2]).sum(-1).sqrt().clamp_min(1e-12)
    inclination = torch.atan2(p[..., 2], horiz)
    return (row_of_inclination(grid, inclination),
            col_of_azimuth(grid, azimuth, width), rng)
