"""Spherical range-image ray model (counterpart of `lidar_rt_tpu.core.rays`).

    col j:  x = (W - j - pixel_offset) / W
            azimuth = 2*pi*x - pi - angle_offset
    row i:  inclination = row_inclinations[i]   (monotone decreasing in i)

The same mapping feeds the tile binner's footprint bounds.
"""

from __future__ import annotations

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
                    device=None) -> "SensorGrid":
        """Linear inclination raster:
        row i -> ((H - i - off)/H) * (hi - lo) + lo."""
        lo, hi = inclination_bounds
        i = np.arange(height, dtype=np.float32)
        grid_y = (height - i - pixel_offset) / float(height)
        rows = (grid_y * (hi - lo) + lo).astype(np.float32)
        return SensorGrid(torch.as_tensor(rows, device=device),
                          float(pixel_offset), float(angle_offset))

    @staticmethod
    def from_beams(beam_inclinations, pixel_offset: float = 0.5,
                   angle_offset: float = 0.0, device=None) -> "SensorGrid":
        """Beam-table raster; beams given bottom-up (Waymo calibration order),
        stored top-down."""
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


def sensor_dirs(grid: SensorGrid, width: int) -> Tensor:
    """Unit ray directions in the sensor frame, (H, W, 3)."""
    dev = grid.row_inclinations.device
    cols = torch.arange(width, dtype=torch.float32, device=dev)
    azimuth = azimuth_of_col(grid, cols, width)[None, :]
    inclination = grid.row_inclinations[:, None]
    cos_i = torch.cos(inclination)
    shape = (grid.height, width)
    d = torch.stack(
        [
            cos_i.expand(shape) * torch.cos(azimuth),
            cos_i.expand(shape) * torch.sin(azimuth),
            torch.sin(inclination).expand(shape) * torch.ones_like(azimuth),
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
