"""Real spherical harmonics, degree <= 3, in basis-vector form
(counterpart of `lidar_rt_tpu.core.sh`).

b(dir) has static length 16; coefficients of degree > active_degree are
masked to zero so shapes stay fixed while the SH warm-up grows the degree.
The CUDA tracer kernels evaluate the same basis in registers
(`csrc/tracer_common.cuh`, `sh_basis`), with the same constants.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

MAX_SH_DEGREE = 3
NUM_SH_COEFFS = (MAX_SH_DEGREE + 1) ** 2  # 16

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)

# SH degree of each of the 16 coefficients, used for masking.
_DEGREE_OF_COEFF = np.array([0] + [1] * 3 + [2] * 5 + [3] * 7, dtype=np.int32)


def degree_mask(active_degree: int, device=None) -> Tensor:
    """(16,) float mask: 1 for coefficients of degree <= active_degree."""
    return torch.as_tensor(_DEGREE_OF_COEFF <= int(active_degree),
                           dtype=torch.float32, device=device)


def basis(dirs: Tensor, active_degree: int) -> Tensor:
    """SH basis b(dir): (..., 3) dirs (normalized internally) -> (..., 16)."""
    d = dirs / torch.linalg.vector_norm(dirs, dim=-1,
                                        keepdim=True).clamp_min(1e-12)
    x, y, z = d.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    b = torch.stack(
        [
            torch.full_like(x, C0),
            -C1 * y, C1 * z, -C1 * x,
            C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz, C2[4] * (xx - yy),
            C3[0] * y * (3.0 * xx - yy), C3[1] * xy * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy), C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ],
        dim=-1,
    )
    return b * degree_mask(active_degree, b.device)


def evaluate(sh: Tensor, dirs: Tensor, active_degree: int) -> Tensor:
    """SH colors: sh (..., 16, C), dirs (..., 3) -> (..., C), including the
    +0.5 shift (the compositor clamps only the intensity channel)."""
    b = basis(dirs, active_degree)
    return (b[..., :, None] * sh).sum(-2) + 0.5


def rgb_to_sh(rgb: Tensor) -> Tensor:
    """Channel value -> DC SH coefficient."""
    return (rgb - 0.5) / C0
