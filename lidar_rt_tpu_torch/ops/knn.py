"""Morton-window k-nearest neighbours and PCA normals for scene
initialization (counterpart of `lidar_rt_tpu.ops.knn`, plain torch).

Points are quantized to a 1024^3 grid over their own bounding box,
interleaved into 30-bit Morton codes and sorted; each point's candidates
are its +-`window` neighbours in that order (never itself).  The
neighbours are the k nearest candidates.

Two choices keep the neighbour selection identical to the reference's:
the Morton sort is stable (`jnp.argsort` is, and equal codes are common:
under the assembly's bucket padding every real point shares one code, see
`data/build.py`), and the k nearest are taken with a stable sort, so ties
keep the lower window slot as `lax.top_k` does.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

DEFAULT_WINDOW = 32
# Matrices per batched eigh call.  On the card, torch.linalg.eigh of a
# batch of 3x3 matrices calls cuSOLVER's cusolverDnXsyevBatched, which
# refuses 32,768 matrices and more with CUSOLVER_STATUS_INVALID_VALUE
# (torch 2.11, CUDA 12.8, H100) and takes 16,384.
EIGH_BATCH = 16384


def morton_codes(points: Tensor) -> Tensor:
    """Points (N, 3) -> 30-bit Morton codes (N,) int32, normalized by the
    cloud's own bounding box."""
    lo = points.amin(0)
    extent = (points.amax(0) - lo).clamp_min(1e-12)
    q = (((points - lo) / extent) * 1023.0).clamp(0.0, 1023.0).to(
        torch.int64)

    def spread(x):
        # Interleave 10 bits with two zero bits each (magic bits).
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return code.to(torch.int32)


def _window_candidates(points: Tensor, window: int
                       ) -> tuple[Tensor, Tensor, Tensor]:
    """(order (N,) the stable Morton sort, cand_idx (N, 2W) original
    indices of each sorted point's window neighbours, valid (N, 2W) the
    window slots inside the cloud)."""
    n = points.shape[0]
    dev = points.device
    order = torch.argsort(morton_codes(points), stable=True)
    offsets = torch.cat([torch.arange(-window, 0, device=dev),
                         torch.arange(1, window + 1, device=dev)])
    pos = torch.arange(n, device=dev)[:, None] + offsets
    valid = (pos >= 0) & (pos < n)
    return order, order[pos.clamp(0, n - 1)], valid


def knn(points: Tensor, k: int = 3, window: int = DEFAULT_WINDOW
        ) -> tuple[Tensor, Tensor]:
    """Approximate k nearest neighbours of every point (N, 3): (sq_dists
    (N, k), indices (N, k)) in the original point order, nearest first."""
    order, cand_idx, valid = _window_candidates(points, window)
    diff = points[cand_idx] - points[order][:, None, :]      # (N, 2W, 3)
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
        + diff[..., 2] * diff[..., 2]
    d2 = torch.where(valid, d2, torch.inf)
    nn_d2, slot = torch.sort(d2, dim=-1, stable=True)
    nn_d2, slot = nn_d2[:, :k], slot[:, :k]
    nn_idx = torch.gather(cand_idx, 1, slot)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(points.shape[0], device=points.device)
    return nn_d2[inv], nn_idx[inv]


def mean_sq_dist_to_3nn(points: Tensor, window: int = DEFAULT_WINDOW
                        ) -> Tensor:
    """Mean squared distance to the 3 nearest neighbours, (N,): the
    per-surfel scale at initialization."""
    d2, _ = knn(points, k=3, window=window)
    d2 = torch.where(torch.isfinite(d2), d2, 0.0)
    return d2.sum(-1) / 3.0


def neighbour_covariance(points: Tensor, k: int = 16,
                         window: int = DEFAULT_WINDOW) -> Tensor:
    """(N, 3, 3) covariance of each point's k neighbours, summed in f32
    elementwise (full precision whatever the matmul setting)."""
    _, nn_idx = knn(points, k=k, window=window)
    neigh = points[nn_idx]                                    # (N, k, 3)
    centered = neigh - neigh.mean(1, keepdim=True)
    return (centered[..., :, None] * centered[..., None, :]).sum(1) / k


def estimate_normals(points: Tensor, orient_toward: Tensor, k: int = 16,
                     window: int = DEFAULT_WINDOW) -> Tensor:
    """PCA surface normals (N, 3): the smallest-eigenvalue direction of
    each neighbourhood's covariance, signed to face `orient_toward` (3,),
    the sensor center."""
    cov = neighbour_covariance(points, k, window)
    normal = torch.cat([torch.linalg.eigh(c)[1][..., :, 0]
                        for c in cov.split(EIGH_BATCH)])
    to_sensor = orient_toward[None, :] - points
    return torch.where((normal * to_sensor).sum(-1, keepdim=True) < 0,
                       -normal, normal)
