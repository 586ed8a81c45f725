"""Masked bidirectional Chamfer distance (counterpart of
`lidar_rt_tpu.ops.chamfer`).

Brute-force nearest neighbours over chunks of 512 points of the second
cloud, so peak memory is N x 512, with the cross term of
||a - b||^2 = |a|^2 + |b|^2 - 2 a.b as a matmul.  The search
(`nearest_sq_dists`, which the eval metrics also call) runs without
autograd and gives the values; the gradient of the min comes from the
distances of the pairs at the minimum, recomputed from the gathered points,
so the N x M distance field is not kept for the backward pass.  Invalid
points neither produce nor attract matches.
"""

from __future__ import annotations

import torch

from lidar_rt_tpu_torch.utils import profiling

Tensor = torch.Tensor

_BIG = 1e12


def _sq_dists(a: Tensor, a_sq: Tensor, b: Tensor, b_mask: Tensor, s: int,
              chunk: int) -> Tensor:
    """Squared distances (N, chunk) from a to b[s:s + chunk]; _BIG to
    invalid points of b."""
    bc = b[s:s + chunk]
    d2 = a_sq[:, None] + (bc * bc).sum(-1)[None, :] - 2.0 * (a @ bc.T)
    return torch.where(b_mask[None, s:s + chunk], d2.clamp_min(0.0), _BIG)


def nearest_sq_dists(a: Tensor, b: Tensor, b_mask: Tensor | None = None,
                     chunk: int = 512) -> Tensor:
    """The value-only search: for each point of `a` (N, 3), the squared
    distance to the nearest (valid) point of `b` (M, 3), _BIG where there
    is none, without autograd and on the points' device, with no host
    sync."""
    if b_mask is None:
        b_mask = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
    with torch.no_grad():
        a, b = a.detach(), b.detach()
        a_sq = (a * a).sum(-1)
        best = torch.full((a.shape[0],), _BIG, dtype=a.dtype,
                          device=a.device)
        for s in range(0, b.shape[0], chunk):
            best = torch.minimum(
                best, _sq_dists(a, a_sq, b, b_mask, s, chunk).amin(-1))
    return best


def min_sq_dists(a: Tensor, a_mask: Tensor, b: Tensor, b_mask: Tensor,
                 chunk: int = 512) -> Tensor:
    """For each point of `a`, squared distance to the nearest valid point of
    `b`.  a: (N, 3), b: (M, 3); masks bool.  Invalid `a` rows return 0.

    Where several points of b tie for the minimum (coincident points, such
    as dropped rays back-projected to the sensor origin), the gradient is
    split evenly among them, as the reference's `jnp.min` splits it.
    Rows that are invalid or find no valid point of b take no pairs."""
    best = nearest_sq_dists(a, b, b_mask, chunk)
    with torch.no_grad():
        a0, b0 = a.detach(), b.detach()
        a_sq = (a0 * a0).sum(-1)
        keep = a_mask & (best < _BIG)
        target = torch.where(keep, best, float("nan"))   # NaN equals nothing
        rows, cols = [], []
        for s in range(0, b.shape[0], chunk):
            r, c = torch.nonzero(
                _sq_dists(a0, a_sq, b0, b_mask, s, chunk) == target[:, None],
                as_tuple=True)
            rows.append(r)
            cols.append(c + s)
        rows, cols = torch.cat(rows), torch.cat(cols)
        share = 1.0 / torch.bincount(rows, minlength=a.shape[0])[rows]
    ar, bc = a[rows], b[cols]
    pair = ((ar * ar).sum(-1) + (bc * bc).sum(-1)
            - 2.0 * (ar * bc).sum(-1)).clamp_min(0.0)
    d2 = torch.zeros_like(best).index_add(0, rows, share * pair)
    # The search's value, the gradient of the recomputed pairs.
    d2 = best + (d2 - d2.detach())
    return torch.where(keep, d2, 0.0)


def chamfer_distance(a: Tensor, a_mask: Tensor, b: Tensor, b_mask: Tensor,
                     chunk: int = 512) -> Tensor:
    """Symmetric Chamfer loss: the mean of both directions' squared
    nearest-neighbour distances, each direction weighted 1/2."""
    with profiling.span("chamfer"):
        d_ab = min_sq_dists(a, a_mask, b, b_mask, chunk=chunk)
        d_ba = min_sq_dists(b, b_mask, a, a_mask, chunk=chunk)
        na = a_mask.sum().clamp_min(1)
        nb = b_mask.sum().clamp_min(1)
        return 0.5 * (d_ab.sum() / na + d_ba.sum() / nb)


def fscore(d_ab: Tensor, a_mask: Tensor, d_ba: Tensor, b_mask: Tensor,
           threshold: float = 0.05) -> Tensor:
    """F-score at a distance threshold over squared NN distances."""
    t2 = threshold * threshold
    precision = ((d_ab < t2) & a_mask).sum() / a_mask.sum().clamp_min(1)
    recall = ((d_ba < t2) & b_mask).sum() / b_mask.sum().clamp_min(1)
    return 2.0 * precision * recall / (precision + recall).clamp_min(1e-12)
