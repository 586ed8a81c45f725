"""The surfel maker: the configuration's scene as 2D Gaussian surfels, made
on the device from the generator's returns and the seed.

It follows the rule of the port's scene assembly (`data/build.py`,
`scene/asset.py` `from_points`) without calling it:

  * background: every return's hits off the vehicles, averaged per voxel
    of `voxel_size` (positions, colors and normals); a subset, or
    duplicates jittered inside their voxel, drawn from `layout_seed`
    holds the count at the configuration's `background` exactly;
  * vehicles: each one's hits in its box frame, a subset of its count in
    `per_actor` (one count a vehicle) drawn from `layout_seed`, or
    padded with points drawn in the box;
  * log-scale = log sqrt(mean squared distance to the 3 nearest
    neighbours), both axes; rotation: the surface normal as the third
    axis with a spin about it drawn from the run's seed; opacity
    `init_opacity`; DC SH from (intensity, 1, 0), the rest 0; the slots
    in an order drawn from the run's seed.

`Surfels` holds these raw leaves per asset, the vehicles' in their box
frames.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.scenes import generator

Tensor = torch.Tensor

SH_C0 = 0.28209479177387814
KNN_CHUNK = 512


class Asset(NamedTuple):
    """Raw leaves: xyz (N, 3), f_dc (N, 1, 3), f_rest (N, 15, 3),
    log_scale (N, 2), quat (N, 4) wxyz, opacity_logit (N,)."""

    xyz: Tensor
    f_dc: Tensor
    f_rest: Tensor
    log_scale: Tensor
    quat: Tensor
    opacity_logit: Tensor


class Surfels(NamedTuple):
    background: Asset
    actors: list[Asset]          # each in its box frame
    boxes: list[generator.Box]


def _voxel_mean(points: Tensor, attrs: Tensor, voxel: float
                ) -> tuple[Tensor, Tensor]:
    """Per-voxel means of points (P, 3) and attributes (P, C), in the
    lexicographic order of the voxels."""
    ids = torch.floor(points / voxel).to(torch.int64)
    rel = ids - ids.amin(0)
    span = rel.amax(0) + 1
    key = (rel[:, 0] * span[1] + rel[:, 1]) * span[2] + rel[:, 2]
    _, inv, counts = torch.unique(key, return_inverse=True,
                                  return_counts=True)
    both = torch.cat([points, attrs], 1).double()
    acc = torch.zeros((counts.shape[0], both.shape[1]), dtype=torch.float64,
                      device=points.device).index_add_(0, inv, both)
    acc = (acc / counts[:, None]).float()
    return acc[:, :3], acc[:, 3:]


def mean_sq_dist_to_3nn(points: Tensor) -> Tensor:
    """(N,) mean squared distance to the 3 nearest other points, by brute
    force in chunks of queries (float32, TF32 off for the products)."""
    p = points - points.mean(0)
    sq = (p * p).sum(1)
    out = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, p.shape[0], KNN_CHUNK):
            q = p[s:s + KNN_CHUNK]
            d2 = (sq[s:s + KNN_CHUNK, None] + sq[None, :] - 2.0 * q @ p.T)
            idx = torch.arange(q.shape[0], device=p.device)
            d2[idx, idx + s] = torch.inf          # not its own neighbour
            k = min(3, p.shape[0] - 1)
            out.append(d2.topk(k, dim=1, largest=False).values.clamp_min(0.0)
                       .mean(1))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return torch.cat(out)


def quat_from_normal(normals: Tensor, gen: torch.Generator) -> Tensor:
    """Unit quaternions (N, 4) wxyz whose rotation's third column is the
    normal, spun about it by an angle drawn uniformly from [0, 2 pi)."""
    n = normals / torch.linalg.vector_norm(normals, dim=1,
                                           keepdim=True).clamp_min(1e-12)
    helper = torch.where((n[:, 2:3].abs() < 0.9),
                         torch.tensor([0.0, 0.0, 1.0], device=n.device),
                         torch.tensor([1.0, 0.0, 0.0], device=n.device))
    t0 = torch.linalg.cross(helper, n, dim=1)
    t0 = t0 / torch.linalg.vector_norm(t0, dim=1, keepdim=True)
    t1 = torch.linalg.cross(n, t0, dim=1)
    th = torch.rand((n.shape[0], 1), generator=gen,
                    device=n.device) * (2.0 * math.pi)
    w1 = torch.cos(th) * t0 + torch.sin(th) * t1
    w2 = torch.linalg.cross(n, w1, dim=1)
    m = torch.stack([w1, w2, n], dim=2)                      # columns
    return matrix_to_quat(m)


def matrix_to_quat(m: Tensor) -> Tensor:
    """Rotation matrices (N, 3, 3) -> unit quaternions (N, 4) wxyz, by the
    largest of the four squared components."""
    m00, m11, m22 = m[:, 0, 0], m[:, 1, 1], m[:, 2, 2]
    sq = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                      1 - m00 + m11 - m22, 1 - m00 - m11 + m22], 1)
    best = sq.argmax(1)
    r = 0.5 * torch.sqrt(sq.gather(1, best[:, None])[:, 0].clamp_min(1e-12))
    inv = 0.25 / r
    c = [
        torch.stack([r, (m[:, 2, 1] - m[:, 1, 2]) * inv,
                     (m[:, 0, 2] - m[:, 2, 0]) * inv,
                     (m[:, 1, 0] - m[:, 0, 1]) * inv], 1),
        torch.stack([(m[:, 2, 1] - m[:, 1, 2]) * inv, r,
                     (m[:, 0, 1] + m[:, 1, 0]) * inv,
                     (m[:, 0, 2] + m[:, 2, 0]) * inv], 1),
        torch.stack([(m[:, 0, 2] - m[:, 2, 0]) * inv,
                     (m[:, 0, 1] + m[:, 1, 0]) * inv, r,
                     (m[:, 1, 2] + m[:, 2, 1]) * inv], 1),
        torch.stack([(m[:, 1, 0] - m[:, 0, 1]) * inv,
                     (m[:, 0, 2] + m[:, 2, 0]) * inv,
                     (m[:, 1, 2] + m[:, 2, 1]) * inv, r], 1),
    ]
    q = torch.stack(c, 1).gather(
        1, best[:, None, None].expand(-1, 1, 4))[:, 0]
    return q / torch.linalg.vector_norm(q, dim=1, keepdim=True)


def _asset(points: Tensor, inten: Tensor, normals: Tensor, opacity: float,
           gen: torch.Generator) -> Asset:
    """The asset of these points in a slot order drawn from `gen`, each
    spin drawn from `gen`."""
    n = points.shape[0]
    order = torch.randperm(n, generator=gen, device=points.device)
    points, inten, normals = points[order], inten[order], normals[order]
    d2 = mean_sq_dist_to_3nn(points).clamp_min(1e-7)
    color = torch.stack([inten, torch.ones_like(inten),
                         torch.zeros_like(inten)], 1)
    return Asset(
        xyz=points.contiguous(),
        f_dc=((color - 0.5) / SH_C0)[:, None, :].contiguous(),
        f_rest=torch.zeros((n, 15, 3), device=points.device),
        log_scale=torch.log(torch.sqrt(d2))[:, None].expand(n, 2)
        .contiguous(),
        quat=quat_from_normal(normals, gen),
        opacity_logit=torch.full((n,), math.log(opacity / (1.0 - opacity)),
                                 device=points.device))


def _exact_count(x: Tensor, target: int, gen: torch.Generator) -> Tensor:
    """Row ids that hold x's rows at exactly `target`: a seeded subset, or
    every row and seeded repeats."""
    n = x.shape[0]
    perm = torch.randperm(n, generator=gen, device=x.device)
    if n >= target:
        return perm[:target].sort().values
    extra = torch.randint(0, n, (target - n,), generator=gen,
                          device=x.device)
    return torch.cat([torch.arange(n, device=x.device), extra])


def make_surfels(cfg: dict, frames: generator.Frames, seed: int,
                 device) -> Surfels:
    """The configuration's surfels from its frames' returns.  Which points
    become surfels is drawn once, from the configuration's `layout_seed`;
    `seed` draws the slot order and each surfel's spin, so that every seed
    renders the same geometry with the same work, in another order."""
    sc = cfg["surfels"]
    layout = torch.Generator(device=device).manual_seed(int(sc["layout_seed"]))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    walls = len(cfg["scene"]["walls"])
    vehicles = generator.boxes(cfg, "actors")
    bg_p, bg_a = [], []
    ac = [([], []) for _ in vehicles]
    for f, cast in enumerate(frames.casts):
        dirs = generator.world_dirs(
            generator.sensor_dirs(frames.inclinations,
                                  frames.range1.shape[2],
                                  float(cfg["raster"]["pixel_offset"]),
                                  float(cfg["raster"]["angle_offset"])),
            frames.poses[f])
        for rng, inten, sid, nrm in cast.returns:
            hit = rng > 0
            pts = cast.origin + dirs[hit] * rng[hit][:, None]
            attrs = torch.cat([inten[hit][:, None], nrm[hit]], 1)
            s = sid[hit]
            off = s <= walls
            bg_p.append(pts[off])
            bg_a.append(attrs[off])
            for a, box in enumerate(vehicles):
                on = s == walls + 1 + a
                r = torch.as_tensor(box.rotation(), device=device)
                c = torch.as_tensor(box.center_at(f), device=device,
                                    dtype=torch.float32)
                ac[a][0].append((pts[on] - c) @ r)
                ac[a][1].append(torch.cat([attrs[on][:, :1],
                                           attrs[on][:, 1:] @ r], 1))
    opacity = float(sc["init_opacity"])
    voxel = float(sc["voxel_size"])
    pts, attrs = _voxel_mean(torch.cat(bg_p), torch.cat(bg_a), voxel)
    keep = _exact_count(pts, int(sc["background"]), layout)
    dup = torch.zeros(keep.shape[0], dtype=torch.bool, device=device)
    dup[pts.shape[0]:] = True
    jitter = (torch.rand((keep.shape[0], 3), generator=layout, device=device)
              - 0.5) * voxel
    pts = pts[keep] + jitter * dup[:, None]
    attrs = attrs[keep]
    background = _asset(pts, attrs[:, 0], attrs[:, 1:], opacity, gen)
    actors = []
    for a, box in enumerate(vehicles):
        per = int(sc["per_actor"][a])
        p, at = torch.cat(ac[a][0]), torch.cat(ac[a][1])
        if p.shape[0] >= per:
            sel = torch.randperm(p.shape[0], generator=layout,
                                 device=device)[:per].sort().values
            p, at = p[sel], at[sel]
        else:
            extra = per - p.shape[0]
            size = torch.as_tensor(box.size, device=device,
                                   dtype=torch.float32)
            ep = (torch.rand((extra, 3), generator=layout, device=device)
                  - 0.5) * size
            en = torch.randn((extra, 3), generator=layout, device=device)
            ei = torch.rand((extra, 1), generator=layout, device=device)
            p = torch.cat([p, ep])
            at = torch.cat([at, torch.cat([ei, en], 1)])
        actors.append(_asset(p, at[:, 0], at[:, 1:], opacity, gen))
    return Surfels(background, actors, vehicles)


def quat_multiply(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product a*b (..., 4) wxyz."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)
