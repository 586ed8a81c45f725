"""The tiled surfel tracer, public render entry point (counterpart of
`lidar_rt_tpu.ops.tracer`).

  1. `bin_surfels` lists the K nearest candidates per range-image tile,
  2. per tile every (ray, candidate) pair is intersected analytically,
  3. hits are alpha-composited front-to-back in tile order (optionally
     re-sorted per ray by hit depth on the torch engine),
  4. per-candidate weights are scattered back to surfels.

Engines: "cuda" is the kernel path (`ops/cuda_tracer.py`: the hand-written
CUDA kernel on CUDA tensors, its plain twin on CPU tensors); "torch" is the
plain engine below, the twin of the reference's jax engine, composited in
batches of `tile_batch` tiles to bound memory.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lidar_rt_tpu_torch.core import quaternions as quat_lib
from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.core import sh as sh_lib
from lidar_rt_tpu_torch.ops import cuda_tracer, geometry
from lidar_rt_tpu_torch.ops.binning import TileAssignment, TileConfig
from lidar_rt_tpu_torch.ops.composite import RenderOutputs, SurfelBundle

Tensor = torch.Tensor

# The flagship tracer configuration (the reference's FLAGSHIP_TILE with
# exact top-k in place of the TPU's approximate top-k).
FLAGSHIP_TILE = TileConfig(tile_h=8, tile_w=128, max_per_tile=256,
                           binner="hier")


@dataclass(frozen=True)
class TraceConfig:
    """Static tracer parameters.  Defaults are the flagship configuration.

    engine: "cuda" (kernel path) or "torch" (plain engine).
    exact_order: re-sort candidates per ray by hit depth; torch engine
      only (the kernel composites in tile order).
    tile_batch: tiles composited at once by the torch engine.
    """

    tile: TileConfig = FLAGSHIP_TILE
    exact_order: bool = False
    tile_batch: int = 8
    engine: str = "cuda"

    def __post_init__(self):
        if self.engine not in ("cuda", "torch"):
            raise ValueError(f"unknown engine {self.engine!r}")


def _composite_tile(dirs: Tensor, frames_k: geometry.SurfelFrames,
                    scales_k: Tensor, opac_k: Tensor, sh_k: Tensor,
                    cand_valid: Tensor, background: Tensor,
                    active_sh_degree: int, exact_order: bool
                    ) -> tuple[Tensor, Tensor]:
    """Composite a batch of B tiles: rays (B, R, 3) x K candidates each
    (frames_k fields (B, K[, 3]), scales (B, K, 2), opac (B, K),
    sh (B, K, 16, 3), cand_valid (B, K)).

    Returns (channels (B, R, 10): the 9 public channels + the ungated raw
    transmittance, per-candidate weight sums (B, K))."""
    qd = geometry.ray_dot(dirs, frames_k.n)                   # (B, R, K)
    b_u = geometry.ray_dot(dirs, frames_k.w1)
    b_v = geometry.ray_dot(dirs, frames_k.w2)
    safe_qd = torch.where(qd.abs() > geometry.DENOM_EPS, qd,
                          geometry.DENOM_EPS)
    p = frames_k.p[:, None, :]
    t = p / safe_qd
    # Times the inverse scale, as the kernel path computes it.
    inv_s = 1.0 / scales_k
    u = (frames_k.a_u[:, None, :] + t * b_u) * inv_s[:, None, :, 0]
    v = (frames_k.a_v[:, None, :] + t * b_v) * inv_s[:, None, :, 1]
    g = torch.exp(-0.5 * (u * u + v * v))
    alpha_raw = (opac_k[:, None, :] * g).clamp_max(geometry.ALPHA_MAX)
    valid = ((t >= geometry.DEPTH_MIN)
             & (qd.abs() > geometry.DENOM_EPS)
             & (p != 0.0)
             & (alpha_raw >= geometry.ALPHA_MIN)
             & cand_valid[:, None, :])
    alpha = torch.where(valid, alpha_raw, 0.0)

    if exact_order:
        perm = torch.argsort(torch.where(valid, t, torch.inf), dim=-1,
                             stable=True)
        w_o, final_t = geometry.composite_weights(
            torch.gather(alpha, -1, perm))
        w = torch.zeros_like(w_o).scatter(-1, perm, w_o)
    else:
        w, final_t = geometry.composite_weights(alpha)

    basis = sh_lib.basis(dirs, active_sh_degree)              # (B, R, 16)
    colors = torch.einsum("brs,bksc->brkc", basis, sh_k) + 0.5
    colors = torch.cat([colors[..., :1].clamp_min(0.0), colors[..., 1:]], -1)
    color_out = (torch.einsum("brk,brkc->brc", w, colors)
                 + final_t[..., None] * background)
    signed_n = frames_k.n * frames_k.sign[..., None]          # (B, K, 3)
    channels = torch.cat(
        [color_out, (w * t).sum(-1, keepdim=True), w.sum(-1, keepdim=True),
         torch.einsum("brk,bkc->brc", w, signed_n), final_t[..., None],
         torch.prod(1.0 - alpha, dim=-1, keepdim=True)], dim=-1)
    return channels, w.sum(1)


def trace(bundle: SurfelBundle, grid: rays_lib.SensorGrid, width: int,
          sensor2world: Tensor, background: Tensor,
          active_sh_degree: int = 3, cfg: TraceConfig = TraceConfig(),
          assignment: TileAssignment | None = None) -> RenderOutputs:
    """Render a range image: (H, W, 9) channels + (N,) accum weights.

    `assignment` may be precomputed (it depends on detached inputs only).
    """
    if cfg.engine == "cuda":
        if cfg.exact_order:
            raise NotImplementedError(
                "exact_order is not ported to the CUDA kernel yet; use "
                "engine='torch'")
        return cuda_tracer.trace(bundle, grid, width, sensor2world,
                                 background, active_sh_degree, cfg.tile,
                                 assignment)

    h, w = grid.height, width
    n = bundle.num_surfels
    if assignment is None:
        assignment = cuda_tracer.bin_bundle(bundle, grid, w, sensor2world,
                                            cfg.tile)
    origin, dirs = rays_lib.range_rays(grid, w, sensor2world)
    dirs_t = cuda_tracer.to_tiles(dirs, cfg.tile)             # (T, R, 3)
    frames = geometry.build_frames(
        bundle.means, quat_lib.to_rotation_matrix(bundle.rotations), origin)
    idx_c = assignment.index.clamp(0, n - 1)

    chans, wsums = [], []
    for s in range(0, idx_c.shape[0], cfg.tile_batch):
        idx = idx_c[s:s + cfg.tile_batch]
        c, ws = _composite_tile(
            dirs_t[s:s + cfg.tile_batch],
            geometry.SurfelFrames(*(f[idx] for f in frames)),
            bundle.scales[idx], bundle.opacities[idx], bundle.sh[idx],
            assignment.valid[s:s + cfg.tile_batch], background,
            active_sh_degree, cfg.exact_order)
        chans.append(c)
        wsums.append(ws)
    img = cuda_tracer.from_tiles(torch.cat(chans), cfg.tile, h, w)
    accum = cuda_tracer.scatter_accum(assignment, torch.cat(wsums), n)
    return RenderOutputs(channels=img[..., :9], accum_weights=accum,
                         raw_trans=img[..., 9])


def render_frame(bundle: SurfelBundle, grid: rays_lib.SensorGrid, width: int,
                 sensor2world: Tensor, active_sh_degree: int = 3,
                 cfg: TraceConfig = TraceConfig(), use_rayhit: bool = True,
                 assignment: TileAssignment | None = None
                 ) -> dict[str, Tensor]:
    """Decoded render: depth / intensity / raydrop probability /
    accumulated weights / channels.  Background (0, 0, 1): empty rays get
    ray-drop logit 1.  The ray-drop head is a softmax over the (hit, drop)
    logits, or a sigmoid of the drop logit without `use_rayhit`."""
    background = torch.tensor([0.0, 0.0, 1.0], device=bundle.means.device)
    out = trace(bundle, grid, width, sensor2world, background,
                active_sh_degree, cfg, assignment=assignment)
    ch = out.channels
    if use_rayhit:
        raydrop = torch.softmax(ch[..., 1:3], dim=-1)[..., 1]
    else:
        raydrop = torch.sigmoid(ch[..., 2])
    return {
        "depth": ch[..., 3],
        "intensity": ch[..., 0],
        "raydrop": raydrop,
        "accum_weights": out.accum_weights,
        "channels": ch,
    }
