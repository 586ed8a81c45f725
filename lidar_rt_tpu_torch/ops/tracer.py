"""The tiled surfel tracer, public render entry point (counterpart of
`lidar_rt_tpu.ops.tracer`).

  1. `bin_surfels` lists the K nearest candidates per range-image tile,
  2. per tile every (ray, candidate) pair is intersected analytically,
  3. hits are alpha-composited front-to-back in tile order, or with
     `exact_order` in each ray's depth order,
  4. per-candidate weights are scattered back to surfels.

Engines: "cuda" is the kernel path (`ops/cuda_tracer.py`: the hand-written
CUDA kernels on CUDA tensors, their plain twins on CPU tensors); "torch" is
the plain engine below, the twin of the reference's jax engine, composited
in batches of `tile_batch` tiles to bound memory.  A config renders with
the engine `TraceConfig.resolve_engine` names: exact order at a K the
exact kernels do not take goes to the torch engine, as the reference
sends it to its jax engine.  Both take a per-ray
`min_depth` (`render_multi_return`'s second return) and `init_trans`,
chain `tail_passes` re-binned passes past each truncated tile's K-th
candidate (`bin_tail_chain`, `_trace_tail`), and render a column band of
the scan (`col_offset`, `render_width`: the unit of ray sharding,
`parallel/`).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence
from dataclasses import dataclass

import torch

from lidar_rt_tpu_torch.core import quaternions as quat_lib
from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.core import sh as sh_lib
from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.ops import cuda_tracer, geometry, kernels
from lidar_rt_tpu_torch.ops.binning import (TileAssignment, TileConfig,
                                            bin_surfels, sensor_points)
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
    exact_order: composite each ray's gate-passing hits in ascending
      (depth, candidate index) order instead of the binner's tile order.
      The "cuda" engine's exact kernels take K <= kernels.EXACT_MAX_K; a
      wider exact config resolves to the torch engine (`resolve_engine`).
    tile_batch: tiles composited at once by the torch engine.
    tail_passes: re-binned passes appended to the render, each past every
      truncated tile's K-th candidate range, carrying the per-ray raw
      transmittance; 0 = off.
    fast_math: the "cuda" engine's backward takes its d_sh sums in one
      TF32 product per term where float32 takes three (the reference's
      one-pass bf16 contractions); the forward has no contraction and is
      the same float32 either way.
    cache_fwd: the forward keeps each (ray, candidate) step's gated alpha
      and exclusive transmittance as bfloat16 and the backward decodes them
      in place of a replay (the reference's residual cache); effective
      only with fast_math and in tile order (`use_cache`), as in the
      reference, so a config that sets it with exact_order still trains,
      uncached.  The torch engine ignores both, as the reference's jax
      engine does.

    The reference defaults both modes on; here both default off, so that
    TraceConfig() keeps the float32 semantics that every parity test of
    the port is held to.  `train.options.trace_configs` turns them on from
    a config's `tracer:` block for a trainer on a CUDA device.
    """

    tile: TileConfig = FLAGSHIP_TILE
    exact_order: bool = False
    tile_batch: int = 8
    engine: str = "cuda"
    tail_passes: int = 0
    fast_math: bool = False
    cache_fwd: bool = False

    def __post_init__(self):
        if self.engine not in ("cuda", "torch"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.tail_passes < 0:
            raise ValueError(f"tail_passes must be >= 0, got "
                             f"{self.tail_passes}")

    def resolve_engine(self) -> str:
        """The engine that renders this config, from the config alone (the
        counterpart of lidar_rt_tpu/ops/tracer.py:104): "torch" for the
        torch engine and for exact order past the exact kernels' K
        (kernels.EXACT_MAX_K), as the reference's "auto" engine sends
        exact order at any K but 128 and 256 to its jax engine; else
        "cuda".  A route, not a fallback: the torch engine runs on the
        tensors' device, and a "cuda" config's failed build or launch
        raises."""
        if self.engine == "cuda" and not (
                self.exact_order
                and self.tile.max_per_tile > kernels.EXACT_MAX_K):
            return "cuda"
        return "torch"

    @property
    def use_cache(self) -> bool:
        """Whether the "cuda" engine's forward keeps the cache for its
        backward (lidar_rt_tpu/ops/tracer.py:252-256)."""
        return (self.cache_fwd and self.fast_math and not self.exact_order
                and self.resolve_engine() == "cuda")


def _composite_tile(dirs: Tensor, frames_k: geometry.SurfelFrames,
                    scales_k: Tensor, opac_k: Tensor, sh_k: Tensor,
                    cand_valid: Tensor, background: Tensor,
                    active_sh_degree: int, exact_order: bool,
                    min_depth: Tensor | None = None,
                    init_trans: Tensor | None = None
                    ) -> tuple[Tensor, Tensor]:
    """Composite a batch of B tiles: rays (B, R, 3) x K candidates each
    (frames_k fields (B, K[, 3]), scales (B, K, 2), opac (B, K),
    sh (B, K, 16, 3), cand_valid (B, K)); optional per-ray min_depth and
    init_trans (B, R).

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
    t_min = geometry.DEPTH_MIN if min_depth is None else min_depth[..., None]
    valid = ((t >= t_min)
             & (qd.abs() > geometry.DENOM_EPS)
             & (p != 0.0)
             & (alpha_raw >= geometry.ALPHA_MIN)
             & cand_valid[:, None, :])
    alpha = torch.where(valid, alpha_raw, 0.0)

    if exact_order:
        perm = torch.argsort(torch.where(valid, t, torch.inf), dim=-1,
                             stable=True)
        w_o, final_t = geometry.composite_weights(
            torch.gather(alpha, -1, perm), init_trans)
        w = torch.zeros_like(w_o).scatter(-1, perm, w_o)
    else:
        w, final_t = geometry.composite_weights(alpha, init_trans)

    basis = sh_lib.basis(dirs, active_sh_degree)              # (B, R, 16)
    colors = torch.einsum("brs,bksc->brkc", basis, sh_k) + 0.5
    colors = torch.cat([colors[..., :1].clamp_min(0.0), colors[..., 1:]], -1)
    color_out = (torch.einsum("brk,brkc->brc", w, colors)
                 + final_t[..., None] * background)
    signed_n = frames_k.n * frames_k.sign[..., None]          # (B, K, 3)
    # Raw transmittance (col 9), the tail passes' carry: the full product,
    # with the hits the T_MIN cutoff dropped, so a stopped ray carries
    # raw < T_MIN and stays stopped.
    raw_t = torch.prod(1.0 - alpha, dim=-1, keepdim=True)
    if init_trans is not None:
        raw_t = init_trans[..., None] * raw_t
    channels = torch.cat(
        [color_out, (w * t).sum(-1, keepdim=True), w.sum(-1, keepdim=True),
         torch.einsum("brk,bkc->brc", w, signed_n), final_t[..., None],
         raw_t], dim=-1)
    return channels, w.sum(1)


def trace(bundle: SurfelBundle, grid: rays_lib.SensorGrid, width: int,
          sensor2world: Tensor, background: Tensor,
          active_sh_degree: int = 3, cfg: TraceConfig = TraceConfig(),
          assignment: TileAssignment | Sequence[TileAssignment] | None = None,
          min_depth: Tensor | None = None, init_trans: Tensor | None = None,
          col_offset: int = 0, render_width: int | None = None
          ) -> RenderOutputs:
    """Render a range image: (H, W_r, 9) channels + (N,) accum weights.

    `assignment` may be precomputed (it depends on detached inputs only);
    with `cfg.tail_passes` > 0 it is a sequence of tail_passes + 1 of them
    (`bin_tail_chain`).  min_depth: optional per-ray (H, W_r) minimum hit
    range (the second return's re-trace); init_trans: optional per-ray
    (H, W_r) initial transmittance (the tail passes' carry).

    col_offset/render_width render only the column band [col_offset,
    col_offset + W_r) of the W-column scan (modulo W; default the whole
    scan): each rank of a ray-sharded render traces its own band against
    the replicated surfels.  Tiles start at col_offset; a band's last
    tile, where W_r is no multiple of tile_w, traces the next columns' rays
    and drops them from the image (their weights still count in accum, as
    the wrap-padded tiles of a whole scan do).
    """
    if cfg.tail_passes > 0:
        if isinstance(assignment, TileAssignment):
            raise ValueError(
                "tail_passes composites one assignment per pass: pass a "
                "sequence of tail_passes + 1 TileAssignments (e.g. the "
                "trainer's cached chain) or None to re-bin per pass")
        return _trace_tail(bundle, grid, width, sensor2world, background,
                           active_sh_degree, cfg, min_depth, init_trans,
                           assignment, col_offset, render_width)
    if cfg.resolve_engine() == "cuda":
        return cuda_tracer.trace(bundle, grid, width, sensor2world,
                                 background, active_sh_degree, cfg.tile,
                                 assignment, cfg.exact_order, min_depth,
                                 init_trans, col_offset, render_width,
                                 cfg.fast_math, cfg.use_cache)

    h = grid.height
    w_r = width if render_width is None else render_width
    n = bundle.num_surfels
    if assignment is None:
        assignment = cuda_tracer.bin_bundle(bundle, grid, width,
                                            sensor2world, cfg.tile,
                                            col_offset, w_r)
    origin, dirs = rays_lib.range_rays(grid, width, sensor2world)
    dirs_t = cuda_tracer.to_tiles(dirs, cfg.tile, col_offset,
                                  w_r)                        # (T, R, 3)
    md_t = (None if min_depth is None
            else cuda_tracer.to_tiles(min_depth, cfg.tile))
    t0_t = (None if init_trans is None
            else cuda_tracer.to_tiles(init_trans, cfg.tile))
    frames = geometry.build_frames(
        bundle.means, quat_lib.to_rotation_matrix(bundle.rotations), origin)
    idx_c = assignment.index.clamp(0, n - 1)

    chans, wsums = [], []
    for s in range(0, idx_c.shape[0], cfg.tile_batch):
        batch = slice(s, s + cfg.tile_batch)
        idx = idx_c[batch]
        c, ws = _composite_tile(
            dirs_t[batch], geometry.SurfelFrames(*(f[idx] for f in frames)),
            bundle.scales[idx], bundle.opacities[idx], bundle.sh[idx],
            assignment.valid[batch], background, active_sh_degree,
            cfg.exact_order, None if md_t is None else md_t[batch],
            None if t0_t is None else t0_t[batch])
        chans.append(c)
        wsums.append(ws)
    img = cuda_tracer.from_tiles(torch.cat(chans), cfg.tile, h, w_r)
    accum = cuda_tracer.scatter_accum(assignment, torch.cat(wsums), n)
    return RenderOutputs(channels=img[..., :9], accum_weights=accum,
                         raw_trans=img[..., 9])


def _tile_range_cutoff(assignment: TileAssignment, means: Tensor,
                       world2sensor: Tensor) -> Tensor:
    """Per-tile range of the K-th (farthest) selected candidate, or +inf
    where the tile was not truncated.  Binning with min_range = cutoff
    lists exactly the ranks the K budget dropped: nearest-first selection
    makes the selected set a range prefix.  The range is the binner's own
    (`sensor_points`), so the K-th candidate is not listed again."""
    n = means.shape[0]
    rng = sensor_points(world2sensor, means)[3]
    rng_sel = torch.where(assignment.valid,
                          rng[assignment.index.clamp(0, n - 1)], -torch.inf)
    return torch.where(assignment.truncated > 0, rng_sel.amax(-1), torch.inf)


def bin_tail_chain(bundle: SurfelBundle, grid: rays_lib.SensorGrid,
                   width: int, world2sensor: Tensor, tile: TileConfig,
                   passes: int, col_offset: int = 0,
                   num_cols: int | None = None) -> list[TileAssignment]:
    """Bin the tail re-trace chain of the column band (col_offset,
    num_cols; default the whole scan): passes + 1 disjoint assignments,
    each strictly past the previous pass's per-tile K-th candidate range
    (a visibility oracle: every input is detached).  `trace` with
    cfg.tail_passes = passes consumes it; the trainer caches it."""
    w2s = world2sensor.detach()
    means = bundle.means.detach()
    chain = []
    min_range = None
    for p in range(passes + 1):
        a = bin_surfels(grid, width, w2s, means, bundle.scales,
                        bundle.opacities, tile, rotations=bundle.rotations,
                        min_range=min_range, col_offset=col_offset,
                        num_cols=num_cols)
        chain.append(a)
        if p < passes:
            cutoff = _tile_range_cutoff(a, means, w2s)
            min_range = (cutoff if min_range is None
                         else torch.maximum(cutoff, min_range))
    return chain


def _trace_tail(bundle: SurfelBundle, grid: rays_lib.SensorGrid, width: int,
                sensor2world: Tensor, background: Tensor,
                active_sh_degree: int, cfg: TraceConfig,
                min_depth: Tensor | None, init_trans: Tensor | None,
                assignments: Sequence[TileAssignment] | None,
                col_offset: int = 0, render_width: int | None = None
                ) -> RenderOutputs:
    """Chain cfg.tail_passes re-binned passes (the reference's re-launch
    from the last depth, at whole-image granularity).  Each pass
    composites the K nearest remaining candidates per tile and carries the
    per-ray raw transmittance, so a ray stopped at T_MIN stays stopped;
    the channel sums add up.  T_out telescopes: T_0 minus every pass's
    composited weight.  Gradients flow through every pass and the carry.
    assignments: an optional precomputed chain of tail_passes + 1
    (`bin_tail_chain`); else each pass bins past the previous one.  A
    column band (col_offset, render_width) carries its own (H, W_r)
    transmittance."""
    passes = cfg.tail_passes + 1
    if assignments is not None and len(assignments) != passes:
        raise ValueError(
            f"assignments chain has {len(assignments)} entries for "
            f"{cfg.tail_passes} tail passes (need tail_passes + 1)")
    if assignments is None:
        assignments = bin_tail_chain(
            bundle, grid, width, transforms.invert_se3(sensor2world),
            cfg.tile, cfg.tail_passes, col_offset, render_width)
    cfg0 = dataclasses.replace(cfg, tail_passes=0)
    zero_bg = torch.zeros_like(background)
    carry = init_trans
    chans = accum = None
    for assignment in assignments:
        out = trace(bundle, grid, width, sensor2world, zero_bg,
                    active_sh_degree, cfg0, assignment, min_depth, carry,
                    col_offset, render_width)
        if chans is None:
            chans, accum = out.channels[..., 0:8], out.accum_weights
        else:
            chans = chans + out.channels[..., 0:8]
            accum = accum + out.accum_weights
        carry = out.raw_trans
    t0 = torch.ones_like(chans[..., 4]) if init_trans is None else init_trans
    final_t = (t0 - chans[..., 4])[..., None]
    channels = torch.cat([chans[..., 0:3] + final_t * background,
                          chans[..., 3:8], final_t], dim=-1)
    return RenderOutputs(channels=channels, accum_weights=accum,
                         raw_trans=carry)


def _decode(out: RenderOutputs, use_rayhit: bool) -> dict[str, Tensor]:
    """Depth / intensity / raydrop probability / accumulated weights /
    channels of a render.  The ray-drop head is a softmax over the (hit,
    drop) logits, or a sigmoid of the drop logit without `use_rayhit`."""
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


def render_frame(bundle: SurfelBundle, grid: rays_lib.SensorGrid, width: int,
                 sensor2world: Tensor, active_sh_degree: int = 3,
                 cfg: TraceConfig = TraceConfig(), use_rayhit: bool = True,
                 assignment: TileAssignment | Sequence[TileAssignment]
                 | None = None) -> dict[str, Tensor]:
    """Decoded render (`_decode`).  Background (0, 0, 1): empty rays get
    ray-drop logit 1."""
    background = torch.tensor([0.0, 0.0, 1.0], device=bundle.means.device)
    return _decode(trace(bundle, grid, width, sensor2world, background,
                         active_sh_degree, cfg, assignment), use_rayhit)


def render_multi_return(bundle: SurfelBundle, grid: rays_lib.SensorGrid,
                        width: int, sensor2world: Tensor,
                        active_sh_degree: int = 3,
                        cfg: TraceConfig = TraceConfig(),
                        use_rayhit: bool = True, return_gap: float = 1.0
                        ) -> tuple[dict[str, Tensor], dict[str, Tensor]]:
    """Dual-return rendering (two-return range images): return 1 is
    `render_frame`; return 2 re-traces each ray with its minimum hit range
    pushed `return_gap` meters past the first return's depth.  Without
    tail passes one assignment is binned and shared by both returns
    (min_depth only re-gates hits); with them each return bins its own
    chain."""
    assignment = None
    if cfg.tail_passes == 0:
        assignment = cuda_tracer.bin_bundle(bundle, grid, width,
                                            sensor2world, cfg.tile)
    r1 = render_frame(bundle, grid, width, sensor2world, active_sh_degree,
                      cfg, use_rayhit, assignment)
    min2 = r1["depth"].detach().clamp_min(0.0) + return_gap
    background = torch.tensor([0.0, 0.0, 1.0], device=bundle.means.device)
    out2 = trace(bundle, grid, width, sensor2world, background,
                 active_sh_degree, cfg, assignment, min_depth=min2)
    return r1, _decode(out2, use_rayhit)
