"""The ("dp", "rays") mesh over `torch.distributed` and the ray-sharded
trace (counterpart of `lidar_rt_tpu.parallel.sharding`).

Ranks are laid out row-major, rays innermost: rank = dp_index * rays +
band.  Each rank of a dp row traces one column band of that row's scan;
the ranks of a rays column (same band, different dp rows) train different
frames.  `Mesh` holds this rank's coordinates and the process groups of
its row and column; every collective of the sharded path goes through
`Mesh.all_reduce`, which counts the bytes it moves and the seconds it
waits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.ops import tracer as tracer_lib
from lidar_rt_tpu_torch.ops.composite import RenderOutputs, SurfelBundle

Tensor = torch.Tensor


@dataclass
class Mesh:
    """This rank's place in a ("dp", "rays") mesh.

    world/rays_group/dp_group: the process groups of the whole mesh, of
    this rank's dp row (its rays ranks) and of its rays column (its dp
    ranks); None where the group has one rank, so its collectives are
    no-ops.  collective_bytes/collective_s accumulate what `all_reduce`
    moved and how long it took."""

    dp: int
    rays: int
    dp_index: int = 0
    band: int = 0
    world: object = None
    rays_group: object = None
    dp_group: object = None
    collective_bytes: int = 0
    collective_s: float = 0.0

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, "rays": self.rays}

    @property
    def size(self) -> int:
        return self.dp * self.rays

    def all_reduce(self, x: Tensor, group) -> Tensor:
        """Sum x over `group` in place (a no-op for a one-rank group) and
        return it.  Gloo reduces host memory: a CUDA tensor is staged
        through pinned host memory and copied back (a copy, not a change
        of device).  NCCL reduces CUDA tensors in place."""
        if group is None:
            return x
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t = time.perf_counter()
        if x.is_cuda and dist.get_backend(group) == "gloo":
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            dist.all_reduce(host, group=group)
            x.copy_(host)
        else:
            dist.all_reduce(x, group=group)
        self.collective_s += time.perf_counter() - t
        self.collective_bytes += x.numel() * x.element_size()
        return x


def make_mesh(dp: int = 1, rays: int | None = None) -> Mesh:
    """The ("dp", "rays") mesh of the initialized process group's ranks
    (rays=None: all ranks of a dp row).  A 1 x 1 mesh needs no process
    group.  Every rank must call it, with the same arguments: it creates
    the row and column groups collectively."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rays = world // dp if rays is None else rays
    if dp < 1 or rays < 1 or dp * rays != world:
        raise ValueError(f"dp={dp} * rays={rays} != {world} ranks")
    if world == 1:
        return Mesh(dp=1, rays=1)
    rank = dist.get_rank()
    row, band = divmod(rank, rays)
    rows = [dist.new_group([r * rays + b for b in range(rays)])
            if rays > 1 else None for r in range(dp)]
    cols = [dist.new_group([r * rays + b for r in range(dp)])
            if dp > 1 else None for b in range(rays)]
    return Mesh(dp=dp, rays=rays, dp_index=row, band=band,
                world=dist.group.WORLD, rays_group=rows[row],
                dp_group=cols[band])


class _SumGradients(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over a group: the
    transpose of handing every rank the same replicated tensor."""

    @staticmethod
    def forward(ctx, mesh: Mesh, group, x):
        ctx.mesh, ctx.group = mesh, group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.mesh.all_reduce(g.contiguous().clone(),
                                               ctx.group)


class _GatherBands(torch.autograd.Function):
    """(H, band_w, C) bands of a dp row -> the (H, W, C) scan on every
    rank.  Every rank must compute the same function of the scan, so the
    backward hands each rank its own band's cotangent."""

    @staticmethod
    def forward(ctx, mesh: Mesh, x):
        h, bw, c = x.shape
        buf = x.new_zeros((mesh.rays, h, bw, c))
        buf[mesh.band] = x
        mesh.all_reduce(buf, mesh.rays_group)
        ctx.cols = slice(mesh.band * bw, (mesh.band + 1) * bw)
        return buf.permute(1, 0, 2, 3).reshape(h, mesh.rays * bw, c)

    @staticmethod
    def backward(ctx, g):
        return None, g[:, ctx.cols]


def band_columns(width: int, mesh: Mesh) -> tuple[int, int]:
    """(col_offset, band width) of this rank's column band of a scan."""
    if width % mesh.rays:
        raise ValueError(f"width {width} not divisible by {mesh.rays} "
                         "bands")
    band_w = width // mesh.rays
    return mesh.band * band_w, band_w


def trace_ray_sharded(bundle: SurfelBundle, grid: rays_lib.SensorGrid,
                      width: int, sensor2world: Tensor, background: Tensor,
                      active_sh_degree: int, cfg: tracer_lib.TraceConfig,
                      mesh: Mesh) -> RenderOutputs:
    """Trace this rank's column band [band * W / rays, (band + 1) * W /
    rays) of the scan against the replicated bundle: the band's (H, W /
    rays, 9) channels, and accum summed over the dp row's bands.

    Differentiable: the bundle's gradient is summed over the row's ranks
    (each band's rays contribute theirs).  `gather_bands` assembles the
    (H, W, 9) scan."""
    col_offset, band_w = band_columns(width, mesh)
    bundle = SurfelBundle(*(_SumGradients.apply(mesh, mesh.rays_group, x)
                            for x in bundle))
    out = tracer_lib.trace(bundle, grid, width, sensor2world, background,
                           active_sh_degree, cfg, col_offset=col_offset,
                           render_width=band_w)
    accum = mesh.all_reduce(out.accum_weights.detach().clone(),
                            mesh.rays_group)
    return RenderOutputs(channels=out.channels, accum_weights=accum,
                         raw_trans=out.raw_trans)


def gather_bands(channels: Tensor, mesh: Mesh) -> Tensor:
    """All-gather the dp row's (H, band_w, C) bands into the (H, W, C)
    scan, differentiably for a function of the scan that every rank of
    the row computes alike."""
    return _GatherBands.apply(mesh, channels)
