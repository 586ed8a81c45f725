"""The primitives a per-ray compacted design stands on, timed (counterpart of
the reference's `scripts/compact_probe.py:108-245`).

    python -m lidar_rt_tpu_torch.scripts.compact_probe [--device cuda]

A compacted design lists each ray's K' nearest gate-passing candidates and
composites those alone.  A training step then pays, beside its kernels:

  1. a row gather of each pair's operands, (N, F=58)[idx (R K',)];
  2. a scatter-add of each pair's gradients, F=16, back to the surfels;
     or, with the pairs sorted by surfel at binning time, a sorted
     segment-sum;

and once per rebin (amortised over 10 steps):

  3. building the per-ray lists from the flagship tile assignment (8x128,
     K=256): per tile, every pair's alpha gate, then each ray's nearest K'
     gate-passers (a stable sort: equal depths keep the lower slot, as
     `lax.top_k` does).

It times each at the scan's rays (R = H x W; 169,600 at the bench's 64 x
2650) and K' of 16, 32 and 64, prints the GB each gather writes, and sums
1 + 2 + 3/10 per K' beside the port's own dense step: the flagship
tile-order render and its backward (`sweep_perf`'s first row), measured
in the same process.  If the sum alone exceeds the dense step, the
compacted design loses before any kernel work.  Times are device ms over
back-to-back calls (CUDA events on the card, the host clock on the CPU).
"""

from __future__ import annotations

import torch

from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.ops.binning import TileConfig, bin_surfels
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import street, sweep_perf

Tensor = torch.Tensor

F_GATHER = 58
F_GRAD = 16
K_PRIMES = (16, 32, 64)
K_SEGSUM = 32
K_LISTS = 32
REBIN_INTERVAL = 10
ITERS = 8
TILE = TileConfig(tile_h=8, tile_w=128, max_per_tile=256, binner="hier")
CHUNK = 8


def build_lists(bundle: SurfelBundle, grid, width: int, s2w: Tensor,
                kp: int, tile: TileConfig = TILE) -> Tensor:
    """Each ray's kp nearest gate-passing candidates, (T, R, kp) surfel ids,
    from a fresh binning at `tile`; a ray with fewer passers fills its
    list with the tile's first non-passing slots, as `lax.top_k` does."""
    n = bundle.num_surfels
    asn = bin_surfels(grid, width, transforms.invert_se3(s2w), bundle.means,
                      bundle.scales, bundle.opacities, tile,
                      rotations=bundle.rotations)
    idx_c = asn.index.clamp(0, n - 1)
    frames, dirs_t = street.tile_rays(bundle, grid, width, s2w, tile)
    lists = []
    for s in range(0, idx_c.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        ok, _, t = street.tile_gate(frames, bundle, dirs_t[sl], idx_c[sl],
                                    asn.valid[sl], plane_check=False)
        score = torch.where(ok, -t, -torch.inf)
        sel = torch.sort(score, dim=-1, descending=True,
                         stable=True).indices[..., :kp]
        lists.append(torch.gather(idx_c[sl][:, None, :].expand_as(score),
                                  -1, sel))
    return torch.cat(lists)


def probe(bundle: SurfelBundle, grid, width: int, s2w: Tensor,
          device="cuda", iters: int = ITERS) -> dict:
    """ms of each primitive ({"gather"|"scatter": {K': ms}, "segsum",
    "lists", "dense"}), the GB each gather writes, and the rays."""
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    n = bundle.num_surfels
    rays = grid.height * width
    gen = torch.Generator(device=device).manual_seed(0)
    out = {"rays": rays, "surfels": n, "gather": {}, "gather_gb": {},
           "scatter": {}}
    with torch.no_grad():
        ops = torch.randn(n, F_GATHER, generator=gen, device=device)
        for kp in K_PRIMES:
            idx = torch.randint(0, n, (rays * kp,), generator=gen,
                                device=device)
            out["gather"][kp] = street.device_ms(
                lambda: ops.index_select(0, idx), iters, device)
            out["gather_gb"][kp] = rays * kp * F_GATHER * 4 / 1e9
            del idx
        for kp in K_PRIMES:
            idx = torch.randint(0, n, (rays * kp,), generator=gen,
                                device=device)
            grads = torch.randn(rays * kp, F_GRAD, generator=gen,
                                device=device)
            out["scatter"][kp] = street.device_ms(
                lambda: torch.zeros(n, F_GRAD, device=device).index_add_(
                    0, idx, grads), iters, device)
            del idx, grads
        seg = torch.sort(torch.randint(0, n, (rays * K_SEGSUM,),
                                       generator=gen, device=device)).values
        lengths = torch.bincount(seg, minlength=n)
        grads = torch.randn(rays * K_SEGSUM, F_GRAD, generator=gen,
                            device=device)
        out["segsum"] = street.device_ms(
            lambda: torch.segment_reduce(grads, "sum", lengths=lengths),
            iters, device)
        del seg, lengths, grads
        out["lists"] = street.device_ms(
            lambda: build_lists(bundle, grid, width, s2w, K_LISTS), 2,
            device)
    out["dense"] = sweep_perf.sweep(bundle, grid, width, s2w,
                                    [sweep_perf.CONFIGS[0]], False, device,
                                    iters)[0]["fwd_bwd_ms"]
    return out


def lines(r: dict) -> list[str]:
    """The reference's lines; its TPU step time replaced by the port's
    dense flagship forward+backward from the same run."""
    out = [f"rays {r['rays']}, surfels {r['surfels']}"]
    for kp, ms in r["gather"].items():
        gb = r["gather_gb"][kp]
        out.append(f"gather  F={F_GATHER:2d} K'={kp:2d}: {ms:7.2f} ms "
                   f"({gb:.2f} GB out, {gb / ms * 1e3:.0f} GB/s)")
    for kp, ms in r["scatter"].items():
        out.append(f"scatter F={F_GRAD} K'={kp:2d}: {ms:7.2f} ms")
    out.append(f"sorted segment-sum F={F_GRAD} K'={K_SEGSUM}: "
               f"{r['segsum']:7.2f} ms")
    out.append(f"per-ray list build K'={K_LISTS}: {r['lists']:.2f} ms "
               f"(amortized /{REBIN_INTERVAL}: "
               f"{r['lists'] / REBIN_INTERVAL:.2f} ms/step)")
    for kp in K_PRIMES:
        floor = (r["gather"][kp] + r["scatter"][kp]
                 + r["lists"] / REBIN_INTERVAL)
        mray = r["rays"] / (floor * 1e-3) / 1e6
        out.append(f"K'={kp:2d}: gather+scatter+amortized-build floor "
                   f"{floor:6.2f} ms  (= {mray:5.1f} Mray/s ceiling BEFORE "
                   f"kernel work; dense flagship step, tile-order forward+"
                   f"backward here: {r['dense']:.2f} ms)")
    return out


def main(argv=None) -> dict:
    a = street.parser("compact_probe", __doc__).parse_args(argv)
    bundle, grid, width, s2w = street.setup(a)
    r = probe(bundle, grid, width, s2w, a.device)
    for line in lines(r):
        print(line, flush=True)
    return r


if __name__ == "__main__":
    main()
