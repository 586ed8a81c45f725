"""The binner's stage costs and candidate demand (counterpart of the
reference's `scripts/profile_binner.py:32-109`).

    python -m lidar_rt_tpu_torch.scripts.profile_binner [--device cuda]

Times `footprint_bounds` alone and `bin_surfels` for each config of
`CONFIGS` on the street scene (device ms over ITERS back-to-back calls:
CUDA events on the card), and prints per config the candidates per tile
(mean, p95, max) and the truncated tiles (count, total overflow): the
data that decides how small tile_h x K can go before truncation hurts.
The `m1024` row runs the hier binner's macro-column level (1,024-column
sectors, K_a = 4 K_c) and adds its truncating sectors and their overflow.
Selection is exact, as the reference's `approx_topk` is off a TPU.  A
config that fails raises.  `exact_macro` finds a shape of the scan whose
macro sectors truncate nothing and holds the macro level's lists to plain
hier's there.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.ops.binning import (TileConfig, bin_surfels,
                                            footprint_bounds,
                                            macro_candidates)
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import street

Tensor = torch.Tensor

ITERS = 20
# (label, tile_h, tile_w, K, binner, coarse factor, macro_cols)
CONFIGS = [
    ("hier  8x128 K256 cf8", 8, 128, 256, "hier", 8, 0),
    ("hier  8x128 K256 cf4", 8, 128, 256, "hier", 4, 0),
    ("hier  8x128 K256 cf8 m1024", 8, 128, 256, "hier", 8, 1024),
    ("hier  4x128 K128 cf8", 4, 128, 128, "hier", 8, 0),
    ("hier  4x128 K256 cf8", 4, 128, 256, "hier", 8, 0),
    ("hier  2x128 K128 cf8", 2, 128, 128, "hier", 8, 0),
    ("hier  1x128 K128 cf8", 1, 128, 128, "hier", 8, 0),
    ("sort  8x128 K256", 8, 128, 256, "sort", 8, 0),
]
FLAGSHIP = TileConfig(tile_h=8, tile_w=128, max_per_tile=256, binner="hier")


def profile(bundle: SurfelBundle, grid, width: int, s2w: Tensor,
            device="cuda", iters: int = ITERS) -> dict:
    """{"footprint_ms": ms, label: {"ms", "counts" (T,), "truncated" (T,),
    with macro_cols also "macro_trunc" (M,), None where the level is off
    (K_a >= N)}}."""
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    w2s = transforms.invert_se3(s2w)
    args = (grid, width, w2s, bundle.means, bundle.scales, bundle.opacities)
    rot = bundle.rotations
    out = {}
    with torch.no_grad():
        out["footprint_ms"] = street.device_ms(
            lambda: footprint_bounds(*args, FLAGSHIP, rotations=rot), iters,
            device)
        for label, th, tw, k, binner, cf, macro in CONFIGS:
            cfg = TileConfig(tile_h=th, tile_w=tw, max_per_tile=k,
                             binner=binner, coarse_factor=cf,
                             macro_cols=macro)
            ms = street.device_ms(
                lambda cfg=cfg: bin_surfels(*args, cfg, rotations=rot),
                iters, device)
            a = bin_surfels(*args, cfg, rotations=rot)
            out[label] = {"ms": ms,
                          "counts": a.valid.sum(1).cpu().numpy(),
                          "truncated": a.truncated.cpu().numpy()}
            if macro:
                out[label]["macro_trunc"] = macro_overflow(args, cfg, rot)
    return out


def macro_overflow(args: tuple, cfg: TileConfig, rot: Tensor
                   ) -> np.ndarray | None:
    """(M,) overflow of each macro sector of `cfg` on the scan `args`
    (grid, width, world2sensor, means, scales, opacities): its
    overlapping surfels past K_a; None where the hier binner leaves the
    level off (macro_cols <= tile_w, or K_a >= N)."""
    grid, width = args[:2]
    n = args[3].shape[0]
    k_c = min(cfg.coarse_factor * cfg.max_per_tile, n)
    if cfg.macro_cols <= cfg.tile_w or cfg.macro_factor * k_c >= n:
        return None
    row_lo, row_hi, col_c, col_half, rng, live = footprint_bounds(
        *args, cfg, rotations=rot)
    g = max(cfg.macro_cols // cfg.tile_w, 1)
    tiles_x = cfg.num_tiles(grid.height, width)[1]
    return macro_candidates(cfg, g, -(-tiles_x // g),
                            min(cfg.macro_factor * k_c, n), width, 0, col_c,
                            col_half, rng, live)[2].cpu().numpy()


def exact_macro(bundle: SurfelBundle, grid, width: int, s2w: Tensor,
                device="cuda", iters: int = ITERS) -> dict:
    """The macro level's exactness at the flagship tile (8x128 K=256,
    1,024-column sectors) on the full scan: the smallest power-of-two
    macro_factor from 4 up whose sectors truncate nothing while K_a < N
    keeps the level on; where none does, the soup thinned to every other
    surfel, and again.  There the macro level's index, valid and
    truncated must equal plain hier's.  Returns the shape ("factor",
    "surfels", "thinned"), "equal", and both binners' ms."""
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    w2s = transforms.invert_se3(s2w)
    plain = TileConfig(tile_h=8, tile_w=128, max_per_tile=256, binner="hier")
    thinned = 1
    with torch.no_grad():
        while True:
            b = SurfelBundle(*(x[::thinned] for x in bundle))
            args = (grid, width, w2s, b.means, b.scales, b.opacities)
            n = b.means.shape[0]
            k_c = plain.coarse_factor * plain.max_per_tile
            factor = 4
            if factor * k_c >= n:
                raise RuntimeError(f"no macro level at {n} surfels")
            while factor * k_c < n:
                cfg = TileConfig(tile_h=8, tile_w=128, max_per_tile=256,
                                 binner="hier", macro_cols=1024,
                                 macro_factor=factor)
                if macro_overflow(args, cfg, b.rotations).sum() == 0:
                    got, want = (bin_surfels(*args, c, rotations=b.rotations)
                                 for c in (cfg, plain))
                    return {
                        "factor": factor, "surfels": n, "thinned": thinned,
                        "equal": all(torch.equal(x, y)
                                     for x, y in zip(got, want)),
                        "ms": street.device_ms(lambda: bin_surfels(
                            *args, cfg, rotations=b.rotations), iters,
                            device),
                        "plain_ms": street.device_ms(lambda: bin_surfels(
                            *args, plain, rotations=b.rotations), iters,
                            device)}
                factor *= 2
            thinned *= 2


def lines(r: dict) -> list[str]:
    """The reference's lines, its labels and formats."""
    out = [f"footprint_bounds            {r['footprint_ms']:7.2f} ms"]
    for label, c in r.items():
        if label == "footprint_ms":
            continue
        cnt, trunc = c["counts"], c["truncated"]
        line = (f"{label:28s} {c['ms']:7.2f} ms   cand/tile mean "
                f"{cnt.mean():6.1f} p95 {np.percentile(cnt, 95):6.0f} max "
                f"{cnt.max():5d}   trunc tiles {int((trunc > 0).sum()):4d}"
                f" sum {int(trunc.sum()):7d}")
        m = c.get("macro_trunc", ())
        if m is None:
            line += "   macro level off (K_a >= N)"
        elif len(m):
            line += (f"   macro trunc sectors {int((m > 0).sum())}/{m.size}"
                     f" sum {int(m.sum())}")
        out.append(line)
    return out


def main(argv=None) -> dict:
    a = street.parser("profile_binner", __doc__).parse_args(argv)
    bundle, grid, width, s2w = street.setup(a)
    r = profile(bundle, grid, width, s2w, a.device)
    for line in lines(r):
        print(line, flush=True)
    return r


if __name__ == "__main__":
    main()
