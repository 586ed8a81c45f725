"""The cached training mode at `scripts/sweep_perf.py`'s two K=128 shapes,
4x128 and 8x64 (512 rays a tile; at 8x64 each warp of the card's kernels
holds half a tile row), held to the reference's own cached backward on
the CPU.

The scene is the bench's street soup of 8,192 surfels scanned at 16 x 512
from the probes' pose, the upstream gradient a seeded draw on all nine
channels, as `chip_smoke.py` phase 21 draws it.  The reference's side is
`pallas_tracer.trace` with `cache_fwd` on and off (its Pallas kernels in
interpret mode, float32 contractions); the port's is `ops.tracer.trace`
in the training mode (the twins on CPU tensors: the bf16 cache encoded and
decoded as the kernels do it, float32 sums) and replayed.  Bars: the port's
cached gradients within the reference's cache bars (1.5e-2 of each field's
largest magnitude, cosine > 0.999) of the reference's cached gradients,
and the port's worst field against its own replay no further than the
reference's worst field against its replay (measured here: the port
2.5e-3, the reference 8.9e-3, both on the opacities).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu.core import rays as j_rays
from lidar_rt_tpu.ops import pallas_tracer
from lidar_rt_tpu.ops.binning import TileConfig as JTileConfig
from lidar_rt_tpu.ops.composite import SurfelBundle as JSurfelBundle
from lidar_rt_tpu_torch.ops import tracer
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import street
from test_torch_cache import CACHE_ATOL, _cache_close

torch.set_num_threads(1)

H, W, N = 16, 512, 8192
FIELDS = ("means", "rotations", "scales", "opacities", "sh")
BG = np.float32([0.0, 0.0, 1.0])


def _gap(got: dict, want: dict) -> dict:
    """Per field: max |got - want| / max |want|."""
    return {f: float(np.abs(got[f].astype(np.float64) - want[f]).max()
                     / np.abs(want[f]).max()) for f in FIELDS}


@pytest.mark.parametrize("tile_h,tile_w", [(4, 128), (8, 64)])
def test_cached_decode_is_the_references(tile_h, tile_w):
    soup = street.street_soup(N, 0)
    upstream = np.random.default_rng(1).normal(
        size=(H, W, 9)).astype(np.float32)
    grid, s2w = street.sensor(H, "cpu")
    j_grid = j_rays.SensorGrid.from_bounds(H, street.INCLINATION_BOUNDS,
                                           pixel_offset=0.5)
    j_tile = JTileConfig(tile_h=tile_h, tile_w=tile_w, max_per_tile=128,
                         binner="hier", approx_topk=False)
    grads = {}
    for cached in (True, False):
        cfg = pallas_tracer.PallasTraceConfig(tile=j_tile, ray_block=512,
                                              cache_fwd=cached)
        g = jax.grad(lambda b: jnp.sum(pallas_tracer.trace(
            b, j_grid, W, jnp.asarray(s2w.numpy()), jnp.asarray(BG), 3,
            cfg).channels[..., :9] * upstream))(
                JSurfelBundle(**{k: jnp.asarray(v) for k, v in soup.items()}))
        grads[("ref", cached)] = {f: np.asarray(getattr(g, f))
                                  for f in FIELDS}
    tile = TileConfig(tile_h=tile_h, tile_w=tile_w, max_per_tile=128,
                      binner="hier")
    for cached in (True, False):
        b = SurfelBundle(**{k: torch.tensor(v, requires_grad=True)
                            for k, v in soup.items()})
        cfg = tracer.TraceConfig(tile=tile, fast_math=cached,
                                 cache_fwd=cached)
        assert cfg.use_cache == cached
        (tracer.trace(b, grid, W, s2w, torch.tensor(BG), 3, cfg)
         .channels[..., :9] * torch.tensor(upstream)).sum().backward()
        grads[("port", cached)] = {f: getattr(b, f).grad.numpy()
                                   for f in FIELDS}
    for f in FIELDS:
        _cache_close(grads[("port", True)][f], grads[("ref", True)][f], f)
    port_gap = _gap(grads[("port", True)], grads[("port", False)])
    ref_gap = _gap(grads[("ref", True)], grads[("ref", False)])
    assert 0.0 < max(port_gap.values()) <= max(ref_gap.values()) <= \
        CACHE_ATOL, (port_gap, ref_gap)
