"""Column bands of the port's render path held to `lidar_rt_tpu`: band
binning (topk, hier and the sort binner) and band tracing in tile and
exact order and with a tail pass, the unit of ray sharding
(`lidar_rt_tpu_torch.parallel`, tests/test_torch_parallel.py).

The reference runs with its jax engine and exact top-k.  Bars: binning
exactly; channels and accum 2e-4; gradients 3e-3 after scaling by the
reference's largest magnitude.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu.core import rays as j_rays
from lidar_rt_tpu.core import transforms as j_tf
from lidar_rt_tpu.ops import binning as j_bin
from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu.ops.composite import SurfelBundle as JBundle
from lidar_rt_tpu_torch.core import rays as t_rays
from lidar_rt_tpu_torch.ops import binning as t_bin
from lidar_rt_tpu_torch.ops import kernels
from lidar_rt_tpu_torch.ops import tracer as t_tracer
from lidar_rt_tpu_torch.ops.composite import SurfelBundle as TBundle
from lidar_rt_tpu_torch.train import options

torch.set_num_threads(1)

ATOL = 2e-4
H, W = 16, 256


def f32(x):
    return np.asarray(x, np.float32)


def _close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0, err_msg=msg)


def _grad_close(got, want, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=3e-3,
                               err_msg=msg)


# -- binning ---------------------------------------------------------------


def _bin_scene(n, seed):
    """Surfels all around a sensor at (0, 0, 2), some across the seam."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(4.0, 30.0, n)
    th = rng.uniform(-np.pi, np.pi, n)
    z = rng.uniform(-0.5, 4.0, n)
    return dict(means=f32(np.stack([r * np.cos(th), r * np.sin(th), z], 1)),
                scales=f32(rng.uniform(0.1, 0.8, (n, 2))),
                opacities=f32(rng.uniform(0.0, 0.95, n)),
                rotations=f32(rng.normal(size=(n, 4))))


def _bin_both(s, cfg, col_offset, num_cols, min_range=None):
    jg = j_rays.SensorGrid.from_bounds(H, (-0.42, 0.08), pixel_offset=0.5)
    tg = t_rays.SensorGrid.from_bounds(H, (-0.42, 0.08), pixel_offset=0.5,
                                       device="cpu")
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.3, -0.2, 2.0]
    w2s = np.asarray(j_tf.invert_se3(pose))
    ja = j_bin.bin_surfels(jg, W, w2s, s["means"], s["scales"],
                           s["opacities"], j_bin.TileConfig(**cfg),
                           col_offset=col_offset, num_cols=num_cols,
                           rotations=s["rotations"], min_range=min_range)
    ta = t_bin.bin_surfels(
        tg, W, torch.tensor(w2s), torch.tensor(s["means"]),
        torch.tensor(s["scales"]), torch.tensor(s["opacities"]),
        t_bin.TileConfig(**cfg), rotations=torch.tensor(s["rotations"]),
        min_range=None if min_range is None else torch.tensor(min_range),
        col_offset=col_offset, num_cols=num_cols)
    return ja, ta


def _assert_same(ja, ta):
    for f in ("valid", "index", "truncated"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), f)


# Every band of rays = 2 and 4, a band across the seam, and a band whose
# width is no multiple of the tile width.
BANDS = [(r * W // n, W // n) for n in (2, 4) for r in range(n)] \
    + [(200, 96), (64, 80)]


class TestBandBinning:
    @pytest.mark.parametrize("binner,extra", [
        ("topk", {}), ("hier", {"coarse_factor": 2}),
        ("topk", {"int_overlap": False}), ("sort", {})])
    def test_every_band_matches_reference(self, binner, extra):
        s = _bin_scene(300, seed=5)
        cfg = dict(binner=binner, tile_h=8, tile_w=32, max_per_tile=32,
                   **extra)
        listed = 0
        for col_offset, num_cols in BANDS:
            ja, ta = _bin_both(s, cfg, col_offset, num_cols)
            _assert_same(ja, ta)
            assert ta.index.shape == (2 * -(-num_cols // 32), 32)
            listed += int(ta.valid.sum())
        assert listed > 0

    @pytest.mark.parametrize("col_offset,num_cols", [(0, None), (64, 128),
                                                     (200, 96)])
    @pytest.mark.parametrize("with_min_range", [False, True])
    @pytest.mark.parametrize("int_overlap", [True, False])
    def test_sort_binner_matches_reference(self, col_offset, num_cols,
                                           with_min_range, int_overlap):
        """The sort binner, whole raster and banded, with per-tile range
        floors (+inf on some tiles, none on others), held to the
        reference's sort binner: its key quantizes range, so its lists
        differ from topk's by design."""
        s = _bin_scene(400, seed=6)
        cfg = dict(binner="sort", tile_h=8, tile_w=32, max_per_tile=16,
                   dup_cols=6, int_overlap=int_overlap)
        min_range = None
        if with_min_range:
            t = 2 * -(-(num_cols or W) // 32)
            rng = np.random.default_rng(1)
            min_range = f32(rng.uniform(0.0, 20.0, t))
            min_range[::3] = np.inf
        ja, ta = _bin_both(s, cfg, col_offset, num_cols, min_range)
        _assert_same(ja, ta)
        assert int(ta.truncated.sum()) > 0 and bool(ta.valid.any())

    def test_sort_binner_config(self):
        """TileConfig and the trainer's options take "sort"; an unknown
        binner is refused."""
        ns = options.experiment_options()
        ns.tracer = SimpleNamespace(binner="sort", max_per_tile=64)
        cfg, _, _ = options.trace_configs(ns)
        assert cfg.tile.binner == "sort"
        with pytest.raises(ValueError, match="binner"):
            t_bin.TileConfig(binner="radix")


# -- band tracing ----------------------------------------------------------


def _surfels(n, seed):
    rng = np.random.default_rng(seed)
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0, :] = rng.uniform(-0.5, 1.0, size=(n, 3))
    sh[:, 1:9, :] = rng.normal(scale=0.15, size=(n, 8, 3))
    th = rng.uniform(-np.pi, np.pi, n)
    r = rng.uniform(6.0, 16.0, n)
    means = np.stack([r * np.cos(th), r * np.sin(th),
                      rng.normal(scale=1.0, size=n)], 1)
    return dict(means=f32(means), rotations=f32(rng.normal(size=(n, 4))),
                scales=f32(rng.uniform(0.2, 0.6, (n, 2))),
                opacities=f32(rng.uniform(0.4, 0.95, n)), sh=sh)


POSE = np.eye(4, dtype=np.float32)
POSE[:3, 3] = [0.4, -0.3, 0.2]
BG = f32([0.0, 0.0, 1.0])
GRID = dict(height=H, bounds=(-0.3, 0.1))


def _trace_cfgs(tw, k=64, **kw):
    tile = dict(tile_h=8, tile_w=tw, max_per_tile=k)
    return (j_tracer.TraceConfig(tile=j_bin.TileConfig(**tile), tile_batch=2,
                                 engine="jax", **kw),
            t_tracer.TraceConfig(tile=t_bin.TileConfig(**tile), **kw))


def _band_renders(s, j_cfg, t_cfg, col_offset, width):
    """Both packages' band render of `s` and their gradients of one loss
    on the band's channels.  The reference renders eagerly (its jitted
    render can flip a gate at single pixels, ROADMAP.md §C); its gradient
    is jitted with the band offset traced (as its sharded trace has it),
    so bands of one width compile once."""
    jb = JBundle(**{k: jnp.asarray(v) for k, v in s.items()})
    ref = j_tracer.trace(jb, j_rays.SensorGrid.from_bounds(H, GRID["bounds"]),
                         W, POSE, BG, 3, j_cfg, col_offset=col_offset,
                         render_width=width)
    j_grads = _j_band_grad(j_cfg, width)(jb, jnp.int32(col_offset))
    tg = t_rays.SensorGrid.from_bounds(H, GRID["bounds"], device="cpu")
    tb = TBundle(**{k: torch.tensor(v).requires_grad_()
                    for k, v in s.items()})
    out = t_tracer.trace(tb, tg, W, torch.tensor(POSE), torch.tensor(BG), 3,
                         t_cfg, col_offset=col_offset, render_width=width)
    ((out.channels[..., 3] ** 2).sum() * 1e-3
     + out.channels[..., 0].sum()).backward()
    return ref, j_grads, out, tb


@functools.cache
def _j_band_grad(j_cfg, width):
    grid = j_rays.SensorGrid.from_bounds(H, GRID["bounds"])

    def loss(b, col_offset):
        out = j_tracer.trace(b, grid, W, POSE, BG, 3, j_cfg,
                             col_offset=col_offset, render_width=width)
        return (jnp.sum(out.channels[..., 3] ** 2) * 1e-3
                + jnp.sum(out.channels[..., 0]))

    return jax.jit(jax.grad(loss))


class TestBandTrace:
    @pytest.mark.parametrize("exact", [False, True])
    def test_bands_match_reference(self, exact):
        """Every band of rays = 2 and 4 and a band across the seam, in
        tiles 48 columns wide, so that each band's last tile reaches into
        the next band: channels, accum and gradients against the
        reference's band `trace`."""
        s = _surfels(500, seed=3)
        j_cfg, t_cfg = _trace_cfgs(48, exact_order=exact)
        kernels.reset_launches()
        for col_offset, width in BANDS[:6] + [(224, 64)]:
            ref, j_grads, out, tb = _band_renders(s, j_cfg, t_cfg,
                                                  col_offset, width)
            assert out.channels.shape == (H, width, 9)
            msg = f"band ({col_offset}, {width})"
            _close(out.channels.detach(), ref.channels, msg=msg)
            _close(out.accum_weights.detach(), ref.accum_weights, msg=msg)
            for name in ("means", "rotations", "scales", "opacities", "sh"):
                _grad_close(getattr(tb, name).grad,
                            getattr(j_grads, name), f"{msg} {name}")
        assert kernels.forward_launches == kernels.backward_launches == 0

    def test_bands_tile_the_scan(self):
        """Bands whose offsets and widths are whole tiles trace the same
        tiles as the whole scan: their channels are its columns, their
        accums sum to its accum."""
        s = _surfels(500, seed=4)
        _, t_cfg = _trace_cfgs(32)
        tg = t_rays.SensorGrid.from_bounds(H, GRID["bounds"], device="cpu")
        args = (TBundle(**{k: torch.tensor(v) for k, v in s.items()}), tg, W,
                torch.tensor(POSE), torch.tensor(BG), 3, t_cfg)
        whole = t_tracer.trace(*args)
        bands = [t_tracer.trace(*args, col_offset=c, render_width=W // 4)
                 for c in range(0, W, W // 4)]
        torch.testing.assert_close(
            torch.cat([b.channels for b in bands], 1), whole.channels,
            rtol=0, atol=0)
        torch.testing.assert_close(sum(b.accum_weights for b in bands),
                                   whole.accum_weights, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("exact", [False, True])
    def test_tail_pass_bands(self, exact):
        """One tail pass on a case whose K = 32 budget truncates.  Band 0
        against the reference's band `trace`; every band of rays = 4
        against the reference's whole-scan tail render, cropped (the bands
        are whole tiles, so each tile lists the same candidates), and the
        bands' accums against its accum.  (The reference's band tail pass
        indexes its band's carried transmittance by scan column, so it is
        held to that at band 0 only; ROADMAP.md §C.)"""
        s = _surfels(900, seed=13)
        j_cfg, t_cfg = _trace_cfgs(32, k=32, exact_order=exact,
                                   tail_passes=1)
        ref0, j_grads, out0, tb = _band_renders(s, j_cfg, t_cfg, 0, W // 4)
        _close(out0.channels.detach(), ref0.channels)
        _close(out0.accum_weights.detach(), ref0.accum_weights)
        for name in ("means", "scales", "opacities", "sh"):
            _grad_close(getattr(tb, name).grad, getattr(j_grads, name),
                        name)
        jg = j_rays.SensorGrid.from_bounds(H, GRID["bounds"])
        whole = j_tracer.trace(JBundle(**{k: jnp.asarray(v)
                                          for k, v in s.items()}),
                               jg, W, POSE, BG, 3, j_cfg)
        tg = t_rays.SensorGrid.from_bounds(H, GRID["bounds"], device="cpu")
        tbundle = TBundle(**{k: torch.tensor(v) for k, v in s.items()})
        accum = 0.0
        for c in range(0, W, W // 4):
            band = t_tracer.trace(tbundle, tg, W, torch.tensor(POSE),
                                  torch.tensor(BG), 3, t_cfg, col_offset=c,
                                  render_width=W // 4)
            _close(band.channels, np.asarray(whole.channels)[:, c:c + W // 4],
                   msg=f"band at {c}")
            accum = accum + band.accum_weights
        _close(accum, whole.accum_weights)
        assert float(np.asarray(whole.channels)[..., 4].max()) > 0.5


