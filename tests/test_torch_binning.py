"""Port tile binning held to `lidar_rt_tpu.ops.binning` on the same numpy
inputs: footprint bounds to f32 rounding, and the topk / hier assignments
(index, valid, truncated) exactly.  The reference runs with exact top-k
(approx_topk=False), the port's only selection; inputs have no exact
range ties, so the nearest-first order is unique."""

import numpy as np
import pytest
import torch

from lidar_rt_tpu.core import rays as j_rays
from lidar_rt_tpu.core import transforms as j_tf
from lidar_rt_tpu.ops import binning as j_bin
from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu_torch.core import rays as t_rays
from lidar_rt_tpu_torch.ops import binning as t_bin
from lidar_rt_tpu_torch.ops import tracer as t_tracer
from lidar_rt_tpu_torch.ops.composite import SurfelBundle as TBundle

torch.set_num_threads(1)

H, W = 16, 256


def f32(x):
    return np.asarray(x, np.float32)


def _scene(n, seed):
    """Surfels around a sensor at (0, 0, 2): near ground + a wall band,
    some crossing the azimuth seam (behind the sensor, -x)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(4.0, 30.0, n)
    th = rng.uniform(-np.pi, np.pi, n)
    z = rng.uniform(-0.5, 4.0, n)
    means = f32(np.stack([r * np.cos(th), r * np.sin(th), z], 1))
    return dict(means=means,
                scales=f32(rng.uniform(0.1, 0.8, (n, 2))),
                opacities=f32(rng.uniform(0.0, 0.95, n)),
                rotations=f32(rng.normal(size=(n, 4))))


def _pose(seed):
    rng = np.random.default_rng(seed + 100)
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [rng.normal(), rng.normal(), 2.0]
    return m


def _grids():
    return (j_rays.SensorGrid.from_bounds(H, (-0.42, 0.08), pixel_offset=0.5),
            t_rays.SensorGrid.from_bounds(H, (-0.42, 0.08), pixel_offset=0.5,
                                          device="cpu"))


def _both(s, pose, oriented, min_range=None, **cfg):
    jg, tg = _grids()
    w2s = np.asarray(j_tf.invert_se3(pose))
    rot = s["rotations"] if oriented else None
    ja = j_bin.bin_surfels(jg, W, w2s, s["means"], s["scales"],
                           s["opacities"], j_bin.TileConfig(**cfg),
                           rotations=rot, min_range=min_range)
    ta = t_bin.bin_surfels(
        tg, W, torch.tensor(w2s), torch.tensor(s["means"]),
        torch.tensor(s["scales"]), torch.tensor(s["opacities"]),
        t_bin.TileConfig(**cfg),
        rotations=None if rot is None else torch.tensor(rot),
        min_range=None if min_range is None else torch.tensor(min_range))
    return ja, ta


def _assert_same(ja, ta):
    np.testing.assert_array_equal(ta.valid.numpy(), np.asarray(ja.valid))
    np.testing.assert_array_equal(ta.index.numpy(), np.asarray(ja.index))
    np.testing.assert_array_equal(ta.truncated.numpy(),
                                  np.asarray(ja.truncated))


N = 300   # one surfel count keeps the reference's compiled shapes few
CASES = [
    # (binner, tile_h, tile_w, K, extra config)
    ("topk", 8, 128, 128, {}),
    ("topk", 8, 64, 64, {"int_overlap": False}),
    ("hier", 8, 128, 128, {}),
    ("hier", 8, 128, 256, {"coarse_factor": 1}),
    ("hier", 4, 64, 32, {"coarse_factor": 2, "pad_px": 2.0,
                         "snap_pad_px": 0.5}),
    ("hier", 8, 128, 128, {"int_overlap": False, "sample_snap": False}),
]


class TestBinSurfels:
    @pytest.mark.parametrize("binner,th,tw,k,extra", CASES)
    @pytest.mark.parametrize("oriented", [True, False])
    def test_matches_reference(self, binner, th, tw, k, extra, oriented):
        s = _scene(N, seed=k + th)
        ja, ta = _both(s, _pose(k), oriented, binner=binner, tile_h=th,
                       tile_w=tw, max_per_tile=k, **extra)
        _assert_same(ja, ta)
        assert ta.valid.any()
        # valid is a prefix of each row, the sentinel index is N
        v = ta.valid.numpy()
        assert (np.diff(v.astype(int), axis=1) <= 0).all()
        assert (ta.index.numpy()[~v] == N).all()

    def test_truncation_counted(self):
        s = _scene(N, seed=7)
        ja, ta = _both(s, _pose(0), True, binner="hier", tile_h=8,
                       tile_w=128, max_per_tile=8, coarse_factor=2)
        _assert_same(ja, ta)
        assert int(ta.truncated.sum()) > 0


class TestMinRange:
    @pytest.mark.parametrize("binner,extra", [
        ("topk", {}), ("hier", {}), ("hier", {"coarse_factor": 2})])
    def test_matches_reference(self, binner, extra):
        """Per-tile strict range floors (some +inf, some -inf), exactly."""
        s = _scene(N, seed=21)
        tiles = 2 * (W // 128)
        rng = np.random.default_rng(21)
        min_range = f32(rng.uniform(4.0, 30.0, tiles))
        min_range[0], min_range[-1] = np.inf, -np.inf
        ja, ta = _both(s, _pose(21), True, min_range=min_range,
                       binner=binner, tile_h=8, tile_w=128, max_per_tile=16,
                       **extra)
        _assert_same(ja, ta)
        assert ta.valid.any() and not ta.valid[0].any()
        rng_c = t_bin.sensor_points(
            torch.linalg.inv(torch.tensor(_pose(21))),
            torch.tensor(s["means"]))[3][ta.index.clamp_max(N - 1)]
        assert bool((rng_c > torch.tensor(min_range)[:, None])[ta.valid]
                    .all())

    @pytest.mark.parametrize("binner", ["topk", "hier"])
    def test_tail_chain_matches_reference(self, binner):
        """`bin_tail_chain`: three disjoint passes, each past the previous
        pass's K-th candidate per truncated tile.  Each pass equals the
        reference's binner at the same range floors exactly, and the
        floors equal the reference's `_tile_range_cutoff` to one ulp: the
        reference takes the cutoff's range through a matmul, which can
        round one ulp below its binner's range and list the K-th
        candidate again in the next pass; the port takes the binner's
        own range, so its passes stay disjoint."""
        s = _scene(N, seed=22)
        sh = np.zeros((N, 16, 3), np.float32)
        pose = _pose(22)
        w2s = np.asarray(j_tf.invert_se3(pose))
        jg, tg = _grids()
        kw = dict(binner=binner, tile_h=8, tile_w=128, max_per_tile=16)
        t_chain = t_tracer.bin_tail_chain(
            TBundle(**{k: torch.tensor(v) for k, v in s.items()},
                    sh=torch.tensor(sh)),
            tg, W, torch.tensor(w2s), t_bin.TileConfig(**kw), 2)
        assert len(t_chain) == 3
        floor = None
        for ta in t_chain:
            ja = j_bin.bin_surfels(jg, W, w2s, s["means"], s["scales"],
                                   s["opacities"], j_bin.TileConfig(**kw),
                                   rotations=s["rotations"],
                                   min_range=floor)
            _assert_same(ja, ta)
            cut = t_tracer._tile_range_cutoff(ta, torch.tensor(s["means"]),
                                              torch.tensor(w2s)).numpy()
            np.testing.assert_allclose(
                cut, np.asarray(j_tracer._tile_range_cutoff(
                    ja, s["means"], w2s)), rtol=1e-6)
            floor = cut if floor is None else np.maximum(cut, floor)
        assert t_chain[2].valid.any()
        for t in range(t_chain[0].index.shape[0]):
            seen = [set(a.index[t][a.valid[t]].tolist()) for a in t_chain]
            assert not (seen[0] & seen[1]) and not (seen[1] & seen[2])


class TestFootprint:
    @pytest.mark.parametrize("oriented", [True, False])
    def test_bounds_match(self, oriented):
        s = _scene(N, seed=3)
        pose = _pose(3)
        w2s = np.asarray(j_tf.invert_se3(pose))
        cfg = dict(pad_px=1.0, snap_pad_px=0.5)
        jg = j_rays.SensorGrid.from_bounds(H, (-0.42, 0.08))
        tg = t_rays.SensorGrid.from_bounds(H, (-0.42, 0.08), device="cpu")
        rot = s["rotations"] if oriented else None
        jb = j_bin.footprint_bounds(jg, W, w2s, s["means"], s["scales"],
                                    s["opacities"], j_bin.TileConfig(**cfg),
                                    rot)
        tb = t_bin.footprint_bounds(
            tg, W, torch.tensor(w2s), torch.tensor(s["means"]),
            torch.tensor(s["scales"]), torch.tensor(s["opacities"]),
            t_bin.TileConfig(**cfg),
            None if rot is None else torch.tensor(rot))
        for t_x, j_x in zip(tb[:-1], jb[:-1]):
            np.testing.assert_allclose(t_x.numpy(), np.asarray(j_x),
                                       atol=1e-4, rtol=1e-5)
        np.testing.assert_array_equal(tb[-1].numpy(), np.asarray(jb[-1]))
        np.testing.assert_allclose(
            t_bin.cutoff_radius(torch.tensor(s["scales"]),
                                torch.tensor(s["opacities"]), 0.01).numpy(),
            np.asarray(j_bin.cutoff_radius(s["scales"], s["opacities"],
                                           0.01)), rtol=1e-6)


class TestTileConfig:
    def test_rejects_what_the_port_lacks(self):
        with pytest.raises(ValueError, match="binner"):
            t_bin.TileConfig(binner="radix")
        with pytest.raises(ValueError, match="int_eps"):
            t_bin.TileConfig(int_eps=0.75)
        assert t_bin.TileConfig(tile_h=8, tile_w=128).num_tiles(64, 2650) \
            == (8, 21)
