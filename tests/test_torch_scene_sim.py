"""Port scene composition and re-simulation held to `lidar_rt_tpu` on the
same scene: `synthetic.generate` + `build.assemble_scene` with one actor,
carried across as named numpy arrays by `scene_from_numpy`.

Renders use the jax engine as the reference (exact top-k) at the Pallas
kernel's CPU parity bar, 2e-4 absolute.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu import sim as j_sim
from lidar_rt_tpu.config import default_experiment
from lidar_rt_tpu.core import rays as j_rays
from lidar_rt_tpu.data import build, synthetic
from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu.ops.binning import TileConfig as JTileConfig
from lidar_rt_tpu.scene import compose as j_compose
from lidar_rt_tpu_torch import sim as t_sim
from lidar_rt_tpu_torch.core import rays as t_rays
from lidar_rt_tpu_torch.ops import kernels
from lidar_rt_tpu_torch.ops import tracer as t_tracer
from lidar_rt_tpu_torch.ops.binning import TileConfig as TTileConfig
from lidar_rt_tpu_torch.scene import compose as t_compose
from lidar_rt_tpu_torch.scene import convert
from _torch_parity import scene_arrays

torch.set_num_threads(1)

ATOL = 2e-4
H, W = 16, 256
TILE = dict(tile_h=8, tile_w=128, max_per_tile=128, binner="hier")
J_CFG = j_tracer.TraceConfig(tile=JTileConfig(**TILE), tile_batch=2,
                             engine="jax")


@pytest.fixture(scope="module")
def j_scene():
    frames, track = synthetic.generate(num_frames=3, height=16, width=128)
    sc = build.assemble_scene(frames, [track], default_experiment(),
                              capacity_headroom=1.0)
    # Opaque enough to register returns, with view-dependent SH at degree 2
    # so the render exercises the basis and its degree mask.
    rng = np.random.default_rng(0)
    bg = sc.background
    bg = dataclasses.replace(
        bg, opacity_logit=jnp.where(bg.alive, 2.0, bg.opacity_logit),
        f_rest=jnp.asarray(rng.normal(scale=0.1, size=bg.f_rest.shape),
                           jnp.float32),
        active_sh_degree=jnp.asarray(2, jnp.int32))
    return dataclasses.replace(sc, background=bg)


@pytest.fixture(scope="module")
def t_scene(j_scene):
    return convert.scene_from_numpy(scene_arrays(j_scene), device="cpu")


def _close(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t_out), np.asarray(j_out),
                               atol=atol, rtol=0)


def _pose(x=0.0):
    p = np.eye(4, dtype=np.float32)
    p[:3, 3] = [x, 0.0, 2.0]
    return p


class TestScene:
    def test_activations(self, j_scene, t_scene):
        for part in ("background", "actors"):
            ja, ta = getattr(j_scene, part), getattr(t_scene, part)
            for prop in ("scales", "opacity", "rotation", "sh"):
                _close(getattr(ta, prop), getattr(ja, prop), atol=1e-6)
        assert t_scene.num_actors == 1 and t_scene.num_frames == 3
        assert t_scene.background.active_sh_degree == 2

    @pytest.mark.parametrize("frame,decomp", [
        (0, None), (2, None), (7, None), (1, "background"), (1, "object")])
    def test_compose(self, j_scene, t_scene, frame, decomp):
        jb, j_alive = j_compose(j_scene, jnp.asarray(frame, jnp.int32),
                                decomp)
        tb, t_alive = t_compose(t_scene, frame, decomp)
        np.testing.assert_array_equal(t_alive.numpy(), np.asarray(j_alive))
        for name in jb._fields:
            _close(getattr(tb, name), getattr(jb, name), atol=1e-5)

    def test_training_accessors(self, j_scene, t_scene):
        """extent, max_sh_degree, num_alive, params, total_capacity,
        one_up_sh_degree and split_by_asset as the reference's."""
        from lidar_rt_tpu.scene import split_by_asset as j_split
        from lidar_rt_tpu_torch.scene import split_by_asset as t_split

        for part in ("background", "actors"):
            ja, ta = getattr(j_scene, part), getattr(t_scene, part)
            assert ta.extent == pytest.approx(ja.extent, rel=1e-6)
            assert ta.max_sh_degree == ja.max_sh_degree == 3
            assert int(ta.num_alive) == int(ja.num_alive)
            jp, tp = ja.params(), ta.params()
            assert list(tp) == list(jp)
            for k in jp:
                np.testing.assert_array_equal(tp[k].numpy(),
                                              np.asarray(jp[k]))
            twice = ta.with_params({k: v * 2 for k, v in tp.items()})
            np.testing.assert_array_equal(twice.quat.numpy(),
                                          2 * np.asarray(ja.quat))
        assert t_scene.total_capacity == j_scene.total_capacity
        up = t_scene.one_up_sh_degree()
        j_up = j_scene.one_up_sh_degree().one_up_sh_degree()
        assert up.background.active_sh_degree == 3
        assert up.one_up_sh_degree().background.active_sh_degree == int(
            j_up.background.active_sh_degree) == 3
        flat = np.arange(j_scene.total_capacity, dtype=np.float32)
        for a, b in zip(t_split(t_scene, torch.tensor(flat)),
                        j_split(j_scene, jnp.asarray(flat)), strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_missing_arrays_and_static_scene(self, j_scene):
        arrays = scene_arrays(j_scene)
        static = {k: v for k, v in arrays.items()
                  if k.startswith("background.")}
        sc = convert.scene_from_numpy(static, device="cpu")
        assert sc.actors is None and sc.num_frames == 1
        del static["background.extent"], static["background.max_sh_degree"]
        bg = convert.scene_from_numpy(static, device="cpu").background
        assert (bg.extent, bg.max_sh_degree) == (200.0, 3)
        del arrays["tracks.quats"]
        with pytest.raises(KeyError, match="tracks.quats"):
            convert.scene_from_numpy(arrays, device="cpu")
        with pytest.raises(ValueError, match="decomp"):
            t_compose(sc, 0, "actors")


class TestSim:
    @pytest.mark.parametrize("engine", ["cuda", "torch"])
    def test_render_scan(self, j_scene, t_scene, engine):
        jg = j_rays.SensorGrid.from_bounds(H, (-0.42, 0.08))
        tg = t_rays.SensorGrid.from_bounds(H, (-0.42, 0.08), device="cpu")
        ref = j_sim.render_scan(j_scene, jg, W, _pose(), 1, J_CFG)
        kernels.forward_launches = 0
        out = t_sim.render_scan(
            t_scene, tg, W, torch.tensor(_pose()), 1,
            t_tracer.TraceConfig(tile=TTileConfig(**TILE), engine=engine))
        assert kernels.forward_launches == 0      # CPU: the plain twin
        assert float(np.asarray(ref["channels"])[..., 4].max()) > 0.5
        for key in ("depth", "intensity", "raydrop", "accum_weights",
                    "channels"):
            _close(out[key], ref[key])

    @pytest.mark.parametrize("mode", [{"exact_order": True},
                                      {"tail_passes": 1}],
                             ids=["exact", "tail"])
    def test_render_scan_modes(self, j_scene, t_scene, mode):
        """Exact order and tail passes reach the tracer through
        `render_scan` on both engines, as through the reference's.  (Both
        together are held at the trace level, on a scene without the
        range ties to rounding that this assembled scene holds.)"""
        jg = j_rays.SensorGrid.from_bounds(H, (-0.42, 0.08))
        tg = t_rays.SensorGrid.from_bounds(H, (-0.42, 0.08), device="cpu")
        ref = j_sim.render_scan(j_scene, jg, W, _pose(), 1,
                                dataclasses.replace(J_CFG, **mode))
        plain = j_sim.render_scan(j_scene, jg, W, _pose(), 1, J_CFG)
        assert np.abs(np.asarray(ref["channels"])
                      - np.asarray(plain["channels"])).max() > 1e-2
        for engine in ("cuda", "torch"):
            out = t_sim.render_scan(
                t_scene, tg, W, torch.tensor(_pose()), 1,
                t_tracer.TraceConfig(tile=TTileConfig(**TILE), engine=engine,
                                     **mode))
            for key in ("depth", "intensity", "raydrop", "accum_weights",
                        "channels"):
                _close(out[key], ref[key])

    def test_resimulate(self, j_scene, t_scene):
        """Each scan against the reference's eager `render_scan` at the
        same pose and frame.  (The reference's jitted `resimulate` is not
        the bar: on this scene it differs from its own eager render by up
        to 0.13 in intensity at one pixel, where the port agrees with the
        eager render to 1e-5.)"""
        jg = j_rays.SensorGrid.from_bounds(H, (-0.42, 0.08))
        tg = t_rays.SensorGrid.from_bounds(H, (-0.42, 0.08), device="cpu")
        poses = np.stack([_pose(x) for x in (0.0, 1.5, 3.0, 4.5)])
        out = t_sim.resimulate(
            t_scene, tg, W, torch.tensor(poses),
            cfg=t_tracer.TraceConfig(tile=TTileConfig(**TILE)))
        for key in ("depth", "intensity", "raydrop", "range_image"):
            assert out[key].shape == (4, H, W)
        for f, frame in enumerate((0, 1, 2, 2)):     # clamped to 3 frames
            ref = j_sim.render_scan(j_scene, jg, W, poses[f], frame, J_CFG)
            for key in ("depth", "intensity", "raydrop"):
                _close(out[key][f], ref[key])
            hit = np.asarray(ref["raydrop"]) < 0.4
            _close(out["range_image"][f], np.asarray(ref["depth"]) * hit)

    def test_rollout_drives_the_renderer(self, t_scene):
        tg = t_rays.SensorGrid.from_bounds(H, (-0.42, 0.08), device="cpu")
        cfg = t_tracer.TraceConfig(tile=TTileConfig(**TILE))

        def controller(scan, pose, step):
            speed = (scan["depth"][:, 60:68].median() * 0.05).clamp(0.1, 1.0)
            nxt = pose.clone()
            nxt[0, 3] += speed
            return nxt

        poses, scans = t_sim.rollout(t_scene, tg, W, torch.tensor(_pose()),
                                     controller, 3, cfg)
        assert poses.shape == (4, 4, 4) and len(scans["depth"]) == 3
        assert (poses[1:, 0, 3] > poses[:-1, 0, 3]).all()
        again = t_sim.render_scan(t_scene, tg, W, poses[2], 2, cfg)
        torch.testing.assert_close(scans["depth"][2], again["depth"])
