"""Port core math and tracer geometry held to `lidar_rt_tpu` on the same
numpy inputs: quaternions, transforms, SH, rays, geometry, the dense
oracle.  Tolerance 1e-6 absolute plus 1e-5 relative (f32 math in another
operation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu.core import quaternions as j_quat
from lidar_rt_tpu.core import rays as j_rays
from lidar_rt_tpu.core import sh as j_sh
from lidar_rt_tpu.core import transforms as j_tf
from lidar_rt_tpu.ops import composite as j_comp
from lidar_rt_tpu.ops import geometry as j_geo
from lidar_rt_tpu_torch.core import quaternions as t_quat
from lidar_rt_tpu_torch.core import rays as t_rays
from lidar_rt_tpu_torch.core import sh as t_sh
from lidar_rt_tpu_torch.core import transforms as t_tf
from lidar_rt_tpu_torch.ops import composite as t_comp
from lidar_rt_tpu_torch.ops import geometry as t_geo

torch.set_num_threads(1)

ATOL, RTOL = 1e-6, 1e-5


def f32(x):
    return np.asarray(x, np.float32)


def close(t_out, j_out, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(t_out), np.asarray(j_out),
                               atol=atol, rtol=rtol)


def _pose(rng):
    q = rng.normal(size=4)
    r = np.asarray(j_quat.to_rotation_matrix(jnp.asarray(f32(q))))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r
    m[:3, 3] = rng.normal(scale=5.0, size=3)
    return m


class TestQuaternionsTransforms:
    def test_normalize_multiply_rotation(self):
        rng = np.random.default_rng(0)
        a, b = f32(rng.normal(size=(64, 4))), f32(rng.normal(size=(64, 4)))
        close(t_quat.normalize(torch.tensor(a)), j_quat.normalize(a))
        close(t_quat.multiply(torch.tensor(a), torch.tensor(b)),
              j_quat.multiply(a, b))
        close(t_quat.to_rotation_matrix(torch.tensor(a)),
              j_quat.to_rotation_matrix(a))

    def test_se3_and_inverse(self):
        rng = np.random.default_rng(1)
        m = np.stack([_pose(rng) for _ in range(5)])
        close(t_tf.se3(torch.tensor(m[:, :3, :3]), torch.tensor(m[:, :3, 3])),
              j_tf.se3(m[:, :3, :3], m[:, :3, 3]))
        inv = t_tf.invert_se3(torch.tensor(m))
        close(inv, j_tf.invert_se3(m))
        close(inv @ torch.tensor(m), np.broadcast_to(np.eye(4), m.shape),
              atol=1e-5)


class TestSH:
    @pytest.mark.parametrize("degree", [0, 1, 2, 3])
    def test_basis_and_evaluate(self, degree):
        rng = np.random.default_rng(degree)
        dirs = f32(rng.normal(size=(50, 3)))
        coeffs = f32(rng.normal(size=(50, 16, 3)))
        close(t_sh.basis(torch.tensor(dirs), degree),
              j_sh.basis(dirs, degree))
        close(t_sh.evaluate(torch.tensor(coeffs), torch.tensor(dirs), degree),
              j_sh.evaluate(coeffs, dirs, degree))
        np.testing.assert_array_equal(t_sh._DEGREE_OF_COEFF,
                                      j_sh._DEGREE_OF_COEFF)


class TestRays:
    GRIDS = [
        ("bounds", (16, (-0.42, 0.08), 0.0, 0.0)),
        ("bounds", (16, (-0.31, 0.04), 0.5, 0.1)),
        ("beams", (np.linspace(-0.4, 0.05, 12), 0.5, 0.0)),
    ]

    def _grids(self, kind, args):
        if kind == "bounds":
            return (t_rays.SensorGrid.from_bounds(*args),
                    j_rays.SensorGrid.from_bounds(*args))
        beams, off, ang = args
        return (t_rays.SensorGrid.from_beams(f32(beams), off, ang),
                j_rays.SensorGrid.from_beams(f32(beams), off, ang))

    @pytest.mark.parametrize("kind,args", GRIDS)
    def test_grid_and_pixel_mapping(self, kind, args):
        tg, jg = self._grids(kind, args)
        np.testing.assert_array_equal(tg.row_inclinations.numpy(),
                                      np.asarray(jg.row_inclinations))
        width = 256
        cols = f32(np.linspace(-3.0, width + 3.0, 101))
        close(t_rays.azimuth_of_col(tg, torch.tensor(cols), width),
              j_rays.azimuth_of_col(jg, cols, width))
        az = f32(np.linspace(-7.0, 7.0, 101))
        close(t_rays.col_of_azimuth(tg, torch.tensor(az), width),
              j_rays.col_of_azimuth(jg, az, width))
        # Inside the table and extrapolated past both edges.
        rows = np.asarray(jg.row_inclinations)
        incl = f32(np.linspace(rows.min() - 0.2, rows.max() + 0.2, 301))
        close(t_rays.row_of_inclination(tg, torch.tensor(incl)),
              j_rays.row_of_inclination(jg, incl))

    @pytest.mark.parametrize("kind,args", GRIDS)
    def test_sensor_dirs_and_range_rays(self, kind, args):
        tg, jg = self._grids(kind, args)
        close(t_rays.sensor_dirs(tg, 200), j_rays.sensor_dirs(jg, 200))
        pose = _pose(np.random.default_rng(3))
        o_t, d_t = t_rays.range_rays(tg, 200, torch.tensor(pose))
        o_j, d_j = j_rays.range_rays(jg, 200, pose)
        close(o_t, o_j)
        close(d_t, d_j)


def _surfels(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        means=f32(rng.normal(scale=3.0, size=(n, 3)) + np.array([10, 0, 0])),
        rotations=f32(rng.normal(size=(n, 4))),
        scales=f32(rng.uniform(0.3, 0.9, (n, 2))),
        opacities=f32(rng.uniform(0.3, 0.95, n)),
        sh=f32(rng.normal(scale=0.3, size=(n, 16, 3))))


def _dirs(r=64, seed=1):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(r, 3)) * np.array([1.0, 0.15, 0.15]) + [1, 0, 0]
    return f32(d / np.linalg.norm(d, axis=-1, keepdims=True))


class TestGeometry:
    def test_frames_and_intersect(self):
        s = _surfels()
        origin = f32([0.3, -0.2, 1.0])
        rot = j_quat.to_rotation_matrix(s["rotations"])
        jf = j_geo.build_frames(s["means"], rot, origin)
        tf = t_geo.build_frames(torch.tensor(s["means"]),
                                torch.tensor(np.asarray(rot)),
                                torch.tensor(origin))
        for name in j_geo.SurfelFrames._fields:
            close(getattr(tf, name), getattr(jf, name))
        dirs = _dirs()
        jh = j_geo.intersect(jf, s["scales"], s["opacities"], dirs)
        th = t_geo.intersect(
            t_geo.SurfelFrames(*(torch.tensor(np.asarray(x)) for x in jf)),
            torch.tensor(s["scales"]), torch.tensor(s["opacities"]),
            torch.tensor(dirs))
        np.testing.assert_array_equal(th.valid.numpy(), np.asarray(jh.valid))
        assert th.valid.any()
        close(th.alpha, jh.alpha)
        close(torch.where(th.valid, th.t, 0.0),
              np.where(jh.valid, jh.t, 0.0))

    @pytest.mark.parametrize("with_t0", [False, True])
    def test_composite_weights(self, with_t0):
        rng = np.random.default_rng(4)
        alpha = f32(rng.uniform(0, 0.99, (32, 24)) * (rng.random((32, 24))
                                                     < 0.6))
        t0 = f32(rng.uniform(1e-3, 1.0, 32)) if with_t0 else None
        w_t, ft_t = t_geo.composite_weights(
            torch.tensor(alpha), None if t0 is None else torch.tensor(t0))
        w_j, ft_j = j_geo.composite_weights(alpha, init_trans=t0)
        close(w_t, w_j)
        close(ft_t, ft_j)


class TestDenseOracle:
    @pytest.mark.parametrize("order", ["ray_t", "given"])
    @pytest.mark.parametrize("degree", [1, 3])
    def test_render_dense(self, order, degree):
        s = _surfels(seed=degree)
        dirs = _dirs(seed=degree + 1)
        origin, bg = f32([0.0, 0.0, 0.5]), f32([0.0, 0.0, 1.0])
        jo = j_comp.render_dense(j_comp.SurfelBundle(**s), origin, dirs, bg,
                                 degree, order)
        to = t_comp.render_dense(
            t_comp.SurfelBundle(**{k: torch.tensor(v) for k, v in s.items()}),
            torch.tensor(origin), torch.tensor(dirs), torch.tensor(bg),
            degree, order)
        assert float(np.asarray(jo.channels)[:, 4].max()) > 0.1
        close(to.channels, jo.channels)
        close(to.accum_weights, jo.accum_weights)
        close(t_comp.shade(torch.tensor(s["sh"]), torch.tensor(dirs), degree),
              j_comp.shade(s["sh"], dirs, degree))
