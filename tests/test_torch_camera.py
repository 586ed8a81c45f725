"""The port's remaining small modules held to `lidar_rt_tpu` on the same
numpy inputs: the pinhole camera and its debug render (`core.camera`), the
camera transforms (`core.transforms.world_to_view`, `projection_matrix`),
`core.sh.sh_to_rgb`, `train.losses.binary_focal` and
`core.quaternions.rotation_matrix_vjp`.

Bars: plain math 1e-6 absolute + 1e-5 relative; renders 2e-4 absolute
(the tracer's CPU bar).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu.core import camera as j_camera
from lidar_rt_tpu.core import quaternions as j_quat
from lidar_rt_tpu.core import sh as j_sh
from lidar_rt_tpu.core import transforms as j_transforms
from lidar_rt_tpu.ops.composite import SurfelBundle as JBundle
from lidar_rt_tpu.train import losses as j_losses
from lidar_rt_tpu_torch.core import camera as t_camera
from lidar_rt_tpu_torch.core import quaternions as t_quat
from lidar_rt_tpu_torch.core import sh as t_sh
from lidar_rt_tpu_torch.core import transforms as t_transforms
from lidar_rt_tpu_torch.ops.composite import SurfelBundle as TBundle
from lidar_rt_tpu_torch.train import losses as t_losses

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
RENDER_ATOL = 2e-4


def f32(x):
    return np.asarray(x, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _rotation(seed):
    q = np.random.default_rng(seed).normal(size=4)
    return np.asarray(j_quat.to_rotation_matrix(jnp.asarray(f32(q))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_camera_transforms_match_reference(seed):
    rng = np.random.default_rng(seed)
    r, t = _rotation(seed), f32(rng.normal(size=3) * 4.0)
    translate, scale = f32(rng.normal(size=3)), float(rng.uniform(0.5, 2.0))
    got = t_transforms.world_to_view(r, t, translate, scale)
    want = j_transforms.world_to_view(r, t, translate, scale)
    assert got.dtype == np.float32 and got.shape == (4, 4)
    _close(got, want)
    znear, zfar = float(rng.uniform(0.01, 1.0)), float(rng.uniform(50, 500))
    fovx, fovy = rng.uniform(0.3, 1.5, 2)
    _close(t_transforms.projection_matrix(znear, zfar, fovx, fovy),
           j_transforms.projection_matrix(znear, zfar, fovx, fovy))


def test_sh_to_rgb_matches_reference():
    x = f32(np.random.default_rng(3).normal(size=(7, 16, 3)))
    got = t_sh.sh_to_rgb(torch.tensor(x))
    _close(got, j_sh.sh_to_rgb(jnp.asarray(x)))
    _close(t_sh.rgb_to_sh(got), x, atol=1e-5)


@pytest.mark.parametrize("alpha,gamma", [(0.25, 2.0), (0.5, 1.0),
                                         (0.1, 3.0)])
def test_binary_focal_matches_reference(alpha, gamma):
    rng = np.random.default_rng(int(gamma * 10))
    preds = f32(rng.uniform(0.0, 1.0, (24, 40)))
    preds[0, :4] = [0.0, 1.0, 1e-7, 1.0 - 1e-7]
    labels = rng.uniform(size=(24, 40)) > 0.6
    got = t_losses.binary_focal(torch.tensor(preds), torch.tensor(labels),
                                alpha, gamma)
    want = j_losses.binary_focal(jnp.asarray(preds), jnp.asarray(labels),
                                 alpha, gamma)
    _close(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_rotation_matrix_vjp_matches_reference(seed):
    """At unnormalised quaternions, against the reference's jax.vjp and
    torch autograd of the closed form."""
    rng = np.random.default_rng(seed)
    q = f32(rng.normal(size=(9, 4)) * 2.0)
    g = f32(rng.normal(size=(9, 3, 3)))
    got = t_quat.rotation_matrix_vjp(torch.tensor(q), torch.tensor(g))
    _close(got, j_quat.rotation_matrix_vjp(jnp.asarray(q), jnp.asarray(g)))
    leaf = torch.tensor(q, requires_grad=True)
    (t_quat.to_rotation_matrix(leaf) * torch.tensor(g)).sum().backward()
    _close(got, leaf.grad)


def _frontal_wall():
    """The reference's frontal-plane case (tests/test_core_math.py): an
    opaque wall of 25 surfels at z = 5 before a camera at the origin."""
    n = 25
    gx = np.linspace(-2, 2, 5)
    xx, yy = np.meshgrid(gx, gx)
    means = f32(np.stack([xx.ravel(), yy.ravel(), np.full(n, 5.0)], 1))
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0] = 0.5
    arrays = dict(means=means,
                  rotations=np.tile(f32([1.0, 0, 0, 0]), (n, 1)),
                  scales=np.full((n, 2), 1.0, np.float32),
                  opacities=np.full(n, 0.99, np.float32), sh=sh)
    cam = dict(image_height=16, image_width=16, fovx=0.6, fovy=0.6,
               r=np.eye(3), t=np.zeros(3))
    return arrays, cam, 0


def _random_scene():
    """64 random surfels before a rotated, translated camera."""
    rng = np.random.default_rng(7)
    n = 64
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0] = rng.uniform(-0.5, 1.0, (n, 3))
    sh[:, 1:9] = rng.normal(scale=0.15, size=(n, 8, 3))
    r = _rotation(11)
    center = f32([0.5, -0.3, 0.2])
    fwd = r.T @ f32([0.0, 0.0, 1.0])          # the camera's optical axis
    means = center + fwd * rng.uniform(3.0, 8.0, (n, 1)) + rng.normal(
        scale=1.0, size=(n, 3))
    arrays = dict(means=f32(means), rotations=f32(rng.normal(size=(n, 4))),
                  scales=f32(rng.uniform(0.2, 0.8, (n, 2))),
                  opacities=f32(rng.uniform(0.3, 0.95, n)), sh=sh)
    cam = dict(image_height=20, image_width=28, fovx=1.0, fovy=0.8, r=r,
               t=-(r @ center), znear=0.1, zfar=50.0)
    return arrays, cam, 3


@pytest.mark.parametrize("case", ["frontal_wall", "random_64"])
def test_render_debug_matches_reference(case):
    arrays, cam_kw, degree = (_frontal_wall() if case == "frontal_wall"
                              else _random_scene())
    j_cam = j_camera.Camera(**cam_kw)
    t_cam = t_camera.Camera(**cam_kw)
    for prop in ("world_view_transform", "projection_matrix",
                 "camera_center"):
        _close(getattr(t_cam, prop), getattr(j_cam, prop))
    j_origin, j_dirs = j_cam.rays()
    t_origin, t_dirs = t_cam.rays("cpu")
    _close(t_origin, j_origin)
    _close(t_dirs, j_dirs)
    bg = f32([0.1, 0.2, 0.3])
    want = j_camera.render_debug(
        JBundle(**{k: jnp.asarray(v) for k, v in arrays.items()}), j_cam,
        jnp.asarray(bg), active_sh_degree=degree, chunk=128)
    got = t_camera.render_debug(
        TBundle(**{k: torch.tensor(v) for k, v in arrays.items()}), t_cam,
        torch.tensor(bg), active_sh_degree=degree, chunk=100)
    for key in ("intensity", "depth", "accum", "channels"):
        assert tuple(got[key].shape) == tuple(np.asarray(want[key]).shape)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=RENDER_ATOL, err_msg=key)
    acc = got["accum"].numpy()
    assert acc.max() > 0.5 and acc.min() < acc.max()
    if case == "frontal_wall":
        center = got["depth"][8, 8] / got["accum"][8, 8].clamp_min(1e-6)
        assert abs(float(center) - 5.0) < 0.2


def test_camera_is_frozen():
    cam = t_camera.Camera(image_height=4, image_width=4, fovx=0.5, fovy=0.5,
                          r=np.eye(3), t=np.zeros(3))
    with pytest.raises(dataclasses.FrozenInstanceError):
        cam.fovx = 1.0
    assert (cam.znear, cam.zfar) == (0.01, 100.0)


def _cloud(seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=[20.0, 15.0, 1.5], size=(5000, 3))
    pts[:200, 2] += 6.0                        # a few tall points
    return f32(pts)


@pytest.mark.parametrize("res", [64, 257])
def test_viewer_png_is_the_root_viewers(tmp_path, res):
    """The port's viewer writes the root `viewer.py`'s PNG, byte for
    byte, from the same cloud read back from a PLY."""
    import viewer as root_viewer
    from lidar_rt_tpu_torch import viewer
    from lidar_rt_tpu_torch.utils.export import read_ply, write_ply

    ply = tmp_path / "cloud.ply"
    write_ply(str(ply), _cloud(res))
    points, _ = read_ply(str(ply))
    ours, theirs = tmp_path / "port.png", tmp_path / "root.png"
    viewer.render_views(points, str(ours), res)
    root_viewer.render_views(points, str(theirs), res)
    assert ours.read_bytes() == theirs.read_bytes()


def test_viewer_command_line(tmp_path, capsys):
    """`python -m lidar_rt_tpu_torch.viewer --pcd ... --out ...`, and
    --o3d, which says so and writes the PNG where open3d is missing."""
    import importlib.util

    from lidar_rt_tpu_torch import viewer
    from lidar_rt_tpu_torch.utils.export import write_ply

    ply = tmp_path / "cloud.ply"
    write_ply(str(ply), _cloud(1))
    out = tmp_path / "view.png"
    viewer.main(["--pcd", str(ply), "--out", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "5000 points" in capsys.readouterr().out
    if importlib.util.find_spec("open3d") is None:
        out.unlink()
        viewer.main(["--pcd", str(ply), "--out", str(out), "--o3d"])
        assert out.exists()
        assert "open3d not available" in capsys.readouterr().out
