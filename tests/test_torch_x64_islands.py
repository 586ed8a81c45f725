"""The reference's float32 islands under `jax.enable_x64`, on the training
path that `test_torch_densify_full.py` compares (ROADMAP C7).

That comparison reads the densification statistic after 20 steps of both
trainers from one state; in float32 its 0.999 quantile parts by 3.2%,
about as far as two float32 paths of the port part.  Deciding it in
float64 needs every step of the reference's training path in float64.
With x64 on and a float64 scene, three parts of that path still round
to float32, and none can be lifted without editing the reference:

  * the Chamfer term's cross products (`lidar_rt_tpu/ops/chamfer.py:51-53`,
    `preferred_element_type=jnp.float32`): |a|^2 + |b|^2 - 2 a.b with a.b
    rounded to float32 loses the squared distance of near points at tens
    of metres, so the term and its gradient keep float32 noise;
  * the xyz learning-rate schedule (`lidar_rt_tpu/train/optim.py:27`, the
    step cast to float32);
  * the trainer's frames and the rays made from them
    (`lidar_rt_tpu/train/loop.py:325-327`, `core/rays.py:54,62,110`):
    float32 poses, ranges and sensor directions, so the world rays and
    the inverse pose are float32 arithmetic.

Each test shows one of them on the CPU at a small size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lidar_rt_tpu.core import rays as j_rays
from lidar_rt_tpu.core import transforms as j_tf
from lidar_rt_tpu.ops import chamfer as j_chamfer
from lidar_rt_tpu.train import optim as j_optim


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


def test_chamfer_distances_keep_float32_noise(x64):
    """Scan-like points 20-60 m away and a copy moved by 5 cm: under x64
    the reference returns float64 squared distances whose error against
    an exact float64 computation is float32's (relative 1e-3 and more at
    these ranges), not float64's."""
    rng = np.random.default_rng(0)
    n = 512
    d = rng.normal(size=(n, 3))
    a = d / np.linalg.norm(d, axis=1, keepdims=True) \
        * rng.uniform(20.0, 60.0, (n, 1))
    b = a + rng.normal(scale=0.05, size=(n, 3))
    mask = np.ones(n, bool)
    got = np.asarray(j_chamfer.min_sq_dists(jnp.asarray(a), mask,
                                            jnp.asarray(b), mask))
    want = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1).min(1)
    assert got.dtype == np.float64
    rel = np.abs(got - want) / want
    assert rel.max() > 1e-3
    # What float64 cross products would give.
    exact = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
             - 2.0 * a @ b.T).min(1)
    assert (np.abs(exact - want) / want).max() < 1e-6


def test_xyz_learning_rate_is_float32(x64):
    sched = j_optim.expon_lr_schedule(1.6e-4 * 30.0, 1.6e-6 * 30.0,
                                      lr_delay_mult=0.01, max_steps=4000)
    steps = np.arange(1, 41)
    got = np.array([sched(s) for s in steps])
    assert got.dtype == np.float32
    t = steps / 4000.0
    want = np.exp(np.log(1.6e-4 * 30.0) * (1.0 - t)
                  + np.log(1.6e-6 * 30.0) * t)
    rel = np.abs(got.astype(np.float64) - want) / want
    assert 0.0 < rel.max() < 1e-6


def test_rays_and_inverse_pose_are_float32(x64):
    """The rays of a beam-table grid and the inverse of the trainer's
    float32 pose stay float32 with x64 on."""
    grid = j_rays.SensorGrid.from_beams(np.linspace(-0.4, 0.05, 16))
    assert j_rays.sensor_dirs(grid, 64).dtype == jnp.float32
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [1.5, -2.0, 2.0]
    origin, dirs = j_rays.range_rays(grid, 64, jnp.asarray(pose))
    assert dirs.dtype == jnp.float32
    assert j_tf.invert_se3(jnp.asarray(pose)).dtype == jnp.float32
