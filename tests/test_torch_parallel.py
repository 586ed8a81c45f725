"""The port's scale-out path held to `lidar_rt_tpu`: `trace_ray_sharded`,
the sharded loss and the `ShardedTrainer` (the column bands they run on:
tests/test_torch_bands.py).

The port's worlds are gloo ranks on this host (`parallel.run_world`: a
`file://` rendezvous in a fresh directory, each world with a deadline of
at most 120 s); their rank functions live in torch_parallel_workers.py,
which imports the port only.  The reference runs in this process on the
conftest's virtual CPU devices, with its jax engine and exact top-k.

Bars: channels and accum 2e-4; gradients 3e-3 after
scaling by the reference's largest magnitude; losses 1e-4 relative; a
trainer's per-iteration losses 2e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from _torch_parity import jittered, scene_arrays
from lidar_rt_tpu.config import Args, default_experiment
from lidar_rt_tpu.core import rays as j_rays
from lidar_rt_tpu.data import build, synthetic
from lidar_rt_tpu.ops import binning as j_bin
from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu.ops.composite import SurfelBundle as JBundle
from lidar_rt_tpu.parallel import make_mesh as j_make_mesh
from lidar_rt_tpu.parallel import trace_ray_sharded as j_trace_ray_sharded
from lidar_rt_tpu.parallel.train_step import (
    make_sharded_loss_fn as j_make_sharded_loss_fn)
from lidar_rt_tpu.parallel.train_step import (
    stack_batches as j_stack_batches)
from lidar_rt_tpu.train import loop as j_loop
from lidar_rt_tpu_torch.parallel import (Mesh, ShardedTrainer, make_mesh,
                                         run_world)
from lidar_rt_tpu_torch.train import loop as t_loop
from lidar_rt_tpu_torch.train import options

torch.set_num_threads(1)

ATOL = 2e-4
H, W = 16, 256
DEADLINE = 120.0


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


# -- the ray-sharded trace --------------------------------------------------


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


def _world(fn, dp, rays, *args):
    return run_world(fn, dp, rays, "gloo", device="cpu", timeout_s=DEADLINE,
                     args=args)


def test_trace_ray_sharded_matches_reference():
    """rays = 4: on every rank, the bundle's gradients of a loss on the
    gathered scan against the reference's `trace_ray_sharded` on a
    4-device mesh (jitted); the scan, each rank's band and accum against
    the reference's eager band renders, which its sharded trace runs one
    per device (its jitted render can flip a gate at single pixels)."""
    s = _surfels(300, seed=7)
    tile = dict(tile_h=8, tile_w=32, max_per_tile=64)
    j_cfg = j_tracer.TraceConfig(tile=j_bin.TileConfig(**tile), tile_batch=2,
                                 engine="jax")
    mesh = j_make_mesh(dp=1, rays=4, devices=jax.devices()[:4])
    jg = j_rays.SensorGrid.from_bounds(H, GRID["bounds"])
    jb = JBundle(**{k: jnp.asarray(v) for k, v in s.items()})

    def j_loss(b):
        out = j_trace_ray_sharded(b, jg, W, POSE, BG, 3, j_cfg, mesh)
        return (jnp.sum(out.channels[..., 3] ** 2) * 1e-3
                + jnp.sum(out.channels[..., 0]))

    j_grads = jax.jit(jax.grad(j_loss))(jb)
    bands = [j_tracer.trace(jb, jg, W, POSE, BG, 3, j_cfg, col_offset=c,
                            render_width=W // 4) for c in range(0, W, W // 4)]
    scan = np.concatenate([np.asarray(b.channels) for b in bands], 1)
    accum = sum(np.asarray(b.accum_weights) for b in bands)
    outs = _world(workers.sharded_render, 1, 4, s, GRID, W, POSE, BG, 3,
                  tile)
    for rank, out in enumerate(outs):
        _close(out["channels"], scan, msg=f"rank {rank}")
        _close(out["band"], scan[:, rank * 64:(rank + 1) * 64])
        _close(out["accum"], accum)
        for name, g in out["grads"].items():
            _grad_close(g, getattr(j_grads, name), f"rank {rank} {name}")
            np.testing.assert_array_equal(g, outs[0]["grads"][name])


# The training scenes: the reference's synthetic frames and assembled
# scene, surfels jittered by 5 cm (range ties from range images order by
# rounding, which the two packages do differently).
OPT = dict(lambda_cd=0.01, cd_max_points=512)
TILE = dict(tile_h=8, tile_w=32, max_per_tile=128)


@pytest.fixture(scope="module")
def scene_data():
    """(reference frames, reference scene, the arrays the ranks build the
    port's from): 4 frames with one actor."""
    frames, track = synthetic.generate(num_frames=4, height=H, width=W)
    d = default_experiment().to_dict()
    d["model"].update(obj_pt_num=128, voxel_size=0.3)
    scene = build.assemble_scene(frames, [track], Args(d),
                                 capacity_headroom=1.5)
    scene = jittered(scene)
    data = {"scene": scene_arrays(scene), "frames": dict(
        row_inclinations=np.asarray(frames.grid.row_inclinations),
        pixel_offset=frames.grid.pixel_offset,
        angle_offset=frames.grid.angle_offset,
        sensor2world=np.asarray(frames.sensor2world),
        range1=np.asarray(frames.range1),
        intensity1=np.asarray(frames.intensity1),
        train_frames=list(frames.train_frames),
        eval_frames=list(frames.eval_frames))}
    return frames, scene, data


def test_sharded_loss_matches_reference(scene_data):
    """dp = 2 x rays = 2 on frames (0, 1): the 5-term loss and its
    breakdown, accum, and the gradients of the background's parameters
    and of the probe against the reference's on a 2 x 2 mesh; then, with
    all-ones masks and DSSIM and Chamfer off (the terms whose bands
    differ between the two layouts), the dp = 2 gradients equal the mean
    of the two frames' dp = 1 x rays = 4 gradients."""
    frames, scene, data = scene_data
    d = default_experiment().to_dict()
    d["opt"].update(OPT)
    cfg = j_tracer.TraceConfig(tile=j_bin.TileConfig(**TILE), tile_batch=2,
                               engine="jax")
    loss_fn = j_make_sharded_loss_fn(
        frames, Args(d), cfg, j_make_mesh(dp=2, rays=2,
                                          devices=jax.devices()[:4]))
    batch = j_stack_batches([j_loop.frame_batch(frames, f) for f in (0, 1)])

    def j_scalar(p, probe):
        loss, aux = loss_fn(p, None, probe, scene, batch)
        return loss, aux

    (loss, aux), (g_p, g_probe) = jax.jit(jax.value_and_grad(
        j_scalar, argnums=(0, 1), has_aux=True))(
        scene.background.params(), jnp.zeros((scene.total_capacity, 3)))
    assert float(aux["breakdown"].cd) > 0 and float(loss) > 0

    band_free = dict(lambda_intensity_dssim=0.0, lambda_cd=0.0)
    outs = _world(workers.sharded_losses, 2, 2, data, OPT, band_free, TILE)
    for rank, out in enumerate(outs):
        got = out["dp2"]
        np.testing.assert_allclose(got["breakdown"],
                                   np.asarray(list(aux["breakdown"])),
                                   rtol=1e-4, err_msg=f"rank {rank}")
        _close(got["accum"], aux["accum"])
        for name, g in got["grads"].items():
            want = g_probe if name == "probe" else g_p[name]
            _grad_close(g, want, f"rank {rank} {name}")
            np.testing.assert_array_equal(g, outs[0]["dp2"]["grads"][name])
        mean = {k: 0.5 * (a + b) for (k, a), b in zip(
            out["dp1_ones"][0]["grads"].items(),
            out["dp1_ones"][1]["grads"].values())}
        assert max(np.abs(g).max() for g in mean.values()) > 0
        for name, g in out["dp2_ones"]["grads"].items():
            _grad_close(g, mean[name], f"dp2 vs mean of dp1: {name}")


def _trainer_opt(**kw):
    return dict(lambda_intensity_dssim=0.0, lambda_cd=0.0, rebin_interval=3,
                densify_from_iter=1, densification_interval=6,
                densify_until_iter=9, opacity_reset_interval=1000,
                sh_increase_interval=1000, **kw)


def test_sharded_trainer_matches_trainer(scene_data):
    """1 x 1 in this process and 1 x 2 in a world: per-iteration losses
    of the port's `Trainer` schedule across a densify event, DSSIM and
    Chamfer off (the two terms that see a band's edges)."""
    data = scene_data[2]
    opt = _trainer_opt()
    scene, frames = workers.port_inputs(data)
    trainer = t_loop.Trainer(scene, frames, options.experiment_options(**opt),
                             workers.trace_config(TILE), seed=3)
    ref = [h["loss"] for h in trainer.run(iterations=10, log_every=5)]
    assert trainer.densify_log

    scene, frames = workers.port_inputs(data)
    one = ShardedTrainer(scene, frames, options.experiment_options(**opt),
                         make_mesh(), trace_cfg=workers.trace_config(TILE),
                         seed=3)
    hist = one.run(iterations=10, log_every=5)
    np.testing.assert_allclose([h["loss"] for h in hist], ref, rtol=2e-3)
    assert [h["frame"] for h in hist] == [[f] for f in
                                          [h["frame"] for h in
                                           trainer.history]]

    outs = _world(workers.train, 1, 2, data, opt, TILE, 10, 5, 3)
    for out in outs:
        assert out["densify"] == outs[0]["densify"] != []
        np.testing.assert_allclose(out["loss"], ref, rtol=2e-3)
        assert out["digest"] == outs[0]["digest"]


def test_sharded_trainer_dp2_tail_warmup(scene_data):
    """dp = 2 x rays = 2: a cached tail chain (one tail pass), the two-
    phase candidate budget, densify and an opacity reset.  The rows hold
    distinct frames, the losses are finite and fall, and every rank ends
    with the same parameters and Adam moments, bit for bit."""
    data = scene_data[2]
    opt = dict(lambda_intensity_dssim=0.0, lambda_cd=0.01,
               cd_max_points=512, rebin_interval=2, densify_from_iter=1,
               densification_interval=5, densify_until_iter=8,
               opacity_reset_interval=7, sh_increase_interval=1000)
    tile = dict(tile_h=8, tile_w=32, max_per_tile=64)
    warm = dict(tile_h=8, tile_w=32, max_per_tile=128)
    outs = _world(workers.train, 2, 2, data, opt, tile, 12, 4, 0, 1, warm,
                  4)
    for out in outs:
        assert out["digest"] == outs[0]["digest"]
        assert out["loss"] == outs[0]["loss"]
        assert out["frames"] == outs[0]["frames"]
        assert out["densify"] == outs[0]["densify"] != []
    ls = outs[0]["loss"]
    assert len(ls) == 12 and np.isfinite(ls).all()
    assert min(ls[1:]) < ls[0]
    assert all(len(set(row)) == 2 for row in outs[0]["frames"])


def test_mesh_factorization_and_failing_ranks():
    """make_mesh refuses a layout that does not factor the world; a rank
    that raises, or a world past its deadline, makes `run_world` raise
    within the deadline, with every rank killed."""
    assert make_mesh().shape == {"dp": 1, "rays": 1}
    for dp, rays in ((2, None), (1, 2), (0, 1)):
        with pytest.raises(ValueError, match="ranks"):
            make_mesh(dp, rays)
    with pytest.raises(RuntimeError, match=r"dp=3 \* rays=1 != 2 ranks"):
        _world(workers.refuse_mesh, 1, 2, 3, 1)
    with pytest.raises(RuntimeError, match="band 1 fails"):
        run_world(workers.fail_on_band, 1, 2, "gloo", device="cpu",
                  timeout_s=60.0, args=(1,))
    with pytest.raises(TimeoutError):
        run_world(workers.stall, 1, 2, "gloo", device="cpu", timeout_s=3.0,
                  args=(60.0,))
    with pytest.raises(ValueError, match="backend"):
        run_world(workers.stall, 1, 1, "mpi", device="cpu", args=(0.0,))
    assert Mesh(dp=2, rays=3).size == 6
