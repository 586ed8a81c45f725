"""The port's scene assembly and the trainer's warm-up budget held to
`lidar_rt_tpu` on the same inputs: `from_points`, `assemble_scene` (with and
without normal initialization, with a moving actor), the slice from files
on disk to an assembled scene, and training steps across `warmup_until`.

Bars: every asset field but `quat` within 1e-6 absolute + 1e-5 relative;
`quat` within 1e-5 where the test feeds both packages the reference's
spins and their normals agree to 1e-6, and everywhere R(q)[:, 2] within
1e-4 of the port's own normals; losses at tests/test_torch_train.py's
bars.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu.config import Args, parse
from lidar_rt_tpu.data import build as j_build
from lidar_rt_tpu.data import synthetic as j_syn
from lidar_rt_tpu.data import waymo as j_waymo
from lidar_rt_tpu.data import writers as j_writers
from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu.ops.binning import TileConfig as JTileConfig
from lidar_rt_tpu.scene import asset as j_asset
from lidar_rt_tpu.train import loop as j_loop
from lidar_rt_tpu_torch.core import quaternions as t_quat
from lidar_rt_tpu_torch.data import build as t_build
from lidar_rt_tpu_torch.data import waymo as t_waymo
from lidar_rt_tpu_torch.data.frames import LiDARFrames
from lidar_rt_tpu_torch.ops import kernels
from lidar_rt_tpu_torch.ops import tracer as t_tracer
from lidar_rt_tpu_torch.ops.binning import TileConfig as TTileConfig
from lidar_rt_tpu_torch.scene import asset as t_asset
from lidar_rt_tpu_torch.scene import convert
from lidar_rt_tpu_torch.scene.tracks import ActorTrack
from lidar_rt_tpu_torch.train import loop as t_loop
from lidar_rt_tpu_torch.train import options
from test_torch_data import _port_grid, _waymo_arrays

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
FIELDS = ("xyz", "f_dc", "f_rest", "log_scale", "opacity_logit", "alive")
OBJ_PT_NUM = 512


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def _t(x):
    return torch.tensor(np.asarray(x))


def _ref_thetas(key, sizes):
    """The in-plane spins the reference's assembly draws: its key split
    once per asset (background first), each asset's key split again into
    (rotation, uniform) keys."""
    out = []
    for n in sizes:
        key, k_asset = jax.random.split(key)
        k_rot, _ = jax.random.split(k_asset)
        out.append(_t(jax.random.uniform(k_rot, (n, 1), minval=0.0,
                                         maxval=2.0 * jnp.pi)))
    return out


def _capture_normals(monkeypatch):
    """Record the normals each package's assembly hands `from_points`."""
    seen = {"ref": [], "port": []}

    def wrap(mod, name, to_np):
        inner = mod.from_points

        def from_points(points, color, key, capacity, normals=None, **kw):
            seen[name].append(None if normals is None else to_np(normals))
            return inner(points, color, key, capacity, normals, **kw)

        monkeypatch.setattr(mod, "from_points", from_points)

    wrap(j_build, "ref", np.asarray)
    wrap(t_build, "port", lambda n: n.numpy())
    return seen


def _feed_spins(monkeypatch, thetas):
    """The port's in-plane spins, one tensor per asset in order."""
    it = iter(thetas)
    monkeypatch.setattr(t_quat, "random_with_fixed_normal",
                        lambda gen, n: t_quat.with_fixed_normal(n, next(it)))


def _assets_close(t_asset_, j_asset_, what):
    for f in FIELDS:
        _close(getattr(t_asset_, f), getattr(j_asset_, f), msg=f"{what}.{f}")
    _close(t_asset_.extent, j_asset_.extent, msg=f"{what}.extent")
    assert t_asset_.max_sh_degree == j_asset_.max_sh_degree
    assert t_asset_.active_sh_degree == 0
    assert not np.asarray(j_asset_.active_sh_degree).any()


def _normal_axis(asset):
    return t_quat.to_rotation_matrix(asset.quat)[..., :, 2].numpy()


# -- from_points ----------------------------------------------------------


@pytest.mark.parametrize("with_normals", [True, False],
                         ids=["normals", "uniform"])
def test_from_points(with_normals):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-20, 20, (700, 3)).astype(np.float32)
    color = rng.uniform(size=(700, 3)).astype(np.float32)
    nrm = rng.normal(size=(700, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    key = jax.random.key(5)
    want = j_asset.from_points(jnp.asarray(pts), jnp.asarray(color), key,
                               1024, jnp.asarray(nrm) if with_normals
                               else None, extent=33.0)
    gen = torch.Generator().manual_seed(5)
    got = t_asset.from_points(_t(pts), _t(color), gen, 1024,
                              _t(nrm) if with_normals else None,
                              extent=33.0)
    _assets_close(got, want, "asset")
    dead = slice(700, None)
    np.testing.assert_array_equal(got.quat[dead].numpy(),
                                  np.asarray(want.quat[dead]))
    if with_normals:
        k_rot, _ = jax.random.split(key)
        theta = jax.random.uniform(k_rot, (700, 1), minval=0.0,
                                   maxval=2.0 * jnp.pi)
        _close(t_quat.with_fixed_normal(_t(nrm), _t(theta)),
               want.quat[:700])
        _close(_normal_axis(got)[:700], nrm)
    else:
        q = got.quat[:700]
        assert bool(((q >= 0) & (q < 1)).all())
    empty = t_asset.dead_asset(8, device="cpu")
    _assets_close(empty, j_asset.dead_asset(8), "dead")


# -- assemble_scene -------------------------------------------------------


def _args(use_normals):
    d = parse("configs/rehearsal/waymo.yaml",
              parse("configs/rehearsal/exp.yaml")).to_dict()
    d["model"]["obj_pt_num"] = OBJ_PT_NUM
    d["opt"]["use_normal_init"] = use_normals
    t_args = options.rehearsal_options("waymo")
    t_args.model.obj_pt_num = OBJ_PT_NUM
    t_args.opt.use_normal_init = use_normals
    return Args(d), t_args


@pytest.fixture(scope="module")
def synthetic_frames():
    """Three 16x128 synthetic frames with a moving actor, in both
    packages (the port's carried across as arrays)."""
    frames, track = j_syn.generate(num_frames=3, height=16, width=128)
    t_frames = LiDARFrames.from_numpy(
        _port_grid(frames.grid), frames.sensor2world, frames.range1,
        frames.intensity1, device="cpu")
    t_track = ActorTrack(*(_t(getattr(track, f))
                           for f in convert.TRACK_FIELDS), track.object_id)
    return frames, track, t_frames, t_track


def _check_scenes(got, want, seen, use_normals, thetas_fed):
    _assets_close(got.background, want.background, "background")
    _assets_close(got.actors, want.actors, "actors")
    for f in convert.TRACK_FIELDS:
        _close(getattr(got.tracks, f), getattr(want.tracks, f), msg=f)
    assert got.tracks.object_id == want.tracks.object_id
    parts = [(got.background, want.background, 0)] + [
        (dataclasses.replace(got.actors, quat=got.actors.quat[a]),
         dataclasses.replace(want.actors, quat=want.actors.quat[a]), a + 1)
        for a in range(got.num_actors)]
    agree = []
    for t_part, j_part, i in parts:
        if not use_normals:
            assert seen["port"][i] is None and seen["ref"][i] is None
            continue
        own, ref = seen["port"][i], seen["ref"][i]
        n = own.shape[0]
        unit = own / np.linalg.norm(own, axis=1, keepdims=True)
        # 1e-4: the half-angle construction cancels in 1 - n_z where n is
        # near +z, in both packages (measured up to 1.3e-5).
        _close(_normal_axis(t_part)[:n], unit, atol=1e-4)
        if thetas_fed:
            ref_unit = ref / np.linalg.norm(ref, axis=1, keepdims=True)
            same_n = np.abs(unit - ref_unit).max(1) <= 1e-6
            agree.append(same_n.mean())
            _close(t_part.quat.numpy()[:n][same_n],
                   np.asarray(j_part.quat)[:n][same_n], atol=1e-5)
    return agree


@pytest.mark.parametrize("use_normals", [True, False],
                         ids=["normal-init", "uniform"])
def test_assemble_scene(synthetic_frames, monkeypatch, use_normals):
    """With normal initialization the port's spins are the reference's;
    quaternions agree wherever the two packages' normals agree to 1e-6:
    83.8% of the background's (voxel means of per-frame normals, some of
    them from collinear neighbourhoods whose normal is ill-defined, see
    test_torch_data's normals test) and 99.6% of the actor's."""
    frames, track, t_frames, t_track = synthetic_frames
    j_args, t_args = _args(use_normals)
    key = jax.random.key(0)
    seen = _capture_normals(monkeypatch)
    want = j_build.assemble_scene(frames, [track], j_args, key,
                                  capacity_headroom=1.5)
    if use_normals:
        _feed_spins(monkeypatch, _ref_thetas(
            key, [n.shape[0] for n in seen["ref"]]))
    got = t_build.assemble_scene(t_frames, [t_track], t_args,
                                 capacity_headroom=1.5)
    assert got.num_actors == 1 and got.background.capacity == \
        want.background.capacity
    agree = _check_scenes(got, want, seen, use_normals, use_normals)
    if use_normals:
        assert min(agree) > 0.5, agree


def test_assemble_static_scene_and_subsampling(synthetic_frames):
    """No dynamic actor, and the numpy-seeded subsampling in place of the
    voxel grid."""
    frames, track, t_frames, t_track = synthetic_frames
    j_args, t_args = _args(False)
    d = j_args.to_dict()
    d["opt"]["use_voxel_init"] = False
    t_args.opt.use_voxel_init = False
    want = j_build.assemble_scene(frames, None, Args(d))
    got = t_build.assemble_scene(t_frames, [], t_args)
    assert got.actors is None and want.actors is None
    _assets_close(got.background, want.background, "background")


# -- the slice: files on disk -> loaded frames -> assembled scene ---------


@pytest.fixture(scope="module")
def slice_scenes(tmp_path_factory):
    """A 16x128 two-return Waymo segment written by the reference's
    writers, loaded and assembled by each package (the port parses with
    the native ingest)."""
    root = tmp_path_factory.mktemp("slice")
    j_writers.write_waymo_segment(str(root / "ref"),
                                  **_waymo_arrays(16, 128, 3))
    shutil.copytree(root / "ref", root / "port")
    j_args, t_args = _args(True)
    for a in (t_args,):
        a.frame_length, a.eval_frames = [0, 2], [1]
    d = j_args.to_dict()
    d.update(frame_length=[0, 2], eval_frames=[1])
    j_args = Args(d)
    j_frames, j_tracks = j_waymo.load(str(root / "ref"), j_args)
    want = j_build.assemble_scene(j_frames, j_tracks, j_args,
                                  capacity_headroom=1.5)
    t_frames, t_tracks = t_waymo.load(str(root / "port"), t_args,
                                      use_native=True, device="cpu")
    got = t_build.assemble_scene(t_frames, t_tracks, t_args,
                                 capacity_headroom=1.5)
    return j_frames, want, t_frames, got


def test_slice_files_to_scene(slice_scenes):
    j_frames, want, t_frames, got = slice_scenes
    np.testing.assert_array_equal(t_frames.range2.numpy(), j_frames.range2)
    assert got.num_actors == want.num_actors == 1
    _assets_close(got.background, want.background, "background")
    _assets_close(got.actors, want.actors, "actors")
    for f in convert.TRACK_FIELDS:
        _close(getattr(got.tracks, f), getattr(want.tracks, f), msg=f)
    for asset in (got.background, got.actors):
        q = asset.quat[asset.alive]
        assert bool(torch.isfinite(q).all())
        _close(torch.linalg.vector_norm(q, dim=-1), 1.0)


# -- training across the warm-up budget's switch --------------------------


TILE = dict(tile_h=8, tile_w=16, max_per_tile=128)
WARM_K = 256
WARMUP_UNTIL = 2
STEPS = 4


def _carried(j_scene, j_frames):
    """The reference's scene, its surfels jittered by 5 cm (assembled
    surfels tie in range to rounding, and the packages round the range
    differently), and its port copy."""
    rng = np.random.default_rng(0)

    def jitter(asset):
        noise = rng.normal(scale=0.05, size=asset.xyz.shape)
        return dataclasses.replace(asset, xyz=asset.xyz + noise.astype(
            np.float32))

    j_scene = dataclasses.replace(j_scene,
                                  background=jitter(j_scene.background),
                                  actors=jitter(j_scene.actors))
    arrays = {f"tracks.{f}": np.asarray(getattr(j_scene.tracks, f))
              for f in convert.TRACK_FIELDS}
    for part in ("background", "actors"):
        a = getattr(j_scene, part)
        for f in convert.ASSET_FIELDS + ("active_sh_degree",):
            arrays[f"{part}.{f}"] = np.asarray(getattr(a, f))
        arrays[f"{part}.extent"] = np.float32(a.extent)
        arrays[f"{part}.max_sh_degree"] = np.int32(a.max_sh_degree)
    t_frames = LiDARFrames.from_numpy(
        _port_grid(j_frames.grid), j_frames.sensor2world, j_frames.range1,
        j_frames.intensity1, device="cpu",
        train_frames=j_frames.train_frames,
        eval_frames=j_frames.eval_frames)
    return j_scene, convert.scene_from_numpy(arrays, device="cpu"), t_frames


@pytest.fixture(scope="module")
def warmup_runs(slice_scenes):
    """Both trainers, STEPS steps from the slice's reference scene, K=256
    for steps 1..WARMUP_UNTIL and K=128 after."""
    j_frames, j_scene, _, _ = slice_scenes
    j_scene, t_scene, t_frames = _carried(j_scene, j_frames)
    small = dict(cd_max_points=512, densify_from_iter=500,
                 densify_until_iter=1000)
    d = parse("configs/exp.yaml").to_dict()
    d["opt"].update(small)
    j_cfg = j_tracer.TraceConfig(tile=JTileConfig(**TILE), tile_batch=2)
    j_warm = dataclasses.replace(j_cfg, tile=dataclasses.replace(
        j_cfg.tile, max_per_tile=WARM_K))
    jt = j_loop.Trainer(j_scene, j_frames, Args(d), j_cfg,
                        warmup_cfg=j_warm, warmup_until=WARMUP_UNTIL)
    jt.CHUNK = 10 ** 9          # single steps only
    jt.run(iterations=STEPS, log_every=1)

    t_cfg = t_tracer.TraceConfig(tile=TTileConfig(**TILE))
    t_warm = dataclasses.replace(t_cfg, tile=dataclasses.replace(
        t_cfg.tile, max_per_tile=WARM_K))
    tt = t_loop.Trainer(t_scene, t_frames,
                        options.experiment_options(**small), t_cfg,
                        warmup_cfg=t_warm, warmup_until=WARMUP_UNTIL)
    ks = []
    kernels.reset_launches()
    for _ in range(STEPS):
        tt.run(1, log_every=1)
        ks.append((tt.step_cfg.tile.max_per_tile,
                   tt.state.bins.index.shape[-1], tt.state.bins.rebins))
    return jt, tt, ks


def test_warmup_budget_losses_match(warmup_runs):
    jt, tt, _ = warmup_runs
    assert [h["iteration"] for h in tt.history] == list(range(1, STEPS + 1))
    for t_h, j_h in zip(tt.history, jt.history):
        for key in ("loss", "depth", "intensity", "raydrop", "cd", "reg"):
            _close(t_h[key], j_h[key], msg=f"{key} @ {t_h['iteration']}")


def test_warmup_budget_switch(warmup_runs):
    """Steps 1..WARMUP_UNTIL render at the warm-up K, later ones at the
    steady-state K; the cache is rebuilt at the switch, so the step after
    it rebins its frame.  CPU tensors launch no kernel."""
    jt, tt, ks = warmup_runs
    assert [k for k, _, _ in ks] == [WARM_K] * WARMUP_UNTIL + [128] * (
        STEPS - WARMUP_UNTIL)
    assert [k for _, k, _ in ks] == [k for k, _, _ in ks]
    rebins = [r for _, _, r in ks]
    assert rebins[WARMUP_UNTIL] == rebins[WARMUP_UNTIL - 1] + 1
    assert tt.warmup_until == jt.warmup_until == 0
    assert kernels.forward_launches == kernels.backward_launches == 0
    plain = t_loop.Trainer(tt.state.scene, tt.frames, tt.args, tt.trace_cfg)
    assert plain.step_cfg is plain.trace_cfg
    assert plain.state.bins.index.shape[-1] == 128
    with_default = t_loop.Trainer(tt.state.scene, tt.frames, tt.args,
                                  tt.trace_cfg, warmup_cfg=tt.trace_cfg)
    assert with_default.warmup_until == int(tt.args.opt.densify_until_iter)

