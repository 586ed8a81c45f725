"""The port's data path held to `lidar_rt_tpu` on the same numpy inputs:
quaternions, transforms, rays, tracks, frames, the Morton k-NN and PCA
normals, the voxel grid, the synthetic scenes, the dataset writers and both
loaders, and the rehearsal's options.

Bars: f32 math within 1e-6 absolute + 1e-5 relative (or to the bit where
both packages compute the same numpy or, on the CPU, the same C library
trig); k-NN neighbour indices identical; writer files byte-identical;
loaders' frames, poses, grids and tracks equal.
"""

import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu.config import Args, parse
from lidar_rt_tpu.core import quaternions as j_quat
from lidar_rt_tpu.core import rays as j_rays
from lidar_rt_tpu.core import transforms as j_tf
from lidar_rt_tpu.data import build as j_build
from lidar_rt_tpu.data import kitti as j_kitti
from lidar_rt_tpu.data import synthetic as j_syn
from lidar_rt_tpu.data import waymo as j_waymo
from lidar_rt_tpu.data import writers as j_writers
from lidar_rt_tpu.ops import knn as j_knn
from lidar_rt_tpu.scene import tracks as j_tracks
from lidar_rt_tpu_torch import native
from lidar_rt_tpu_torch.core import quaternions as t_quat
from lidar_rt_tpu_torch.core import rays as t_rays
from lidar_rt_tpu_torch.core import transforms as t_tf
from lidar_rt_tpu_torch.data import build as t_build
from lidar_rt_tpu_torch.data import kitti as t_kitti
from lidar_rt_tpu_torch.data import synthetic as t_syn
from lidar_rt_tpu_torch.data import waymo as t_waymo
from lidar_rt_tpu_torch.data import writers as t_writers
from lidar_rt_tpu_torch.data.frames import LiDARFrames
from lidar_rt_tpu_torch.ops import knn as t_knn
from lidar_rt_tpu_torch.scene import tracks as t_tracks
from lidar_rt_tpu_torch.train import options
from _torch_parity import port_grid as _port_grid

torch.set_num_threads(1)

ATOL, RTOL = 1e-6, 1e-5


def close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol, err_msg=msg)


def same(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


def f32(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _rotations(rng, n):
    q = f32(rng.normal(size=(n, 4)))
    return np.array(j_quat.to_rotation_matrix(jnp.asarray(q)), np.float32)


# -- quaternions, transforms, rays ----------------------------------------


class TestCoreMath:
    def test_from_rotation_matrix_and_rotate(self):
        rng = np.random.default_rng(0)
        m = _rotations(rng, 200)
        # Every pivot branch: near-identity and half-turns about each axis.
        m[:4] = np.stack([np.eye(3), np.diag([1, -1, -1]),
                          np.diag([-1, 1, -1]), np.diag([-1, -1, 1])])
        close(t_quat.from_rotation_matrix(_t(m)),
              j_quat.from_rotation_matrix(jnp.asarray(m)))
        q, p = f32(rng.normal(size=(200, 4))), f32(rng.normal(size=(200, 3)))
        close(t_quat.rotate(_t(q), _t(p)), j_quat.rotate(q, p))

    def test_fixed_normal_with_the_reference_spin(self):
        """With the spin the reference draws from its key, the same
        quaternions; the generator's draw keeps R(q)[:, 2] = n."""
        rng = np.random.default_rng(1)
        n = f32(rng.normal(size=(300, 3)))
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        n[:3] = [[0, 0, 1], [0, 0, -1], [1e-9, 0, -1]]   # degenerate axes
        key = jax.random.key(3)
        theta = jax.random.uniform(key, (300, 1), minval=0.0,
                                   maxval=2.0 * jnp.pi)
        want = j_quat.random_with_fixed_normal(key, jnp.asarray(n))
        close(t_quat.with_fixed_normal(_t(n), _t(theta)), want)
        got = t_quat.random_with_fixed_normal(
            torch.Generator().manual_seed(0), _t(n))
        close(t_quat.to_rotation_matrix(got)[:, :, 2], n, atol=1e-6)

    def test_forward_fill_poses(self):
        rng = np.random.default_rng(2)
        t = f32(rng.normal(size=(7, 3)))
        r = f32(rng.normal(size=(7, 4)))
        for present in ([0, 0, 1, 0, 1, 0, 0], [1, 0, 0, 0, 0, 0, 1],
                        [0] * 7, [1] * 7):
            present = np.asarray(present, bool)
            for got, want in zip(t_tf.forward_fill_poses(present, t, r),
                                 j_tf.forward_fill_poses(present, t, r)):
                same(got, want)

    def test_range_to_points_and_project(self):
        """Back-projection is bit-identical on the CPU (the same C library
        trig and one fused multiply-add chain per coordinate)."""
        rng = np.random.default_rng(3)
        grid = j_rays.SensorGrid.from_beams(
            np.linspace(-0.3, 0.05, 12).astype(np.float32),
            angle_offset=0.05)
        s2w = np.eye(4, dtype=np.float32)
        s2w[:3, :3] = _rotations(rng, 1)[0]
        s2w[:3, 3] = [3.0, -1.5, 2.0]
        rng_map = f32(rng.uniform(1, 70, (12, 96)))
        pts = t_rays.range_to_points(_port_grid(grid), _t(rng_map), _t(s2w))
        want = j_rays.range_to_points(grid, jnp.asarray(rng_map),
                                      jnp.asarray(s2w))
        same(pts, want)
        w2s = f32(j_tf.invert_se3(jnp.asarray(s2w)))
        got = t_rays.project_points(_port_grid(grid), pts, _t(w2s), 96)
        ref = j_rays.project_points(grid, want, jnp.asarray(w2s), 96)
        for g, r in zip(got, ref):
            close(g, r, atol=2e-4)      # rows/cols: pixel units of 1e-4
        close(got[2], rng_map, atol=1e-4)


# -- tracks ---------------------------------------------------------------


def _track_pair(kind):
    rng = np.random.default_rng(4)
    builders = [mod.TrackBuilder(6, [4.0, 2.0, 1.5], object_id="7")
                for mod in (j_tracks, t_tracks)]
    for f in (1, 2, 4):
        if kind == "waymo":
            ego = np.eye(4, dtype=np.float32)
            ego[:3, :3] = _rotations(rng, 1)[0]
            ego[:3, 3] = rng.normal(size=3)
            args = (f, rng.normal(size=3), float(rng.uniform(-3, 3)), ego)
            for b in builders:
                b.add_frame_waymo(*args)
        elif kind == "kitti":
            tr = np.eye(4)
            tr[:3, :3] = _rotations(rng, 1)[0] @ np.diag(
                rng.uniform(1, 5, 3))
            tr[:3, 3] = rng.normal(size=3) * 10
            for b in builders:
                b.add_frame_kitti(f, tr)
        else:
            args = (f, rng.normal(size=3), rng.normal(size=4))
            for b in builders:
                b.add_frame_pose(*args)
    return builders[0].build(), builders[1].build(device="cpu")


class TestTracks:
    @pytest.mark.parametrize("kind", ["waymo", "kitti", "pose"])
    def test_track_builder(self, kind):
        """Sizes to the bit (numpy float32 SVD in both), poses at 1e-6."""
        j, t = _track_pair(kind)
        same(t.size, j.size)
        same(t.present, j.present)
        close(t.translations, j.translations)
        close(t.quats, j.quats)
        assert (t.object_id, t.object_type) == (j.object_id, j.object_type)
        close(t.mean_speed(), j.mean_speed())

    def test_stack_tracks(self):
        (j1, t1), (j2, t2) = _track_pair("waymo"), _track_pair("kitti")
        j = j_tracks.stack_tracks([j1, j2])
        t = t_tracks.stack_tracks([t1, t2])
        for f in ("size", "translations", "quats", "present"):
            close(getattr(t, f), getattr(j, f), msg=f)
        assert t.object_id == j.object_id == "7|7"
        assert t.pose(3)[0].shape == (2, 3)


# -- frames ---------------------------------------------------------------


@pytest.fixture(scope="module")
def dual_frames():
    """Two-return synthetic frames, 16x96, in both packages."""
    scene = j_syn.default_scene()
    grid = j_rays.SensorGrid.from_bounds(16, (-0.42, 0.08), 0.5, 0.05)
    s2w = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    s2w[:, :3, 3] = [[0, 0, 2], [0.5, 0.1, 2]]
    imgs = [j_syn.render_frame_gt_dual(scene, grid, 96, s2w[f], f)
            for f in range(2)]
    r1, i1, r2, i2 = (np.stack([im[k] for im in imgs]) for k in range(4))
    j = j_build.LiDARFrames(grid=grid, width=96, sensor2world=s2w,
                            range1=r1, intensity1=i1, range2=r2,
                            intensity2=i2, frame_numbers=[5, 6])
    t = LiDARFrames.from_numpy(_port_grid(grid), s2w, r1, i1, device="cpu",
                               range2=r2, intensity2=i2, frame_numbers=[5, 6])
    return j, t


class TestFrames:
    def test_accessors(self, dual_frames):
        j, t = dual_frames
        assert t.frame_numbers == j.frame_numbers and t.width == j.width
        for ret in (1, 2):
            same(t.mask(1, ret), j.mask(1, ret))
            same(t.depth(1, ret), j.depth(1, ret))
            same(t.intensity(1, ret), j.intensity(1, ret))
        same(t.sensor_center(1), j.sensor_center(1))
        for got, want in zip(t.rays(1), j.rays(1)):
            close(got, want)
        assert bool((t.depth(1, 2) > 0).any())

    def test_inverse_projection_and_normals(self, dual_frames):
        """Both returns' points in raster order, to the bit."""
        j, t = dual_frames
        pts, inten = t.inverse_projection(1)
        want_pts, want_int = j.inverse_projection(1)
        same(pts, want_pts)
        same(inten, want_int)
        for ret in (1, 2):
            close(t.normals(1, ret), j.normals(1, ret), atol=1e-5)

    def test_split_train_eval(self, dual_frames):
        j, t = dual_frames
        for stride in (2, 10):
            j.split_train_eval(stride)
            t.split_train_eval(stride)
            assert (t.train_frames, t.eval_frames) == (j.train_frames,
                                                       j.eval_frames)


# -- k-NN, normals, voxels ------------------------------------------------


def _street_points(seed, n):
    """A flat street-like cloud: 100 m wide, 5 m tall."""
    rng = np.random.default_rng(seed)
    p = f32(rng.uniform(-50, 50, (n, 3)))
    p[:, 2] *= 0.05
    return p


def _padded(pts):
    n = pts.shape[0]
    filler = np.full((32768 - n, 3), 1e7, np.float32) \
        + np.arange(32768 - n, dtype=np.float32)[:, None]
    return np.concatenate([pts, filler])


class TestKnn:
    @pytest.mark.parametrize("padded", [False, True],
                             ids=["unpadded", "padded"])
    def test_knn_indices_identical(self, padded):
        pts = _street_points(5, 1500)
        if padded:
            pts = _padded(pts)
        same(t_knn.morton_codes(_t(pts)), j_knn.morton_codes(
            jnp.asarray(pts)))
        d2, idx = t_knn.knn(_t(pts), k=6)
        j_d2, j_idx = j_knn.knn(jnp.asarray(pts), k=6)
        same(idx, j_idx)
        close(d2, j_d2, atol=0.0, rtol=1e-6)
        if padded:      # one Morton code for every real point
            assert len(set(t_knn.morton_codes(_t(pts))[:1500].tolist())) == 1

    def test_knn_ties_keep_the_lower_slot(self):
        """Duplicate points: equal distances, the lower window slot
        first, as lax.top_k takes it."""
        pts = np.repeat(_street_points(6, 40), 3, axis=0)
        same(t_knn.knn(_t(pts), k=4)[1], j_knn.knn(jnp.asarray(pts), k=4)[1])

    def test_mean_sq_dist_to_3nn(self):
        pts = _street_points(7, 1200)
        close(t_knn.mean_sq_dist_to_3nn(_t(pts)),
              j_knn.mean_sq_dist_to_3nn(jnp.asarray(pts)), atol=0.0,
              rtol=1e-6)
        one = np.zeros((1, 3), np.float32)     # no neighbour at all
        same(t_knn.mean_sq_dist_to_3nn(_t(one)),
             j_knn.mean_sq_dist_to_3nn(jnp.asarray(one)))

    def test_estimate_normals_padded(self):
        """One 32x256 synthetic frame (7,068 points) through the
        assembly's padded normals in both packages.

        Under the bucket padding a neighbourhood is 6 raster neighbours,
        mostly collinear, whose normal rounding inside each eigen-solver
        decides.  Classes by the reference covariance's eigenvalues, gap
        g = (l1 - l0) / l2: 4.4% of points have g >= 1e-2, 6.6% g >= 1e-3,
        93.4% g < 1e-3; 99.3% of all normals agree within 0.999 anyway.
          * neighbour covariances agree within 1e-5 of each matrix's
            largest entry (measured 2.4e-7);
          * where g >= 1e-2, |n . n_ref| > 0.999;
          * everywhere, n faces the sensor and is orthogonal to the
            neighbourhood's principal axis within 1e-3."""
        frames, _ = j_syn.generate(num_frames=1, height=32, width=256)
        pts, _ = frames.inverse_projection(0)
        center = f32(frames.sensor_center(0))
        n = pts.shape[0]
        pad = _padded(pts)
        _, j_idx = j_knn.knn(jnp.asarray(pad), k=6)
        neigh = jnp.asarray(pad)[j_idx]
        cen = neigh - neigh.mean(1, keepdims=True)
        j_cov = np.asarray(jnp.einsum(
            "nki,nkj->nij", cen, cen,
            precision=jax.lax.Precision.HIGHEST) / 6)[:n]
        cov = t_knn.neighbour_covariance(_t(pad), k=6).numpy()[:n]
        scale = np.abs(j_cov).max(axis=(1, 2), keepdims=True)
        assert (np.abs(cov - j_cov) <= 1e-5 * scale + 1e-30).all()

        got = t_build._estimate_normals_padded(_t(pts), _t(center)).numpy()
        want = j_build._estimate_normals_padded(pts, center)
        evals, evecs = np.linalg.eigh(j_cov.astype(np.float64))
        gap = (evals[:, 1] - evals[:, 0]) / np.maximum(evals[:, 2], 1e-300)
        defined = gap >= 1e-2
        assert 0.02 < defined.mean() < 0.2
        assert (np.abs((got * want).sum(1))[defined] > 0.999).all()
        close(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
        assert (((center - pts) * got).sum(1) >= 0).all()
        assert np.abs((got * evecs[:, :, 2]).sum(1)).max() < 1e-3

    def test_voxel_downsample(self):
        """Voxels in the same order, means to 1 ulp (float64 sums in
        another order)."""
        rng = np.random.default_rng(8)
        pts = _street_points(8, 5000)
        attrs = [f32(rng.uniform(size=(5000, 3))),
                 f32(rng.normal(size=(5000, 3)))]
        got, got_attrs = t_build.voxel_downsample(
            _t(pts), [_t(a) for a in attrs], 0.9)
        want, want_attrs = j_build.voxel_downsample(pts, attrs, 0.9)
        assert got.shape == want.shape and want.shape[0] < 5000
        for g, w in zip([got, *got_attrs], [want, *want_attrs]):
            g = g.numpy()
            assert (np.abs(g - w) <= np.spacing(np.abs(w))).all()

    def test_round_capacity_and_dynamic_selection(self):
        for n, h in ((1, 4.0), (1024, 1.0), (3000, 1.5), (5000, 0.5)):
            assert t_build.round_capacity(n, h) == j_build.round_capacity(
                n, h)
        j, t = _track_pair("pose")
        slow = t_tracks.ActorTrack(t.size, t.translations * 0, t.quats,
                                   t.present, "8")
        walker = t_tracks.ActorTrack(t.size, t.translations, t.quats,
                                     t.present, "9", "pedestrian")
        assert t_build.select_dynamic_tracks([t, slow, walker]) == [t]
        assert len(j_build.select_dynamic_tracks([j])) == 1


# -- synthetic scenes -----------------------------------------------------


class TestSynthetic:
    def test_render_frame_gt(self):
        """Ranges within 2 ulp at 80 m; the hit masks agree."""
        frames, track = j_syn.generate(num_frames=3, height=16, width=128)
        got, t_track = t_syn.generate(num_frames=3, height=16, width=128,
                                      device="cpu")
        same(got.range1 > 0, frames.range1 > 0)
        close(got.range1, frames.range1, atol=0.0, rtol=1e-6)
        close(got.intensity1, frames.intensity1)
        same(got.sensor2world, frames.sensor2world)
        assert (got.train_frames, got.eval_frames) == (frames.train_frames,
                                                       frames.eval_frames)
        for f in ("size", "translations", "quats", "present"):
            same(getattr(t_track, f), getattr(track, f))

    def test_render_frame_gt_dual(self, dual_frames):
        j, t = dual_frames
        scene = j_syn.default_scene()
        got = t_syn.render_frame_gt_dual(scene, t.grid, 96,
                                         j.sensor2world[1], 1)
        for g, w in zip(got, (j.range1[1], j.intensity1[1], j.range2[1],
                              j.intensity2[1])):
            same(g > 0, w > 0)
            close(g, w, atol=0.0, rtol=1e-6)


# -- writers and loaders --------------------------------------------------


def _waymo_arrays(h=8, w=64, frames=3):
    """A small dual-return segment with one moving vehicle, made by the
    reference's synthetic scene (the rehearsal generator's recipe)."""
    scene = j_syn.default_scene()
    beams = np.linspace(-0.31, 0.04, h)
    extrinsic = np.eye(4)
    extrinsic[:2, :2] = [[np.cos(0.05), -np.sin(0.05)],
                         [np.sin(0.05), np.cos(0.05)]]
    extrinsic[2, 3] = 2.1
    grid = j_rays.SensorGrid.from_beams(f32(beams), 0.5, 0.05)
    ego = np.tile(np.eye(4), (frames, 1, 1))
    ego[:, :3, 3] = [[f * 0.55, 0.02 * f, 0.0] for f in range(frames)]
    imgs, labels = [], []
    for f in range(frames):
        imgs.append(j_syn.render_frame_gt_dual(scene, grid, w,
                                               ego[f] @ extrinsic, f))
        inv = np.linalg.inv(ego[f])
        labels.append([(f"veh_{a}", inv[:3, :3] @ c + inv[:3, 3], b.size,
                        b.yaw)
                       for a, (b, c) in enumerate(scene.moving_boxes(f))])
    r1, i1, r2, i2 = (np.stack([im[k] for im in imgs]) for k in range(4))
    return dict(ego2world=ego, extrinsic=extrinsic, beam_inclinations=beams,
                range1=r1, intensity1=i1, range2=r2, intensity2=i2,
                labels_per_frame=labels)


def _kitti_arrays(frames=3):
    scene = j_syn.default_scene()
    grid = j_rays.SensorGrid.from_bounds(
        j_kitti.H, (j_kitti.INC_BOTTOM, j_kitti.INC_TOP))
    poses = np.tile(np.eye(4), (frames, 1, 1))
    poses[:, :3, 3] = [[f * 0.5, 0.0, 1.73] for f in range(frames)]
    imgs = [j_syn.render_frame_gt(scene, grid, j_kitti.W, poses[f], f)
            for f in range(frames)]
    actor = scene.actor
    boxes = {}
    for f in range(frames):
        tr = np.eye(4)
        tr[:3, :3] = actor.rotation() @ np.diag(actor.size)
        tr[:3, 3] = actor.center + f * scene.actor_velocity
        boxes[f] = tr
    return dict(seq="0000", sensor2world=poses,
                range1=np.stack([r for r, _ in imgs]),
                intensity1=np.stack([i for _, i in imgs]),
                boxes=[("11", boxes)])


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fp:
                out[os.path.relpath(path, root)] = fp.read()
    return out


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Both datasets written by both packages' writers."""
    root = tmp_path_factory.mktemp("written")
    waymo, kitti = _waymo_arrays(), _kitti_arrays()
    for pkg, mod in (("ref", j_writers), ("port", t_writers)):
        mod.write_waymo_segment(str(root / pkg / "waymo"), **waymo)
        mod.write_kitti360_sequence(str(root / pkg / "kitti"), **kitti)
    return root


def _frames_equal(t, j):
    for f in ("range1", "intensity1", "range2", "intensity2",
              "sensor2world"):
        want = getattr(j, f)
        if want is None:
            assert getattr(t, f) is None, f
        else:
            same(getattr(t, f), want, f)
    same(t.grid.row_inclinations, j.grid.row_inclinations)
    assert (t.grid.pixel_offset, t.grid.angle_offset) == (
        j.grid.pixel_offset, j.grid.angle_offset)
    assert (t.width, t.frame_numbers, t.train_frames, t.eval_frames) == (
        j.width, j.frame_numbers, j.train_frames, j.eval_frames)


def _tracks_equal(t, j):
    assert len(t) == len(j) > 0
    for a, b in zip(t, j):
        assert (a.object_id, a.object_type) == (b.object_id, b.object_type)
        for f in ("size", "translations", "present"):
            same(getattr(a, f), getattr(b, f), f)
        close(a.quats, b.quats)


class TestWritersAndLoaders:
    def test_writers_byte_identical(self, written):
        for dataset, files in (("waymo", 1), ("kitti", 5)):
            ref = _tree_bytes(written / "ref" / dataset)
            port = _tree_bytes(written / "port" / dataset)
            assert sorted(port) == sorted(ref) and len(ref) == files
            for name in ref:
                assert port[name] == ref[name], name

    @pytest.mark.parametrize("use_native", [True, False],
                             ids=["native", "python"])
    def test_waymo_loaders_equal(self, written, tmp_path, use_native):
        base = tmp_path / "waymo"
        shutil.copytree(written / "ref" / "waymo", base)
        j_args = Args({"frame_length": [0, 2], "eval_frames": [1]})
        t_args = SimpleNamespace(frame_length=[0, 2], eval_frames=[1])
        j_frames, j_tracks_ = j_waymo.load(str(base), j_args,
                                           use_native=False)
        shutil.rmtree(base / "cache")        # parse again, not the cache
        frames, tracks = t_waymo.load(str(base), t_args,
                                      use_native=use_native, device="cpu")
        _frames_equal(frames, j_frames)
        _tracks_equal(tracks, j_tracks_)
        assert frames.range1.device.type == "cpu"
        # The cache the port wrote reads back the same.
        again, _ = t_waymo.load(str(base), t_args, device="cpu")
        _frames_equal(again, j_frames)

    def test_native_decode_matches_python_parser(self, written):
        assert native.available(), native.build_error()
        path = next((written / "port" / "waymo").glob("*.tfrecord"))
        buf = path.read_bytes()
        offs, lens = native.tfrecord_index(buf)
        records = list(t_waymo.pw.tfrecord_iter(str(path)))
        assert len(records) == len(offs) == 3
        for i in (0, 2):
            rec = buf[offs[i]:offs[i] + lens[i]]
            assert rec == records[i]
            fd = native.waymo_decode_frame(rec)
            parsed = t_waymo._FrameParse(rec)
            r1, r2 = parsed.top_range_images()
            same(fd.r1, r1)
            same(fd.r2, r2)
            same(fd.pose.astype(np.float32), parsed.pose())
        assert native.library_path().parent.name == "_build"

    def test_kitti_loaders_equal(self, written):
        base = str(written / "ref" / "kitti")
        j_args = Args({"frame_length": [0, 2], "dynamic": True})
        t_args = SimpleNamespace(frame_length=[0, 2], dynamic=True)
        j_frames, j_tracks_ = j_kitti.load(base, j_args)
        frames, tracks = t_kitti.load(base, t_args, device="cpu")
        _frames_equal(frames, j_frames)
        _tracks_equal(tracks, j_tracks_)
        assert float((frames.range1 > 0).float().mean()) > 0.3


# -- options --------------------------------------------------------------


@pytest.mark.parametrize("dataset", ["waymo", "kitti"])
def test_rehearsal_options_hold_the_config_files(dataset):
    """rehearsal_options holds configs/rehearsal/exp.yaml merged with the
    data config as the reference's CLI merges them (the experiment
    config's values win)."""
    files = parse(f"configs/rehearsal/{dataset}.yaml",
                  parse("configs/rehearsal/exp.yaml")).to_dict()
    ns = options.rehearsal_options(dataset)
    assert vars(ns.opt) == files["opt"]
    assert vars(ns.model) == {k: files["model"][k] for k in options.MODEL}
    assert vars(ns.tracer) == files["tracer"]
    for key in options.REHEARSAL_DATA[dataset]:
        assert getattr(ns, key) == files[key], key
    assert vars(options.experiment_options().model) == {
        k: parse("configs/exp.yaml").model[k] for k in options.MODEL}
    cfg, warm, until = options.trace_configs(ns)
    assert (cfg.tile.max_per_tile, warm.tile.max_per_tile, until) == (
        256, 512, 2000)
    assert (cfg.tail_passes, cfg.tile.binner, cfg.tile.tile_w) == (
        1, "hier", 128)
    assert warm.tile.tile_h == cfg.tile.tile_h == 8
    with pytest.raises(KeyError):
        options.rehearsal_options("nuscenes")
