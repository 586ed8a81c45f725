"""The port's eval layer against `lidar_rt_tpu.eval`: the metric suite
(1e-9 relative, float64), the EvalRunner on a synthetic dual-return scene
crossed to the port with `scene_from_numpy` (per-frame metric tables
within 1e-4 relative, predicted-hit masks identical except pixels within
1e-5 of the 0.4 threshold), with and without a refining U-Net, and LPIPS
(atol 1e-5)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu.config import default_experiment
from lidar_rt_tpu.data import build as j_build
from lidar_rt_tpu.data import synthetic as j_syn
from lidar_rt_tpu.eval import lpips as j_lpips
from lidar_rt_tpu.eval import metrics as j_metrics
from lidar_rt_tpu.eval.runner import EvalRunner as JEvalRunner
from lidar_rt_tpu.models import unet as j_unet
from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu.ops.binning import TileConfig as JTileConfig
from lidar_rt_tpu.scene import compose as j_compose
from lidar_rt_tpu.train import refine as j_refine
from lidar_rt_tpu_torch.data.frames import LiDARFrames
from lidar_rt_tpu_torch.eval import lpips, metrics
from lidar_rt_tpu_torch.eval.runner import EvalRunner
from lidar_rt_tpu_torch.models import unet
from lidar_rt_tpu_torch.ops import tracer
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.scene import convert
from lidar_rt_tpu_torch.train import refine
from test_torch_data import _port_grid
from _torch_parity import scene_arrays

torch.set_num_threads(1)

REL = 1e-9          # metric suite: the same float64 arithmetic
RUNNER_REL = 1e-4   # runner: renders within the tracer's float32 bars
H, W = 16, 128


def _images(seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 60, (H, W))
    gt[rng.uniform(size=gt.shape) < 0.2] = 0.0
    pred = np.clip(gt + rng.normal(0, 2.0, gt.shape), 0, 90)
    return gt, pred


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_image_metrics_match(seed):
    gt, pred = _images(seed)
    for name in ("depth_metrics", "intensity_metrics"):
        scale = 1.0 if name == "depth_metrics" else 1.0 / 60
        got = getattr(metrics, name)(gt * scale, pred * scale)
        want = getattr(j_metrics, name)(gt * scale, pred * scale)
        assert list(got) == list(want)
        for k in got:
            if np.isnan(want[k]):
                assert np.isnan(got[k])
            else:
                assert got[k] == pytest.approx(want[k], rel=REL, abs=0), k
    drop_gt = (gt == 0).astype(np.float64)
    drop_pred = np.random.default_rng(seed).uniform(size=gt.shape)
    got = metrics.raydrop_metrics(drop_gt, drop_pred)
    assert got == pytest.approx(j_metrics.raydrop_metrics(drop_gt,
                                                          drop_pred),
                                rel=REL)
    assert metrics.ssim_skimage(gt, pred, 60.0) == pytest.approx(
        j_metrics.ssim_skimage(gt, pred, 60.0), rel=REL)


@pytest.mark.parametrize("seed,n,m", [(0, 700, 900), (1, 3000, 257),
                                      (2, 64, 64)])
def test_points_metrics_match(seed, n, m):
    """Clouds on a 1/16 m grid within 4 m of the origin: every float32
    operation of both packages' distance searches is exact, so they agree
    to the reference's float64 arithmetic after it."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-64, 64, (n, 3)) / 16.0
    near = a[rng.integers(0, n, m // 2)] + rng.integers(-4, 5, (m // 2, 3)) \
        / 16.0
    b = np.concatenate([near, rng.integers(-64, 64, (m - m // 2, 3)) / 16.0])
    got = metrics.points_metrics(torch.as_tensor(a), torch.as_tensor(b))
    want = j_metrics.points_metrics(a, b)
    assert got == pytest.approx(want, rel=REL)
    assert 0.0 < got["fscore"] < 1.0


def test_points_fscore_compares_squared_distances():
    """offset 0.21: squared 0.0441 < 0.05 is a hit; 0.23: 0.0529 is not
    (the reference's convention, not ops.chamfer.fscore's)."""
    a = np.zeros((10, 3))
    for off, want in ((0.21, 1.0), (0.23, 0.0)):
        b = a + np.array([off, 0, 0])
        got = metrics.points_metrics(torch.as_tensor(a), torch.as_tensor(b))
        assert got["fscore"] == want == j_metrics.points_metrics(
            a, b)["fscore"]
    empty = metrics.points_metrics(torch.zeros(0, 3), torch.ones(5, 3))
    assert np.isnan(empty["chamfer_dist"]) and empty["fscore"] == 0.0


@pytest.fixture(scope="module")
def dual_scene():
    """A synthetic dual-return sequence, its reference scene grown (scales
    x e) and made opaque enough that about a quarter of the rays register
    a return, and the port's copies of both."""
    frames, track = j_syn.generate(num_frames=2, height=H, width=W)
    frames.range2 = np.where(frames.range1 > 0, frames.range1 + 2.0, 0.0)
    frames.intensity2 = frames.intensity1 * 0.5
    args = default_experiment()
    scene = j_build.assemble_scene(frames, [track], args,
                                   capacity_headroom=1.0)
    bg = scene.background
    scene = dataclasses.replace(scene, background=dataclasses.replace(
        bg, opacity_logit=jnp.where(bg.alive, 2.0, bg.opacity_logit),
        log_scale=jnp.where(bg.alive[:, None], bg.log_scale + 1.0,
                            bg.log_scale)))
    t_frames = LiDARFrames.from_numpy(
        _port_grid(frames.grid), frames.sensor2world, frames.range1,
        frames.intensity1, device="cpu", train_frames=frames.train_frames,
        eval_frames=frames.eval_frames, range2=frames.range2,
        intensity2=frames.intensity2)
    t_scene = convert.scene_from_numpy(scene_arrays(scene), device="cpu")
    return frames, scene, args, t_frames, t_scene


def _unets(rng):
    """The reference's U-Net with flax's initial weights and running
    statistics off their initial values, and the port's copy."""
    model = j_unet.RayDropUNet(in_ch=9)
    v = jax.tree.map(np.asarray, model.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, H, W, 9)), train=False))
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.05 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    # A head bias that puts the refined ray-drop on both sides of 0.4.
    v["params"]["Conv_1"]["bias"] = v["params"]["Conv_1"]["bias"] - 0.3
    port = unet.make_unet(9, "cpu")
    port.load_state_dict({k: torch.as_tensor(a) for k, a in
                          unet.unet_state_from_flax(v).items()})
    return model, v, port


def _eager(runner):
    """The reference runner's render, not jitted: the port is held to the
    reference's eager render (XLA's jit rounding flips single gates,
    ROADMAP C)."""
    def render(scene, frame, pose):
        bundle, _ = j_compose(scene, frame)
        return j_tracer.render_frame(
            bundle, runner.frames.grid, runner.frames.width, pose,
            scene.background.active_sh_degree, runner.cfg,
            bool(runner.args.opt.use_rayhit))
    runner._render_fn = render
    return runner


def _compare_tables(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _compare_tables(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, str):
        assert got == want, path
    elif np.isnan(want):
        assert np.isnan(got), path
    else:
        assert got == pytest.approx(want, rel=RUNNER_REL, abs=1e-12), path


@pytest.mark.parametrize("with_unet", [False, True])
def test_runner_matches_reference(dual_scene, with_unet, tmp_path):
    frames, scene, args, t_frames, t_scene = dual_scene
    tile = dict(tile_h=8, tile_w=32, max_per_tile=256)
    j_cfg = j_tracer.TraceConfig(tile=JTileConfig(**tile), tile_batch=2,
                                 engine="jax")
    t_cfg = tracer.TraceConfig(tile=TileConfig(**tile), tile_batch=2)
    j_apply = t_apply = None
    if with_unet:
        model, v, port = _unets(np.random.default_rng(1))

        def j_apply(f, out):
            origin, dirs = frames.rays(f)
            return j_refine.apply_unet(
                model, v, out["raydrop"], out["intensity"], out["depth"],
                jnp.broadcast_to(origin, dirs.shape), dirs)

        def t_apply(f, out):
            origin, dirs = t_frames.rays(f)
            return refine.apply_unet(port, out["raydrop"], out["intensity"],
                                     out["depth"], origin.expand_as(dirs),
                                     dirs)

    j_run = _eager(JEvalRunner(scene, frames, args, j_cfg,
                               unet_apply=j_apply))
    t_run = EvalRunner(t_scene, t_frames, args, t_cfg, unet_apply=t_apply)
    for f in range(frames.num_frames):
        j_rec, t_rec = j_run.record_render(f), t_run.record_render(f)
        near = np.abs(j_rec["raydrop"] - 0.4) <= 1e-5
        assert np.array_equal(t_rec["rayhit"][~near],
                              j_rec["rayhit"][~near])
        assert 0.05 < t_rec["rayhit"].mean() < 0.95
        np.testing.assert_allclose(t_rec["raydrop"], j_rec["raydrop"],
                                   rtol=0, atol=2e-4)
    want = j_run.run("all", str(tmp_path / "ref"))
    got = t_run.run("all", str(tmp_path / "port"))
    assert "depth_return2" in got["mean"]
    assert np.isfinite(got["mean"]["points"]["chamfer_dist"])
    assert got["mean"]["depth"]["lpips_loss"] == "unavailable(no-weights)"
    _compare_tables(got["per_frame"], want["per_frame"])
    _compare_tables(got["mean"], want["mean"])
    with open(tmp_path / "port" / "results_all.json") as fp:
        assert json.load(fp)["num_frames"] == frames.num_frames


def test_runner_writes_artifacts(dual_scene, tmp_path):
    _, _, args, t_frames, t_scene = dual_scene
    cfg = tracer.TraceConfig(tile=TileConfig(tile_h=16, tile_w=64,
                                             max_per_tile=64))
    runner = EvalRunner(t_scene, t_frames, args, cfg, use_gt_mask=True)
    runner.run("test", str(tmp_path), save_images=True, save_metrics=False)
    names = os.listdir(tmp_path / "images")
    f = t_frames.eval_frames[0]
    assert {f"frame_{f:04d}.png", f"gt_{f:04d}.ply",
            f"pred_{f:04d}.ply"} <= set(names)
    assert (tmp_path / "depth_anim.png").exists()
    assert not (tmp_path / "results_all.json").exists()


def _lpips_pair():
    params = j_lpips.init_params(jax.random.key(0))
    alex, lins = {}, {}
    for i, idx in enumerate(lpips.FEATURE_INDEX):
        alex[f"features.{idx}.weight"] = np.asarray(params[f"conv{i}_w"])
        alex[f"features.{idx}.bias"] = np.asarray(params[f"conv{i}_b"])
        lins[f"lin{i}.model.1.weight"] = np.asarray(params[f"lin{i}_w"])
    return params, alex, lins


@pytest.mark.parametrize("shape", [(32, 96), (64, 64)])
def test_lpips_matches_reference(shape):
    params, alex, lins = _lpips_pair()
    model = lpips.load_state(lpips.new_lpips("cpu"), alex, lins)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 3, *shape)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 3, *shape)).astype(np.float32)
    want = np.asarray(j_lpips.lpips(params, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = model(torch.as_tensor(x), torch.as_tensor(y)).numpy()
        feats = model.features(torch.as_tensor(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert [f.shape[1] for f in feats] == lpips.N_CHANNELS


def test_lpips_weights_from_pth_files(tmp_path, monkeypatch):
    """$LIDAR_RT_LPIPS_WEIGHTS names the two .pth state dicts, loaded as
    they are; missing files give None (the metric reads unavailable)."""
    params, alex, lins = _lpips_pair()
    a_pth, l_pth = tmp_path / "alexnet.pth", tmp_path / "alex.pth"
    torch.save({k: torch.as_tensor(v) for k, v in alex.items()}, a_pth)
    torch.save({f"{i}.1.weight": torch.as_tensor(lins[
        f"lin{i}.model.1.weight"]) for i in range(5)}, l_pth)
    monkeypatch.setenv(lpips.ENV_VAR, f"{a_pth}{os.pathsep}{l_pth}")
    fn = lpips.make_lpips_fn(device="cpu")
    rng = np.random.default_rng(1)
    gt = rng.uniform(0, 1, (32, 48)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(
        np.float32)
    assert fn(gt, gt) == pytest.approx(0.0, abs=1e-9)
    want = j_lpips.make_lpips_fn(params=params)(pred, gt)
    assert fn(pred, gt) == pytest.approx(want, abs=1e-5)
    monkeypatch.setenv(lpips.ENV_VAR, str(tmp_path / "missing.pth"))
    assert lpips.make_lpips_fn(device="cpu") is None
    monkeypatch.delenv(lpips.ENV_VAR)
    assert lpips.make_lpips_fn(device="cpu") is None


def _lpips_images(seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, (32, 48)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(
        np.float32)
    return pred, gt


def test_lpips_weights_from_reference_npz(tmp_path, monkeypatch):
    """$LIDAR_RT_LPIPS_WEIGHTS in the reference's form, one `.npz` written
    by the reference's converter from fabricated state dicts: the port
    reads it and gives the reference's LPIPS to 1e-6; a missing `.npz`
    gives None, as in the reference."""
    params, alex, lins = _lpips_pair()
    out = str(tmp_path / "lpips.npz")
    j_lpips.convert_torch_checkpoints(alex, lins, out)
    monkeypatch.setenv(lpips.ENV_VAR, out)
    fn = lpips.make_lpips_fn(device="cpu")
    pred, gt = _lpips_images(2)
    want = j_lpips.make_lpips_fn(weights_path=out)(pred, gt)
    assert want > 0.0
    assert fn(pred, gt) == pytest.approx(want, abs=1e-6)
    assert lpips.make_lpips_fn(weights=out, device="cpu")(
        pred, gt) == pytest.approx(want, abs=1e-6)
    monkeypatch.setenv(lpips.ENV_VAR, str(tmp_path / "missing.npz"))
    assert lpips.make_lpips_fn(device="cpu") is None
    assert j_lpips.make_lpips_fn() is None


@pytest.mark.parametrize("lin_keys", ["short", "long"])
def test_lpips_converter_writes_the_reference_npz(tmp_path, lin_keys):
    """The port's converter, from torch tensors in either key layout of
    the lin heads, writes the reference's `.npz` layout: the same arrays as
    the reference's converter, read by the reference to the same LPIPS
    (1e-6)."""
    params, alex, lins = _lpips_pair()
    if lin_keys == "short":
        lins = {f"{i}.1.weight": lins[f"lin{i}.model.1.weight"]
                for i in range(5)}
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    lpips.convert_torch_checkpoints(
        {k: torch.as_tensor(v) for k, v in alex.items()},
        {"state_dict": {k: torch.as_tensor(v) for k, v in lins.items()}},
        ours)
    j_lpips.convert_torch_checkpoints(alex, lins, theirs)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            assert a[key].dtype == b[key].dtype
    pred, gt = _lpips_images(3)
    want = j_lpips.make_lpips_fn(params=params)(pred, gt)
    assert j_lpips.make_lpips_fn(weights_path=ours)(
        pred, gt) == pytest.approx(want, abs=1e-6)
    assert lpips.make_lpips_fn(weights=ours, device="cpu")(
        pred, gt) == pytest.approx(want, abs=1e-6)


def test_lpips_converter_command_line(tmp_path, capsys):
    """`python -m lidar_rt_tpu_torch.eval.lpips alexnet.pth alex.pth
    out.npz --device cpu` writes the file and prints its self-check."""
    _, alex, lins = _lpips_pair()
    a_pth, l_pth = tmp_path / "alexnet.pth", tmp_path / "alex.pth"
    torch.save({k: torch.as_tensor(v) for k, v in alex.items()}, a_pth)
    torch.save({k: torch.as_tensor(v) for k, v in lins.items()}, l_pth)
    out = tmp_path / "lpips.npz"
    lpips.main([str(a_pth), str(l_pth), str(out), "--device", "cpu"])
    assert out.exists()
    assert "self-check LPIPS" in capsys.readouterr().out
