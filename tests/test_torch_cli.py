"""The port's CLI end to end on the CPU (`--device cpu`, a synthetic 8x64
scene): the reference's tests/test_cli.py cases, a TrainState checkpoint
that resumes bit-identically, the non-finite guard's snapshot, the
reference-checkpoint import against `lidar_rt_tpu.utils.import_torch`,
and the copied utilities (console colours, the recorder, splat PLYs,
profiling hooks)."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lidar_rt_tpu.config import Args, default_experiment
from lidar_rt_tpu.data import build as j_build
from lidar_rt_tpu.data import synthetic as j_syn
from lidar_rt_tpu.utils import import_torch as j_import
from lidar_rt_tpu_torch import cli
from lidar_rt_tpu_torch.data import synthetic
from lidar_rt_tpu_torch.data.build import assemble_scene
from lidar_rt_tpu_torch.ops import tracer
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.scene import Scene, convert
from lidar_rt_tpu_torch.train import loop, options
from lidar_rt_tpu_torch.utils import (checkpoint, console, export,
                                      import_torch, profiling, record)
from _torch_parity import scene_arrays

torch.set_num_threads(1)

H, W = 8, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    exp = root / "exp.yaml"
    exp.write_text(f"""
parent_config: "{REPO}/configs/exp.yaml"
model_dir: "{root}/output"
task_name: clitest
testing_iterations: 2
saving_iterations: [4]
opt:
  iterations: 4
  densify_from_iter: 100
  rebin_interval: 1
refine:
  use_refine: false
  use_spatial: true
  epochs: 1
  batch_size: 2
tracer:
  tile_h: {H}
  tile_w: {W}
  max_per_tile: 32
  tile_batch: 2
""")
    data = root / "data.yaml"
    data.write_text(f"""
dataset: synthetic
scene_id: s1
synthetic:
  num_frames: 2
  height: {H}
  width: {W}
""")
    return str(data), str(exp), str(root / "output")


def _mdir(out):
    return os.path.join(out, "clitest", "exp", "scene_s1")


@pytest.fixture(scope="module")
def trained(configs):
    data, exp, _ = configs
    cli.main(["train", "-dc", data, "-ec", exp, "--device", "cpu"])
    return configs


class TestTrainCLI:
    def test_writes_artifacts(self, trained):
        mdir = _mdir(trained[2])
        assert os.path.isdir(mdir), "output nests under scene_<id>"
        names = os.listdir(os.path.join(mdir, "models"))
        assert "ckpt_it_4_good.npz" in names or "ckpt_it_4.npz" in names
        with open(os.path.join(mdir, "logs", "log.json")) as f:
            log = json.load(f)
        assert [h["iteration"] for h in log["history"]] == [1, 2, 3, 4]
        assert [e["iteration"] for e in log["eval_history"]] == [2, 4]
        assert {"load", "assemble", "steps", "periodic_eval"} <= set(
            log["seconds"])
        assert os.path.exists(os.path.join(mdir, "logs", "log.png"))
        assert sorted(os.listdir(os.path.join(mdir, "visuals"))) == [
            "it_000002.png", "it_000004.png"]
        assert os.path.exists(os.path.join(mdir, "logs", "scalars.jsonl"))

    def test_resume_continues(self, trained):
        data, exp, out = trained
        trainer = cli.main_train(["-dc", data, "-ec", exp, "--resume",
                                  "--iterations", "6", "--device", "cpu"])
        assert trainer.iteration == 6
        with open(os.path.join(_mdir(out), "logs", "log.json")) as f:
            log = json.load(f)
        # The resumed run continues the history it resumed.
        assert [h["iteration"] for h in log["history"]] == list(range(1, 7))
        assert [e["iteration"] for e in log["eval_history"]] == [2, 4, 6]

    def test_only_refine_requires_model(self, configs):
        data, exp, _ = configs
        with pytest.raises(SystemExit):
            cli.main_train(["-dc", data, "-ec", exp, "-r", "--device",
                            "cpu"])

    def test_only_refine_skips_training(self, trained):
        data, exp, out = trained
        mdir = _mdir(out)
        ckpt = checkpoint.find_best(os.path.join(mdir, "models"))
        trainer = cli.main_train(["-dc", data, "-ec", exp, "-m", ckpt, "-r",
                                  "--device", "cpu"])
        # -r forces the U-Net phase with refine.use_refine false, and runs
        # no optimization step.
        with open(os.path.join(mdir, "logs", "log.json")) as f:
            saved = json.load(f)
        assert trainer.iteration == saved["history"][-1]["iteration"]
        weights, meta = checkpoint.load(os.path.join(mdir, "models",
                                                     "unet.npz"))
        assert meta["in_ch"] == 9 and np.isfinite(meta["final_loss"])
        assert "head.weight" in weights

    def test_unknown_command(self):
        with pytest.raises(SystemExit):
            cli.main(["serve"])

    @pytest.mark.parametrize("module", ["lidar_rt_tpu_torch.cli",
                                        "lidar_rt_tpu_torch"])
    def test_python_dash_m_entry_points(self, module):
        """Both `python -m` entry points reach the CLI's dispatch."""
        proc = subprocess.run([sys.executable, "-m", module, "serve"],
                              cwd=REPO, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 1
        assert "usage: python -m lidar_rt_tpu_torch.cli" in proc.stderr


class TestEvalCLI:
    def test_flags_gate_artifacts(self, trained, capsys):
        data, exp, out = trained
        metrics = os.path.join(_mdir(out), "metrics")
        cli.main_eval(["-dc", data, "-ec", exp, "-t", "train", "--device",
                       "cpu"])
        assert "depth" in capsys.readouterr().out
        assert not os.path.exists(os.path.join(metrics, "results_all.json"))

        res = cli.main(["eval", "-dc", data, "-ec", exp, "-t", "all", "-e",
                        "-i", "-p", "--device", "cpu"])
        assert os.path.exists(os.path.join(metrics, "results_all.json"))
        imgs = os.listdir(os.path.join(metrics, "images"))
        assert any(n.endswith(".png") for n in imgs)
        assert any(n.endswith(".ply") for n in imgs)
        assert os.path.exists(os.path.join(metrics, "depth_anim.png"))
        with open(os.path.join(metrics, "results_all.json")) as f:
            saved = json.load(f)
        assert saved["num_frames"] == res["num_frames"] == 2
        assert np.isfinite(saved["mean"]["depth"]["rmse"])
        assert saved["mean"]["depth"]["lpips_loss"] == \
            "unavailable(no-weights)"

    def test_missing_checkpoint_raises(self, configs, tmp_path):
        data, exp, _ = configs
        other = tmp_path / "exp.yaml"
        other.write_text(f"parent_config: \"{exp}\"\n"
                         f"model_dir: \"{tmp_path}/none\"\n")
        with pytest.raises(FileNotFoundError):
            cli.main_eval(["-dc", data, "-ec", str(other), "--device",
                           "cpu"])


# -- checkpoints ---------------------------------------------------------


def _small_trainer(seed=1):
    frames, track = synthetic.generate(num_frames=2, height=16, width=64,
                                       device="cpu")
    args = options.experiment_options(
        seed=seed, densify_from_iter=2, densification_interval=5,
        sh_increase_interval=3, rebin_interval=3)
    scene = assemble_scene(frames, [track], args, capacity_headroom=2.0)
    cfg = tracer.TraceConfig(tile=TileConfig(tile_h=8, tile_w=64,
                                             max_per_tile=64), tile_batch=2)
    return loop.Trainer(scene, frames, args, cfg)


def _state_arrays(state: loop.TrainState) -> dict:
    out = {}
    for part in ("background", "actors"):
        asset = getattr(state.scene, part)
        for k, v in asset.params().items():
            out[f"{part}.{k}"] = v
        out[f"{part}.alive"] = asset.alive
        out[f"{part}.degree"] = torch.tensor(asset.active_sh_degree)
    for name in ("opt_bg", "opt_actors"):
        opt = getattr(state, name)
        out[f"{name}.steps"] = torch.tensor(opt.steps)
        for g, p in opt.params.items():
            for k, v in opt.adam.state[p].items():
                out[f"{name}.{g}.{k}"] = v
    for name in ("stats_bg", "stats_actors"):
        for k, v in getattr(state, name)._asdict().items():
            out[f"{name}.{k}"] = v
    out["generator"] = state.generator.get_state()
    return out


def test_train_state_resumes_bit_identically(tmp_path):
    """4 steps, save, load into a new trainer, 2 more, against 6 steps
    uninterrupted; the SH warm-up (step 3, 6) and a densify event (step 5,
    which draws from the generator) fall inside.  A loaded state has a
    fresh bin cache, so the uninterrupted run's cache is made stale at
    step 4 too (the one difference the checkpoint allows)."""
    straight = _small_trainer()
    straight.run(4, log_every=1)
    straight._invalidate_bins()
    straight.run(2, log_every=1)

    first = _small_trainer()
    first.run(4, log_every=1)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, first.state, {"iteration": first.iteration})
    state, meta = checkpoint.load(path, "cpu", opt_args=first.args.opt)
    assert meta == {"iteration": 4} and state.bins is None
    resumed = _small_trainer()
    resumed.restore(state, meta["iteration"])
    assert resumed.state.bins.age == [loop.STALE_AGE] * 2
    resumed.run(2, log_every=1)

    assert straight.densify_log and straight.densify_log == \
        resumed.densify_log
    assert [h["loss"] for h in straight.history[4:]] == \
        [h["loss"] for h in resumed.history]
    want, got = _state_arrays(straight.state), _state_arrays(resumed.state)
    assert sorted(want) == sorted(got)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_scene_and_mapping_round_trip(tmp_path):
    trainer = _small_trainer()
    scene = trainer.state.scene
    path = str(tmp_path / "scene.npz")
    checkpoint.save(path, scene, {"iteration": 7})
    for loaded, meta in (checkpoint.load(path, "cpu"),
                         checkpoint.load_scene(path, "cpu")):
        assert isinstance(loaded, Scene) and meta == {"iteration": 7}
        for part in ("background", "actors"):
            a, b = getattr(loaded, part), getattr(scene, part)
            for f in convert.ASSET_FIELDS:
                assert torch.equal(getattr(a, f), getattr(b, f)), f
            assert (a.active_sh_degree, a.max_sh_degree, a.extent) == (
                b.active_sh_degree, b.max_sh_degree, b.extent)
        for f in convert.TRACK_FIELDS:
            assert torch.equal(getattr(loaded.tracks, f),
                               getattr(scene.tracks, f))
    state_path = str(tmp_path / "state.npz")
    checkpoint.save(state_path, trainer.state)
    scene2, _ = checkpoint.load_scene(state_path, "cpu")
    assert torch.equal(scene2.background.xyz, scene.background.xyz)
    with pytest.raises(ValueError, match="opt_args"):
        checkpoint.load(state_path, "cpu")
    tree = {"a": {"b": torch.arange(3)}, "c": np.ones((2, 2))}
    checkpoint.save(str(tmp_path / "d.npz"), tree, {"x": 1})
    flat, meta = checkpoint.load(str(tmp_path / "d.npz"))
    assert sorted(flat) == ["a.b", "c"] and meta == {"x": 1}
    np.testing.assert_array_equal(flat["a.b"], [0, 1, 2])
    with np.load(str(tmp_path / "d.npz"), allow_pickle=False) as z:
        assert "__kind__" in z.files


def test_best_retention(tmp_path):
    d = str(tmp_path)
    state = {"x": torch.arange(3)}
    checkpoint.retain_best(d, 100, state, is_best=False)
    checkpoint.retain_best(d, 200, state, is_best=True)
    assert checkpoint.find_best(d).endswith("ckpt_it_200_good.npz")
    checkpoint.retain_best(d, 300, state, is_best=True)
    names = sorted(os.listdir(d))
    assert "ckpt_it_200_good.npz" not in names
    assert checkpoint.find_best(d).endswith("ckpt_it_300_good.npz")
    assert "ckpt_it_100.npz" in names
    assert checkpoint.find_best(str(tmp_path / "none")) is None


def test_guard_finite_snapshots_and_raises(tmp_path):
    state = {"x": torch.arange(4.0)}
    path = str(tmp_path / "snap.npz")
    profiling.guard_finite({"loss": 1.0, "iteration": 3}, state, path)
    assert not os.path.exists(path)
    with pytest.raises(FloatingPointError, match="non-finite"):
        profiling.guard_finite({"loss": float("nan")}, state, path,
                               context="it 7")
    restored, meta = checkpoint.load(path)
    assert "loss" in meta["reason"] and meta["context"] == "it 7"
    np.testing.assert_array_equal(restored["x"], np.arange(4.0))


def test_trainer_snapshots_a_non_finite_loss(tmp_path):
    trainer = _small_trainer()
    trainer.snapshot_dir = str(tmp_path / "snapshots")
    trainer.run(1, log_every=1)
    assert not os.path.exists(trainer.snapshot_dir)
    with torch.no_grad():
        trainer.state.scene.background.f_dc.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="iteration 2"):
        trainer.run(1, log_every=1)
    path = os.path.join(trainer.snapshot_dir, "snapshot_it2.npz")
    state, meta = checkpoint.load(path, "cpu", opt_args=trainer.args.opt)
    assert "non-finite" in meta["reason"]
    assert bool(torch.isnan(state.scene.background.f_dc).all())


def test_profiling_hooks(tmp_path):
    timer = profiling.StepTimer("cpu")
    assert timer.lap() >= 0.0
    with profiling.trace(str(tmp_path), device="cpu"):
        torch.ones(8).sum()
    assert (tmp_path / "trace.json").exists()
    profiling.enable_anomaly_detection(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_anomaly_detection(False)


# -- the copied utilities ----------------------------------------------


def test_console_colours(monkeypatch, capsys):
    monkeypatch.delenv("NO_COLOR", raising=False)
    monkeypatch.setenv("FORCE_COLOR", "1")
    assert console.red("x") == "\x1b[31mx\x1b[0m"
    monkeypatch.setenv("NO_COLOR", "1")
    assert console.red("x") == "x"
    console.warn("careful")
    assert "[warn] careful" in capsys.readouterr().out


def test_recorder(tmp_path):
    rec = record.Recorder(str(tmp_path))
    for v in (1.0, 3.0, 2.0):
        rec.update_loss_stats({"loss": v, "elapsed": 99.0})
    rec.step = 5
    row = rec.record("train")
    rec.close()
    assert row["loss"] == 2.0 and row["step"] == 5
    assert row["elapsed"] < 99.0
    line = json.loads((tmp_path / "scalars.jsonl").read_text())
    assert line["prefix"] == "train"


def test_splat_ply_of_a_port_asset(tmp_path):
    asset = _small_trainer().state.scene.background
    path = str(tmp_path / "bg.ply")
    export.write_splat_ply(path, asset)
    got = export.read_splat_ply(path)
    alive = asset.alive.numpy()
    np.testing.assert_array_equal(got["x"], asset.xyz.detach().numpy()[
        alive, 0])
    np.testing.assert_array_equal(got["opacity"],
                                  asset.opacity_logit.detach().numpy()[alive])
    assert len(got["__fields__"]) == 6 + 3 + 45 + 1 + 2 + 4


# -- reference checkpoints (.pth) ----------------------------------------


def _capture_tuple(rng, n, extent=42.0, active_deg=2, rest=15):
    """A LiDAR-RT GaussianModel.capture() 12-tuple (gaussian_model.py:58)."""
    def t(*s):
        return torch.tensor(rng.normal(size=s).astype(np.float32))

    return (active_deg, t(n, 3), t(n, 1, 3), t(n, rest, 3), t(n, 2),
            t(n, 4), t(n, 1), torch.zeros(n), torch.zeros(n, 1),
            torch.zeros(n, 1), {"state": {}, "param_groups": []}, extent)


@pytest.fixture(scope="module")
def templates():
    """The reference's template scene and the port's copy of it."""
    np.random.seed(0)
    frames, track = j_syn.generate(num_frames=2, height=8, width=64)
    j_template = j_build.assemble_scene(
        frames, [track], Args(default_experiment().to_dict()),
        key=jax.random.key(0))
    return j_template, convert.scene_from_numpy(scene_arrays(j_template),
                                                device="cpu")


@pytest.mark.parametrize("rest", [15, 8])
def test_import_matches_reference(templates, tmp_path, rest):
    j_template, t_template = templates
    rng = np.random.default_rng(7)
    tuples = [_capture_tuple(rng, 1500, rest=rest)] + [
        _capture_tuple(rng, 40 + 10 * i, extent=5.0 + i, rest=rest)
        for i in range(t_template.num_actors)]
    pth = tmp_path / "ckpt_it_30000_good.pth"
    torch.save((tuples, 30000), pth)
    j_scene, j_it = j_import.scene_from_reference(str(pth), j_template)
    t_scene, t_it = import_torch.scene_from_reference(str(pth), t_template)
    assert t_it == j_it == 30000
    want, got = scene_arrays(j_scene), scene_arrays(t_scene)
    for k in want:
        if not k.endswith("active_sh_degree"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert t_scene.background.active_sh_degree == 2
    assert t_scene.tracks is t_template.tracks


def test_import_refusals(templates, tmp_path):
    _, t_template = templates
    rng = np.random.default_rng(1)
    tup = list(_capture_tuple(rng, 10))
    tup[4] = torch.zeros(10, 3)
    with pytest.raises(ValueError, match="2D-surfel"):
        import_torch.asset_from_reference(tuple(tup), device="cpu")
    bad = tmp_path / "bad.pth"
    torch.save(([_capture_tuple(rng, 10)] * (t_template.num_actors + 3), 1),
               bad)
    with pytest.raises(ValueError, match="assets"):
        import_torch.scene_from_reference(str(bad), t_template)
    asset = import_torch.asset_from_reference(_capture_tuple(rng, 100),
                                              pad_multiple=1024,
                                              headroom=20.0, device="cpu")
    assert asset.capacity == 2048 and int(asset.num_alive) == 100
