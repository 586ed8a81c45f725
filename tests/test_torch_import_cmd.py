"""The reference-checkpoint workflow as commands, on the CPU (`--device
cpu`, a synthetic 8x64 scene): `python -m
lidar_rt_tpu_torch.scripts.import_reference_ckpt` against the reference's
importer on the reference's template, bit for bit; the export to the
reference's `.pth` layout (`utils.import_torch.scene_to_reference`) and
its re-import; and `python -m lidar_rt_tpu_torch.scripts.import_roundtrip`
end to end (export, import, a 2-step `--resume`, eval)."""

import json
import os

import numpy as np
import pytest
import torch

from lidar_rt_tpu import cli as j_cli
from lidar_rt_tpu import config as j_config
from lidar_rt_tpu.data import build as j_build
from lidar_rt_tpu.utils import import_torch as j_import
from lidar_rt_tpu_torch import cli
from lidar_rt_tpu_torch.scene import convert
from lidar_rt_tpu_torch.scripts import import_reference_ckpt, import_roundtrip
from lidar_rt_tpu_torch.utils import checkpoint, import_torch
from _torch_parity import scene_arrays

torch.set_num_threads(1)

H, W = 8, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _capture_tuple(rng, n, extent=42.0, active_deg=2):
    """A LiDAR-RT GaussianModel.capture() 12-tuple (gaussian_model.py:58)."""
    def t(*s):
        return torch.tensor(rng.normal(size=s).astype(np.float32))

    return (active_deg, t(n, 3), t(n, 1, 3), t(n, 15, 3), t(n, 2), t(n, 4),
            t(n, 1), torch.zeros(n), torch.zeros(n, 1), torch.zeros(n, 1),
            {"state": {}, "param_groups": []}, extent)


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    """A synthetic 8x64 data config with one actor, an experiment that
    trains 4 steps into `<root>/output`, and the round trip's experiment
    (its own task name, so its own model directory)."""
    root = tmp_path_factory.mktemp("import_cmd")
    exp = root / "exp.yaml"
    exp.write_text(f"""
parent_config: "{REPO}/configs/exp.yaml"
model_dir: "{root}/output"
task_name: importtest
testing_iterations: 2
saving_iterations: [4]
opt:
  iterations: 4
  densify_from_iter: 100
  rebin_interval: 1
refine:
  use_refine: false
tracer:
  tile_h: {H}
  tile_w: 16
  max_per_tile: 128
  tile_batch: 2
""")
    rt = root / "import_rt.yaml"
    rt.write_text(f"""
parent_config: "{exp}"
task_name: import_rt
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
    return str(data), str(exp), str(rt), root


def test_import_command_matches_reference(configs, tmp_path):
    """The command's checkpoint holds exactly the arrays of the
    reference's importer on the reference's template from the same
    configs, and sits where `find_best` looks by default."""
    data, exp, _, _ = configs
    j_args = j_config.parse(data, j_config.parse(exp))
    j_cli.set_seed(int(j_args.get("seed", 1)))
    frames, tracks = j_cli.load_dataset(j_args)
    j_template = j_build.assemble_scene(frames, tracks, j_args)
    rng = np.random.default_rng(3)
    tuples = [_capture_tuple(rng, 1500)] + [
        _capture_tuple(rng, 40 + 10 * i, extent=5.0 + i)
        for i in range(j_template.num_actors)]
    assert j_template.num_actors >= 1
    pth = tmp_path / "ckpt_it_30000_good.pth"
    torch.save((tuples, 30000), pth)

    out = import_reference_ckpt.main(["-dc", data, "-ec", exp, "--pth",
                                      str(pth), "--device", "cpu"])
    args = cli.config_lib.parse(data, cli.config_lib.parse(exp))
    models = os.path.join(cli._model_dir(args), "models")
    assert out == os.path.join(models, "ckpt_it_30000_good.npz")
    assert checkpoint.find_best(models) == out

    j_scene, j_it = j_import.scene_from_reference(str(pth), j_template,
                                                  headroom=1.5)
    want = scene_arrays(j_scene)
    with np.load(out, allow_pickle=False) as z:
        got = {k: z[k] for k in z.files}
        meta = json.loads(str(z["__meta__"]))
    assert meta == {"iteration": j_it, "imported_from": str(pth)}
    assert set(want) <= set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    scene, _ = checkpoint.load_scene(out, "cpu")
    assert scene.background.active_sh_degree == 2
    os.remove(out)


def _port_scene(seed):
    """A port scene with dead slots among the alive ones: a 300-slot
    background and two stacked 64-slot actors, at SH degree 1."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for part, shape in (("background", (300,)), ("actors", (2, 64))):
        arrays.update({
            f"{part}.xyz": rng.normal(size=shape + (3,)),
            f"{part}.f_dc": rng.normal(size=shape + (1, 3)),
            f"{part}.f_rest": rng.normal(size=shape + (15, 3)),
            f"{part}.log_scale": rng.normal(size=shape + (2,)),
            f"{part}.quat": rng.normal(size=shape + (4,)),
            f"{part}.opacity_logit": rng.normal(size=shape),
            f"{part}.alive": rng.uniform(size=shape) > 0.3,
            f"{part}.active_sh_degree": np.int32(1),
            f"{part}.extent": np.float32(7.5)})
    arrays = {k: (v.astype(np.float32) if v.dtype == np.float64 else v)
              for k, v in arrays.items()}
    arrays.update({"tracks.size": np.ones((2, 3), np.float32),
                   "tracks.translations": np.zeros((2, 3, 3), np.float32),
                   "tracks.quats": np.tile([1.0, 0, 0, 0],
                                           (2, 3, 1)).astype(np.float32),
                   "tracks.present": np.ones((2, 3), bool)})
    return convert.scene_from_numpy(arrays, device="cpu")


def test_export_is_the_alive_rows_and_reimports_bit_for_bit(tmp_path):
    scene = _port_scene(5)
    tuples = import_torch.scene_to_reference(scene)
    assert len(tuples) == 1 + scene.num_actors
    parts = [(scene.background, slice(None))] + [
        (scene.actors, i) for i in range(scene.num_actors)]
    fields = ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit")
    for tup, (asset, i) in zip(tuples, parts):
        alive = asset.alive[i]
        assert len(tup) == 12 and tup[0] == 1 and tup[11] == 7.5
        for j, f in enumerate(fields, start=1):
            want = getattr(asset, f)[i][alive]
            if f == "opacity_logit":
                want = want.reshape(-1, 1)
            assert torch.equal(tup[j], want), f
        n = int(alive.sum())
        assert tup[7].shape == (n,) and not tup[8].any() and not tup[9].any()

    pth = tmp_path / "scene.pth"
    import_torch.save_reference(str(pth), scene, 77)
    back, it = import_torch.scene_from_reference(str(pth), scene)
    assert it == 77
    for (asset, i), (got, j) in zip(parts, [(back.background, slice(None))]
                                    + [(back.actors, k)
                                       for k in range(back.num_actors)]):
        alive, got_alive = asset.alive[i], got.alive[j]
        assert int(got_alive.sum()) == int(alive.sum())
        for f in fields:
            assert torch.equal(getattr(got, f)[j][got_alive],
                               getattr(asset, f)[i][alive]), f
        assert got.active_sh_degree == asset.active_sh_degree
        assert got.extent == asset.extent


def test_import_roundtrip_on_cpu(configs, monkeypatch):
    """Train 4 steps with the CLI, then the round trip from its models:
    export, the import command, a 2-step `train --resume` from the import,
    `eval -t all -e`; import_rt.json under --out, every metric finite."""
    data, exp, rt, root = configs
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cli.main(["train", "-dc", data, "-ec", exp, "--device", "cpu"])
    src = os.path.join(root, "output", "importtest", "exp", "scene_s1",
                       "models")
    out = os.path.join(root, "roundtrip")
    rec = import_roundtrip.main(["--src", src, "-dc", data, "-ec", rt,
                                 "--out", out, "--finetune", "2",
                                 "--device", "cpu"])
    with open(os.path.join(out, "import_rt.json")) as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    assert rec["export"]["iteration"] == 4
    assert os.path.exists(rec["export"]["pth"])
    assert rec["finetune"]["iterations"] == [5, 6]
    assert rec["imported_ckpt"] == os.path.join(out, "imported.npz")
    scene, meta = checkpoint.load_scene(rec["imported_ckpt"], "cpu")
    assert meta["iteration"] == 4
    src_scene, _ = checkpoint.load_scene(rec["export"]["src_ckpt"], "cpu")
    for f in ("xyz", "f_dc", "f_rest", "log_scale", "quat",
              "opacity_logit"):
        assert torch.equal(
            getattr(scene.background, f)[scene.background.alive],
            getattr(src_scene.background, f)[src_scene.background.alive]), f
    models = os.path.join(root, "output", "import_rt", "exp", "scene_s1",
                          "models")
    assert checkpoint.find_best(models).endswith("ckpt_it_6_good.npz")
    for key in ("import_s", "finetune_s", "eval_s"):
        assert rec[key] > 0
    assert rec["eval"]["num_frames"] == 2
    assert rec["finetune"]["peak_mib"] is None      # no card
    assert set(rec["finetune"]["launches"].values()) == {0}
    for group, row in rec["metrics_mean"].items():
        for k, v in row.items():
            ok = (v == "unavailable(no-weights)" if "lpips" in k
                  else np.isfinite(v))
            assert ok, (group, k, v)
