"""The rehearsal runner, `lidar_rt_tpu_torch.scripts.e2e_rehearsal`, held
to the reference's `scripts/e2e_rehearsal.py`.

(a) `gen` builds the reference's datasets: both generators run with the
renders and the writers replaced by capturing stubs, in both packages, at
the rehearsal's shapes; the scenes (walls, actors, velocities, albedos,
ranges), beam tables, extrinsic, poses, labels and boxes must be equal,
and one frame of each scene rendered at reduced width through both
packages' `synthetic` agrees within the synthetic tests' bars
(tests/test_torch_data.py: the same hit masks, ranges within 1e-6
relative, intensities within 1e-6 + 1e-5 relative).
(b) `train` -> `eval` -> `collect` through the port's command line on a
small Waymo segment on the CPU: the record's keys are `E2E_r05.json`'s.
"""

import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_rt_tpu.data import kitti as j_kitti
from lidar_rt_tpu.data import synthetic as j_syn
from lidar_rt_tpu.data import writers as j_writers
from lidar_rt_tpu_torch.data import synthetic as t_syn
from lidar_rt_tpu_torch.data import writers as t_writers
from lidar_rt_tpu_torch.scripts import e2e_rehearsal as runner

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _reference_runner():
    spec = importlib.util.spec_from_file_location(
        "reference_e2e_rehearsal", ROOT / "scripts" / "e2e_rehearsal.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(monkeypatch, syn, writers, zeros, tmp_path):
    """Replace the renders and writers of one package with stubs that
    record their arguments; returns the record."""
    got = {"renders": [], "writes": []}

    def render(n):
        def stub(scene, grid, width, s2w, frame, *rest):
            got["renders"].append((scene, grid, width, np.asarray(s2w),
                                   frame))
            return tuple(zeros((grid.height, width)) for _ in range(n))
        return stub

    def write(base, **kw):
        got["writes"].append(kw)
        path = tmp_path / f"written_{len(got['writes'])}"
        path.write_bytes(b"")
        return str(path)

    monkeypatch.setattr(syn, "render_frame_gt_dual", render(4))
    monkeypatch.setattr(syn, "render_frame_gt", render(2))
    monkeypatch.setattr(writers, "write_waymo_segment", write)
    monkeypatch.setattr(writers, "write_kitti360_sequence", write)
    return got


def _same(a, b, where=""):
    """Equal values, recursively through dataclasses, dicts, sequences,
    arrays and tensors."""
    if dataclasses.is_dataclass(a):
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)], where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, torch.Tensor)) or hasattr(a, "shape"):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)
    else:
        assert a == b, (where, a, b)


def test_gen_builds_the_reference_datasets(monkeypatch, tmp_path):
    ref = _reference_runner()
    want = _capture(monkeypatch, j_syn, j_writers,
                    lambda shape: np.zeros(shape, np.float32), tmp_path)
    ref.gen_waymo()
    ref.gen_kitti()
    got = _capture(monkeypatch, t_syn, t_writers,
                   lambda shape: torch.zeros(shape), tmp_path)
    cpu = torch.device("cpu")
    runner.gen_waymo(str(tmp_path / "waymo"), cpu)
    runner.gen_kitti(str(tmp_path / "kitti360"), cpu)

    assert len(got["renders"]) == len(want["renders"]) == 50 + 40
    for i, (g, w) in enumerate(zip(got["renders"], want["renders"])):
        _same(g[0], w[0], f"render {i} scene")
        _same(g[1].row_inclinations, w[1].row_inclinations, f"render {i}")
        assert (g[1].pixel_offset, g[1].angle_offset) == \
            (w[1].pixel_offset, w[1].angle_offset)
        assert (g[2], g[4]) == (w[2], w[4])          # width, frame
        _same(g[3], w[3], f"render {i} sensor pose")
    waymo, kitti = got["writes"]
    w_waymo, w_kitti = want["writes"]
    for key in ("ego2world", "extrinsic", "beam_inclinations",
                "labels_per_frame"):
        _same(waymo[key], w_waymo[key], key)
    for key in ("range1", "intensity1", "range2", "intensity2"):
        assert waymo[key].shape == w_waymo[key].shape == (50, 64, 2650)
    for key in ("seq", "sensor2world", "boxes"):
        _same(kitti[key], w_kitti[key], key)
    assert kitti["range1"].shape == w_kitti["range1"].shape == (
        40, j_kitti.H, j_kitti.W)

    # One frame of each scene, rendered by both packages at reduced width.
    for (scene, grid, _, s2w, f), (j_scene, j_grid, *_), fn in (
            (got["renders"][10], want["renders"][10], "render_frame_gt_dual"),
            (got["renders"][55], want["renders"][55], "render_frame_gt")):
        monkeypatch.undo()
        imgs = getattr(t_syn, fn)(scene, grid, 96, s2w, f)
        j_imgs = getattr(j_syn, fn)(j_scene, j_grid, 96, s2w, f)
        for i, (a, b) in enumerate(zip(imgs, j_imgs)):
            a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
            if i % 2 == 0:                       # ranges
                np.testing.assert_array_equal(a > 0, b > 0)
                np.testing.assert_allclose(a, b, atol=0.0, rtol=1e-6)
            else:
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)
        assert (imgs[0] > 0).float().mean() > 0.5


def test_train_eval_collect_writes_the_reference_record(tmp_path):
    """The runner's commands on a 10-frame, 32 x 128 Waymo segment (LPIPS
    needs 32 rows), 4 steps with a held-out eval each (so the record has
    a steady-state rate), the budget switch at 2, one refine epoch."""
    data, out = tmp_path / "data", tmp_path / "out"
    runner.gen_waymo(str(data / "waymo"), torch.device("cpu"), 10, 32, 128)
    exp = tmp_path / "exp.yaml"
    exp.write_text(f"""parent_config: "{ROOT}/configs/rehearsal/exp.yaml"
frame_length: [0, 9]
eval_frames: [4, 8]
testing_iterations: 1
saving_iterations: [4]
model:
  voxel_size: 1.0
opt:
  iterations: 4
tracer:
  warmup_until: 2
refine:
  epochs: 1
""")
    common = ["--data", str(data), "--out", str(out), "-ec", str(exp),
              "--device", "cpu"]
    env = {"OMP_NUM_THREADS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        assert runner.main(["train", "waymo", *common]) > 0
        assert runner.main(["eval", "waymo", *common]) > 0
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    rec = runner.main(["collect", *common])
    with open(out / "e2e_torch.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    with open(out / "e2e_torch_logs.json") as f:
        logs = json.load(f)
    assert list(logs) == ["waymo"]
    assert len(logs["waymo"]["train_log"]["refine_loss"]) == 1
    assert logs["waymo"]["train_log"]["chunks"] is None
    assert isinstance(logs["waymo"]["densify_events"], list)
    with open(ROOT / "E2E_r05.json") as f:
        ref = json.load(f)
    assert set(rec) == set(ref) | {"card"}
    assert set(rec["results"]) == set(ref["results"])
    got, want = rec["results"]["waymo"], ref["results"]["waymo"]
    assert set(got) == set(want)
    assert {g: set(r) for g, r in got["metrics_mean"].items()} == \
        {g: set(r) for g, r in want["metrics_mean"].items()}
    assert [e["iteration"] for e in got["eval_history"]] == [1, 2, 3, 4]
    assert set(got["eval_history"][0]) == set(want["eval_history"][0])
    assert got["iterations_recorded"] == 4
    assert np.isfinite(got["final_loss"]) and got["unet_npz_bytes"] > 0
    assert rec["results"]["kitti360"] == {"unet_npz_sha256": None}
    assert rec["schedule"].startswith("4 iterations")


def test_train_forks_from_one_checkpoint(tmp_path):
    """`train --fork 2 --fork_to 4 --forks exp.yaml:2` on a 10-frame,
    32 x 128 Waymo segment: the base run to 2 (no refine), then two forks
    side by side, each resumed from the base's checkpoint at 2 in its own
    model directory; `collect --fork 2` summarises each fork's evals,
    loss, alive surfels and densify events and reads its drop against
    the base's last two evals."""
    data, out = tmp_path / "data", tmp_path / "out"
    runner.gen_waymo(str(data / "waymo"), torch.device("cpu"), 10, 32, 128)
    exp = tmp_path / "exp.yaml"
    exp.write_text(f"""parent_config: "{ROOT}/configs/rehearsal/exp.yaml"
frame_length: [0, 9]
eval_frames: [4, 8]
testing_iterations: 1
saving_iterations: [4]
model:
  voxel_size: 1.0
opt:
  iterations: 6
  densify_from_iter: 0
  densification_interval: 1
  rebin_interval: 1
tracer:
  warmup_until: 2
""")
    common = ["--data", str(data), "--out", str(out), "-ec", str(exp),
              "--device", "cpu", "--fork", "2", "--forks", f"{exp}:2"]
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        secs = runner.main(["train", "waymo", *common, "--fork_to", "4"])
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old
    assert set(secs) == {"base", "exp_1", "exp_2"}
    rec = runner.main(["collect", *common])
    with open(out / "forks.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    base = rec["base"]
    assert [e["iteration"] for e in base["eval"]] == [1, 2]
    assert "refine_epochs" not in base["seconds"]
    assert set(rec["forks"]) == {"exp_1", "exp_2"}
    # Both forks re-seed the frame shuffle from the config's seed.
    assert len({f["frame_order_sha256"] for f in rec["forks"].values()}) == 1
    for name, fork in rec["forks"].items():
        assert [e["iteration"] for e in fork["eval"]] == [3, 4]
        assert [e["iteration"] for e in fork["densify"]] == [3, 3, 4, 4]
        assert set(fork["loss_per_1000"]) == {1000}
        between = fork["loss_between_events"]
        assert between["first_tenth"] == between["last_tenth"] is not None
        assert fork["eval_psnr_vs_events"]["n_at_event"] == 1
        assert fork["densify_totals"]["background"]["events"] == 2
        assert fork["densify_totals"]["actors"]["events"] == 2
        assert fork["background_growth"] == \
            fork["eval"][-1]["alive"] - base["eval"][-1]["alive"]
        assert fork["drop_evals"] == [3, 4]
        assert rec["base_psnr_evals"] == [1, 2]
        want = rec["base_psnr_mean"] - np.mean(
            [e["eval_psnr"] for e in fork["eval"]])
        assert fork["drop_db"] == pytest.approx(want)
        assert fork["outcome"] in ("declines", "holds", "partial")
        mdir = out / "forks" / name
        assert (out / "forks" / f"{name}.log").exists() and mdir.exists()
        assert not any(p.name == "unet.npz" for p in mdir.rglob("*.npz"))
