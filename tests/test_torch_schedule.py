"""The configs' uncompressed schedule, `configs/rehearsal/full.yaml`, and
a `cli train` split at a checkpoint (`e2e_rehearsal.train_chunks`).

(a) The port's yaml-free reader and the JAX package's reader resolve
full.yaml, over each rehearsal data config, to the same values: its
`opt`, `refine`, `saving_iterations` and `testing_iterations` are
configs/exp.yaml's, its `model` and `tracer` configs/rehearsal/exp.yaml's.

(b) On the CPU, a synthetic 8x64 scene trained 4 steps with
densification and a 1-epoch refine, once whole and once as two `cli
train` chunks (2 + 2, the second resumed with `-m ckpt --iterations 4`):
the split run's `log.json` is one contiguous log (history, densify events,
held-out evals) and the U-Net is refined once, by the last chunk.

What a checkpoint carries over bit for bit: the surfels' parameters, both
Adam optimizers' moments and step counts, the densify statistics and the
densify generator's state (`utils/checkpoint.py`), and so the first chunk
equals the whole run's first half.  What it does not: the bin cache (every
frame re-bins at its first step after the resume) and the host's frame
order (the shuffled frame stack; `random` is seeded anew in each
process), so the second chunk's steps may part from the whole run's.
"""

import json
import os

import numpy as np
import pytest
import torch

from lidar_rt_tpu import config as j_config
from lidar_rt_tpu_torch import cli
from lidar_rt_tpu_torch import config as t_config
from lidar_rt_tpu_torch.data import build
from lidar_rt_tpu_torch.scripts import e2e_rehearsal as runner
from lidar_rt_tpu_torch.train import loop
from lidar_rt_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = os.path.join(REPO, "configs", "rehearsal", "full.yaml")


def _resolved(parse, *paths):
    args = None
    for p in reversed(paths):
        args = parse(os.path.join(REPO, p), args)
    return args.to_dict()


@pytest.mark.parametrize("data", ["waymo", "kitti"])
def test_full_yaml_resolves_alike_in_both_readers(data):
    dc = f"configs/rehearsal/{data}.yaml"
    got = _resolved(t_config.parse, dc, "configs/rehearsal/full.yaml")
    assert got == _resolved(j_config.parse, dc,
                            "configs/rehearsal/full.yaml")
    exp = _resolved(t_config.parse, "configs/exp.yaml")
    rehearsal = _resolved(t_config.parse, "configs/rehearsal/exp.yaml")
    for key in ("opt", "refine", "saving_iterations", "testing_iterations"):
        assert got[key] == exp[key], key
    for key in ("model", "tracer"):
        assert got[key] == rehearsal[key], key
    assert (got["opt"]["iterations"], got["refine"]["epochs"]) == (30000,
                                                                   400)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The whole run and the split run, each in its own model dir."""
    root = tmp_path_factory.mktemp("split")
    data = root / "data.yaml"
    data.write_text("""dataset: synthetic
scene_id: s1
synthetic:
  num_frames: 2
  height: 8
  width: 64
""")
    out = {"root": str(root)}
    env = {"OMP_NUM_THREADS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        for name, splits in (("whole", []), ("split", [2])):
            exp = root / f"{name}.yaml"
            exp.write_text(f"""parent_config: "{REPO}/configs/exp.yaml"
model_dir: "{root}/{name}"
task_name: t
testing_iterations: 2
saving_iterations: [2, 4]
opt:
  iterations: 4
  densify_from_iter: 0
  densification_interval: 1
  opacity_reset_interval: 3
  rebin_interval: 2
refine:
  epochs: 1
  batch_size: 2
tracer:
  tile_h: 8
  tile_w: 64
  max_per_tile: 32
""")
            runner.train_chunks(str(data), str(exp), splits,
                                str(root / f"{name}_configs"), "cpu")
            out[name] = os.path.join(root, name, "t", "exp", "scene_s1")
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return out


def _log(mdir):
    with open(os.path.join(mdir, "logs", "log.json")) as f:
        return json.load(f)


def _without_clock(entries):
    return [{k: v for k, v in e.items() if k != "elapsed"} for e in entries]


def test_split_run_logs_one_contiguous_run(runs):
    whole, split = _log(runs["whole"]), _log(runs["split"])
    assert [h["iteration"] for h in split["history"]] == [1, 2, 3, 4]
    assert [e["iteration"] for e in split["eval_history"]] == [2, 4]
    # One densify event per step, none lost or repeated at the split.
    assert [e["iteration"] for e in split["densify"]] == \
        [e["iteration"] for e in whole["densify"]]
    assert {e["iteration"] for e in split["densify"]} == {1, 2, 3, 4}
    # The first chunk is the whole run's first half, bit for bit.
    for key in ("history", "densify", "eval_history"):
        first = [e for e in split[key] if e["iteration"] <= 2]
        assert _without_clock(first) == _without_clock(
            [e for e in whole[key] if e["iteration"] <= 2]), key
    with open(os.path.join(runs["split"], "logs", "chunks.json")) as f:
        chunks = json.load(f)
    assert [(c["from"], c["to"]) for c in chunks] == [(0, 2), (2, 4)]
    # The U-Net is refined once, by the last chunk.
    assert ["refine_epochs" in c["seconds"] for c in chunks] == [False,
                                                                 True]
    assert len(split["refine_loss"]) == len(whole["refine_loss"]) == 1
    assert os.path.exists(os.path.join(runs["split"], "models", "unet.npz"))


def test_checkpoint_carries_the_state_over(runs):
    """The split's checkpoint at 2 is the whole run's, and a trainer
    restored from it holds every saved array of it; its bin cache starts
    all stale."""
    got = runner.chunk_checkpoint(os.path.join(runs["split"], "models"), 2)
    want = runner.chunk_checkpoint(os.path.join(runs["whole"], "models"), 2)
    with np.load(got) as a, np.load(want) as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("opt_bg.") for k in a.files)
        assert any(k.startswith("stats_bg.") for k in a.files)
        assert "generator" in a.files
        for k in a.files:
            if k != "__meta__":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    args = t_config.parse(
        os.path.join(runs["root"], "data.yaml"),
        t_config.parse(os.path.join(runs["root"], "split.yaml")))
    frames, tracks = cli.load_dataset(args, "cpu")
    trainer = loop.Trainer(build.assemble_scene(frames, tracks, args),
                           frames, args, cli.trace_configs(args, "cpu")[0])
    state, meta = checkpoint.load(got, "cpu", opt_args=args.opt)
    trainer.restore(state, int(meta["iteration"]))
    resaved = os.path.join(runs["split"], "resaved.npz")
    checkpoint.save(resaved, trainer.state, meta)
    with np.load(got) as a, np.load(resaved) as b:
        for k in a.files:
            if k != "__meta__":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert all(age == loop.STALE_AGE for age in trainer.state.bins.age)


def test_split_points_are_checked(tmp_path):
    dc = os.path.join(REPO, "configs", "rehearsal", "waymo.yaml")
    for bad in ([15500], [0], [30000], [20000, 15000]):
        with pytest.raises(ValueError, match="split points"):
            runner.chunk_configs(dc, FULL, bad, str(tmp_path))
    chunks = runner.chunk_configs(dc, FULL, [15000], str(tmp_path))
    assert [end for _, end in chunks] == [15000, 30000]
    first = t_config.parse(dc, t_config.parse(chunks[0][0]))
    assert not first.refine.use_refine and first.refine.epochs == 400
    assert chunks[1][0] == FULL
