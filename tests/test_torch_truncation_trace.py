"""`lidar_rt_tpu_torch.scripts.truncation_trace` on the CPU.

  * `chain_truncation` of a port `Trainer` equals, pass by pass, the sums
    of `truncated` over the reference's `bin_tail_chain`
    (`lidar_rt_tpu/ops/tracer.py:385`) on the same jittered synthetic
    scene and poses, binned as the reference's trainer bins its cache
    (`lidar_rt_tpu/train/loop.py:191-195`: 2 px of footprint padding, a
    0.5 px existence cull), at 8x128 tiles with K=16, which truncate, and
    two tail passes.  The reference's cutoff is taken with its binner's
    range (`_torch_parity.binner_range_cutoff`, as
    `test_torch_binning.py`'s chain test holds the floors).
  * A trainer read after every chunk (the script's `trace`: the held-out
    PSNR and `chain_truncation`) trains as one that is not, bit for bit:
    history, scene, Adam moments, densify statistics, bin cache and
    generators, across densify events.
  * `configs/rehearsal/full_tail2.yaml` and `full_obj10k.yaml` parse to
    `full.yaml`'s args but their one key, in the port and in the
    reference's `lidar_rt_tpu.config`.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from lidar_rt_tpu import config as j_config
from lidar_rt_tpu.core import transforms as j_tf
from lidar_rt_tpu.data import build as j_build
from lidar_rt_tpu.data import synthetic as j_synthetic
from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu.ops.binning import TileConfig as JTileConfig
from lidar_rt_tpu.scene import scene as j_scene_lib
from lidar_rt_tpu_torch import config as t_config
from lidar_rt_tpu_torch.ops import tracer as t_tracer
from lidar_rt_tpu_torch.ops.binning import TileConfig as TTileConfig
from lidar_rt_tpu_torch.scripts import truncation_trace as tt
from lidar_rt_tpu_torch.train import loop as t_loop
from lidar_rt_tpu_torch.train import options
from lidar_rt_tpu_torch.utils import checkpoint as ckpt_lib
from _torch_parity import binner_range_cutoff, jittered, port_frames, \
    port_scene

torch.set_num_threads(1)

TILE = dict(tile_h=8, tile_w=128, max_per_tile=16)
TAIL = 2
# A schedule with densify events (20, 40) and an opacity reset (30) inside
# 40 steps, read every 10.
OPT = dict(densify_from_iter=15, densification_interval=20,
           densify_until_iter=45, opacity_reset_interval=30,
           cd_max_points=1024, iterations=40, sh_increase_interval=15,
           rebin_interval=5)
CHUNK, STEPS = 10, 40


@pytest.fixture(scope="module")
def scene():
    """The reference's synthetic scene (16 x 256, an actor), jittered by 5
    cm (range ties), with its frames."""
    d = j_config.default_experiment().to_dict()
    d["model"].update(obj_pt_num=256, voxel_size=0.3)
    frames, track = j_synthetic.generate(num_frames=3, height=16, width=256)
    sc = j_build.assemble_scene(frames, [track], j_config.Args(d),
                                capacity_headroom=1.5)
    return frames, jittered(sc)


def _port_trainer(scene, binner="hier", tail=TAIL):
    frames, sc = scene
    cfg = t_tracer.TraceConfig(tile=TTileConfig(**TILE, binner=binner),
                               tail_passes=tail)
    return t_loop.Trainer(port_scene(sc), port_frames(frames),
                          options.experiment_options(**OPT), cfg)


@pytest.mark.parametrize("binner", ["topk", "hier"])
def test_chain_truncation_matches_reference(scene, binner, monkeypatch):
    frames, sc = scene
    got = tt.chain_truncation(_port_trainer(scene, binner),
                              range(frames.num_frames))
    monkeypatch.setattr(j_tracer, "_tile_range_cutoff", binner_range_cutoff)
    tile = JTileConfig(**TILE, binner=binner, pad_px=2.0, snap_pad_px=0.5)
    want = [dict(truncated=0, tiles=0, max=0) for _ in range(TAIL + 1)]
    for f in range(frames.num_frames):
        bundle, _ = j_scene_lib.compose(sc, f)
        chain = j_tracer.bin_tail_chain(
            bundle, frames.grid, frames.width,
            j_tf.invert_se3(np.asarray(frames.sensor2world[f])), tile, TAIL)
        for p, a in enumerate(chain):
            t = np.asarray(a.truncated)
            want[p]["truncated"] += int(t.sum())
            want[p]["tiles"] += int((t > 0).sum())
            want[p]["max"] = max(want[p]["max"], int(t.max()))
    assert [{k: g[k] for k in ("truncated", "tiles", "max")}
            for g in got] == want
    assert [g["K"] for g in got] == [TILE["max_per_tile"]] * (TAIL + 1)
    # Every pass truncates here, the last one included.
    assert all(w["truncated"] > 0 for w in want)


def _state_tensors(trainer) -> list[torch.Tensor]:
    st = trainer.state
    out = [st.bins.index, st.bins.valid, st.generator.get_state()]
    for asset, opt, stats in (
            (st.scene.background, st.opt_bg, st.stats_bg),
            (st.scene.actors, st.opt_actors, st.stats_actors)):
        out += [*asset.params().values(), asset.alive, *stats]
        for s in opt.adam.state.values():
            out += [v for v in s.values() if torch.is_tensor(v)]
    return out


def test_read_trainer_trains_as_unread(scene):
    cpu = torch.device("cpu")
    read = _port_trainer(scene, tail=1)
    rows = tt.trace(read, STEPS, CHUNK, cpu)
    unread = _port_trainer(scene, tail=1)
    while unread.iteration < STEPS:
        unread.run(iterations=CHUNK, log_every=100)
    assert [r["iteration"] for r in rows] == [10, 20, 30, 40]
    assert all(len(r["chain"]) == 2 for r in rows)
    assert len(read.densify_log) == len(unread.densify_log) > 0

    def bits(history):
        return [{k: v for k, v in h.items() if k != "elapsed"}
                for h in history]

    assert bits(read.history) == bits(unread.history)
    assert read.densify_log == unread.densify_log
    assert read.state.bins.age == unread.state.bins.age
    assert read.state.bins.rebins == unread.state.bins.rebins
    for a, b in zip(_state_tensors(read), _state_tensors(unread),
                    strict=True):
        assert torch.equal(a, b)


def test_chain_truncation_reads_only(scene):
    """One read: the state's tensors, the bin cache's ages and every
    generator are as before."""
    trainer = _port_trainer(scene, tail=1)
    trainer.run(iterations=CHUNK, log_every=100)
    before = [t.clone() for t in _state_tensors(trainer)]
    host = copy.deepcopy((trainer.state.bins.age, trainer._frame_stack,
                          torch.get_rng_state()))
    tt.chain_truncation(trainer, trainer.frames.train_frames)
    for a, b in zip(before, _state_tensors(trainer), strict=True):
        assert torch.equal(a, b)
    assert trainer.state.bins.age == host[0]
    assert trainer._frame_stack == host[1]
    assert torch.equal(torch.get_rng_state(), host[2])


@pytest.mark.parametrize("name, key, value", [
    ("full_tail2.yaml", ("tracer", "tail_passes"), 2),
    ("full_obj10k.yaml", ("model", "obj_pt_num"), 10_000)])
@pytest.mark.parametrize("package", ["port", "reference"])
def test_config_changes_one_key(name, key, value, package, monkeypatch):
    """Each new config is `full.yaml` with one key changed, over the
    Waymo rehearsal's data config, in either package's parser."""
    import os

    monkeypatch.chdir(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg = t_config if package == "port" else j_config
    dc = "configs/rehearsal/waymo.yaml"

    def args(ec):
        return cfg.parse(dc, cfg.parse(f"configs/rehearsal/{ec}")).to_dict()

    base, new = args("full.yaml"), args(name)
    assert base[key[0]][key[1]] != value
    assert new[key[0]][key[1]] == value
    new[key[0]][key[1]] = base[key[0]][key[1]]
    assert new == base
    if package == "reference":
        assert args(name) == {**t_config.parse(dc, t_config.parse(
            f"configs/rehearsal/{name}")).to_dict()}


def test_actor_alive_of_checkpoints(scene, tmp_path):
    """`--checkpoints`: each saved state's alive surfels per actor and the
    actors' slots."""
    trainer = _port_trainer(scene, tail=0)
    path = str(tmp_path / "ckpt_it_0.npz")
    ckpt_lib.save(path, trainer.state, {"iteration": 0})
    out = tt.main(["--checkpoints", path, "--device", "cpu"])
    ac = trainer.state.scene.actors
    assert out["checkpoints"][path] == {
        "alive": [int(x) for x in ac.alive.sum(-1)],
        "capacity": ac.alive.shape[1]}
    assert tt.actor_alive(dataclasses.replace(
        trainer.state.scene, actors=None)) == {"alive": [], "capacity": 0}
