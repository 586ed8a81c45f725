"""The port's two user tools, `scripts.quality_check` and
`scripts.nan_forensics`, on the CPU at a tiny size, and held to the
reference's `scripts/quality_check.py` / `scripts/nan_forensics.py`
where they compute the same thing.

The reference's scripts run at import (their arguments are read from
sys.argv at module level), so the functions held to here, its
`masked_eval` and `term_loss`, are taken from their files by path with
`ast` and run in a namespace holding the globals they read; the scripts
are not edited.

(a) `quality_check` trains two of its configs 20 iterations at 16 x 64:
each prints the reference's lines plus its engine, reports its metrics
and launches no kernel on CPU tensors; its `masked_eval` equals
the reference's on one render; a shape the kernels refuse raises
instead of falling back to the torch engine.
(b) `nan_forensics` finds no non-finite gradient in a few steps; with a
non-finite gradient injected into the Chamfer term (a 0 * sqrt(0) on one
predicted point, in both packages' `chamfer_loss`), from one converted
state (the synthetic scene jittered by 5 cm) it names the same term,
leaves and first ten surfel indices as the reference's `term_loss`.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu.config import Args, default_experiment
from lidar_rt_tpu.core import rays as j_rays
from lidar_rt_tpu.data import build as j_build
from lidar_rt_tpu.data import synthetic as j_synthetic
from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu.ops.binning import TileConfig as JTileConfig
from lidar_rt_tpu.scene import compose as j_compose
from lidar_rt_tpu.train import loop as j_loop
from lidar_rt_tpu.train import losses as j_losses
from lidar_rt_tpu_torch.data import synthetic
from lidar_rt_tpu_torch.ops import cuda_tracer, kernels
from lidar_rt_tpu_torch.ops import tracer as t_tracer
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.scripts import nan_forensics, quality_check
from lidar_rt_tpu_torch.train import loop, losses, options
from _torch_parity import carried, port_frames

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TWO = "8x128 K=256 rebin10,16x32 K=128 rebin10 tail1"


def _reference_function(script: str, name: str, namespace: dict):
    """Function `name` of the reference's `scripts/<script>`, compiled
    alone from the file with `namespace` as its globals."""
    path = ROOT / "scripts" / script
    tree = ast.parse(path.read_text())
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    code = compile(ast.Module(body=[node], type_ignores=[]), str(path),
                   "exec")
    exec(code, namespace)
    return namespace[name]


# -- quality_check ----------------------------------------------------------


def test_quality_check_two_configs(capsys):
    kernels.reset_launches()
    out = quality_check.main(["20", "16x64", "0", TWO, "--device", "cpu"])
    assert [r["name"] for r in out] == ["8x128 K=256 rebin10",
                                        "16x32 K=128 rebin10 tail1"]
    lines = capsys.readouterr().out.splitlines()
    for r in out:
        assert r["engine"] == "cuda"
        m = r["metrics"]
        assert 0 <= m["hit_acc"] <= 1 and 0 <= m["coverage"] <= 1
        # Medians over no covered pixel are nan, as in the reference.
        assert all(np.isfinite(v) == (m["coverage"] > 0) for k, v in
                   m.items() if k not in ("hit_acc", "coverage"))
        assert np.isfinite(r["losses"]).all() and r["alive"] > 0
        assert sum(r["launches"].values()) == 0     # the twins on the CPU
        line = next(ln for ln in lines if ln.startswith(r["name"]))
        assert f"alive={r['alive']}  engine=cuda  depth_med=" in line
        assert " it/s  " in line
    assert sum(ln.startswith("  losses: [") for ln in lines) == 2


def test_quality_check_configs_are_the_references():
    """Every config of the reference's list, in its order, with its
    tiles, budgets, rebin interval and tail passes."""
    tree = ast.parse((ROOT / "scripts" / "quality_check.py").read_text())
    configs = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", "") == "CONFIGS")
    want = [ast.literal_eval(e.elts[0]) for e in configs.elts]
    assert [n for n, *_ in quality_check.CONFIGS] == want
    for name, tile, warm, over, tail in quality_check.CONFIGS:
        h, w = (int(v) for v in name.split()[0].split("x"))
        assert (tile.tile_h, tile.tile_w, tile.binner, tile.pad_px) == \
            (h, w, "hier", 2.0)
        assert tile.max_per_tile == int(name.split("K=")[1].split()[0]
                                        .split("->")[-1])
        assert tail == ("tail1" in name)
        assert over == ({} if "rebin1 " in name else {"rebin_interval": 10})
        assert (warm is None) == ("warmup" not in name)


def test_quality_check_masked_eval_is_the_references():
    rng = np.random.default_rng(0)
    frames, _ = synthetic.generate(num_frames=2, height=8, width=32,
                                   device="cpu")
    out = {"depth": frames.range1[1] + torch.as_tensor(
               rng.normal(size=(8, 32)), dtype=torch.float32),
           "intensity": torch.as_tensor(rng.uniform(size=(8, 32)),
                                        dtype=torch.float32),
           "raydrop": torch.as_tensor(rng.uniform(size=(8, 32)),
                                      dtype=torch.float32)}
    ref = _reference_function("quality_check.py", "masked_eval",
                              {"np": np})

    class Frames:
        range1 = frames.range1.numpy()
        intensity1 = frames.intensity1.numpy()

    want = ref({k: v.numpy() for k, v in out.items()}, Frames, 1)
    got = quality_check.masked_eval(out, frames, 1)
    assert got == want


def test_quality_check_refused_shape_raises(monkeypatch):
    """A kernel's refusal (here the CPU twin standing in for it) reaches
    the caller: no fallback to the torch engine."""

    def refuse(*args, **kwargs):
        raise ValueError("refused tile shape")

    monkeypatch.setattr(cuda_tracer, "forward_tiles_reference", refuse)
    with pytest.raises(ValueError, match="refused tile shape"):
        quality_check.main(["2", "16x64", "0", "16x32 K=128 rebin10 tail1",
                            "--device", "cpu"])


# -- nan_forensics ----------------------------------------------------------


TILE = dict(tile_h=8, tile_w=16, max_per_tile=128)


@pytest.fixture(scope="module")
def one_state():
    """The reference's synthetic scene (3 frames of 16 x 128) jittered by
    5 cm and its port copy; both packages' options, configs and frames."""
    frames, track = j_synthetic.generate(num_frames=3, height=16, width=128)
    d = default_experiment().to_dict()
    d["model"].update(obj_pt_num=256, voxel_size=0.3)
    j_args = Args(d)
    j_scene, t_scene = carried(j_build.assemble_scene(
        frames, [track], j_args, capacity_headroom=1.5))
    return {"j_scene": j_scene, "j_frames": frames, "j_args": j_args,
            "j_cfg": j_tracer.TraceConfig(tile=JTileConfig(**TILE),
                                          tile_batch=2),
            "t_scene": t_scene, "t_frames": port_frames(frames),
            "t_args": options.experiment_options(),
            "t_cfg": t_tracer.TraceConfig(tile=TileConfig(**TILE))}


def test_nan_forensics_finds_nothing_in_clean_steps(one_state, capsys):
    s = one_state
    trainer = loop.Trainer(s["t_scene"], s["t_frames"], s["t_args"],
                           s["t_cfg"])
    assert nan_forensics.run(trainer, 3, log_every=1) is None
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "no non-finite gradient found"
    assert [ln.split()[0] for ln in out[:-1]] == ["1", "2", "3"]
    assert trainer.state.stats_bg.denom.sum() > 0   # the steps ran


PROBE = 37      # the predicted point whose gradient is made non-finite


def _poison(chamfer, xp):
    """`chamfer` with 0 * sqrt(0) on one predicted point's x added: the
    loss unchanged, that point's gradient NaN."""

    def poisoned(pred, pred_mask, gt, gt_mask):
        x = pred[PROBE, 0]
        return chamfer(pred, pred_mask, gt, gt_mask) + 0.0 * xp.sqrt(x - x)

    return poisoned


def test_nan_forensics_names_the_references_term_leaf_and_surfels(
        one_state, monkeypatch):
    s = one_state
    j_frames, f = s["j_frames"], 1
    monkeypatch.setattr(j_losses, "chamfer_loss",
                        _poison(j_losses.chamfer_loss, jnp))
    monkeypatch.setattr(losses, "chamfer_loss",
                        _poison(losses.chamfer_loss, torch))
    term_loss = _reference_function("nan_forensics.py", "term_loss", {
        "dataclasses": dataclasses, "jax": jax, "jnp": jnp,
        "losses": j_losses, "compose": j_compose, "tracer_lib": j_tracer,
        "rays_lib": j_rays, "args": s["j_args"], "frames": j_frames,
        "cfg": s["j_cfg"]})
    j_scene = s["j_scene"]
    batch = j_loop.frame_batch(j_frames, f)
    # Each term's gradient as the reference's script takes it (`grad_fns`,
    # :87, one jitted jax.grad of `term_loss` a term), the six compiled
    # together as one program.

    @jax.jit
    def term_grads(pb, pa):
        return [jax.grad(lambda b, a, t=t: term_loss(b, a, batch, j_scene, t),
                         argnums=(0, 1))(pb, pa)
                for t in nan_forensics.TERMS]

    want = {"finite": {}, "bad": []}
    for t, g in zip(nan_forensics.TERMS, term_grads(
            j_scene.background.params(), j_scene.actors.params())):
        ok = all(bool(np.isfinite(np.asarray(v)).all())
                 for side in g for v in side.values())
        want["finite"][t] = ok
        for side, gg in zip(("bg", "ac"), g):
            for name, leaf in gg.items():
                bad = ~np.isfinite(np.asarray(leaf))
                if bad.any():
                    want["bad"].append(
                        (t, f"{side}.{name}", int(bad.sum()),
                         np.unique(np.nonzero(bad)[0])[:10].tolist()))
    assert [t for t, ok in want["finite"].items() if not ok] == ["cd"]
    assert want["bad"]

    t_batch = loop.frame_batch(s["t_frames"], f)
    got = nan_forensics.attribute(s["t_scene"], t_batch, s["t_args"],
                                  s["t_frames"], s["t_cfg"], it=1)
    assert got["finite"] == want["finite"]
    # jax orders a gradient dict's leaves by key; the port by group.
    assert sorted(got["bad"]) == sorted(want["bad"])
