"""The JAX package's own checkpoints carried into the port: `export_jax_ckpt.py`
(at the repository's root, with jax) then `scripts.import_jax_ckpt` (without).

The reference trains its synthetic scene 2 steps and saves its TrainState
with its own `utils.checkpoint.save`; a flax U-Net, initialised with its
BatchNorm affines and statistics moved off their initial values, is saved
the same way.  Both are exported and imported; the port's
`utils.checkpoint.load` then gives every scene leaf, every Adam moment and
step, and both densify statistics bit for bit, and no generator of the
reference's (a fresh one); the U-Net's eval forward matches flax's within
`tests/test_torch_refine.py`'s bar (1e-5); a port `Trainer` resumed from
the imported state takes a step.
"""

import importlib.util
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu.config import Args, default_experiment
from lidar_rt_tpu.data import build as j_build
from lidar_rt_tpu.data import synthetic as j_synthetic
from lidar_rt_tpu.models import unet as ref_unet
from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu.ops.binning import TileConfig as JTileConfig
from lidar_rt_tpu.train import loop as j_loop
from lidar_rt_tpu.utils import checkpoint as j_ckpt
from lidar_rt_tpu_torch.models import unet
from lidar_rt_tpu_torch.ops import tracer as t_tracer
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.scripts import import_jax_ckpt
from lidar_rt_tpu_torch.train import loop, optim, options
from lidar_rt_tpu_torch.utils import checkpoint
from _torch_parity import port_frames
from _torch_probes import ROOT

torch.set_num_threads(1)

OPT = dict(densify_from_iter=15, densification_interval=20,
           densify_until_iter=70, opacity_reset_interval=10_000,
           cd_max_points=1024, iterations=80, sh_increase_interval=30,
           rebin_interval=10)
TILE = dict(tile_h=8, tile_w=16, max_per_tile=128)


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_jax_ckpt", ROOT / "export_jax_ckpt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The reference's state after 2 steps, its checkpoint exported and
    imported into a models directory; the frames."""
    tmp = tmp_path_factory.mktemp("jax_ckpt")
    d = default_experiment().to_dict()
    d["opt"].update(OPT)
    d["model"].update(obj_pt_num=256, voxel_size=0.3)
    frames, track = j_synthetic.generate(num_frames=2, height=16, width=64)
    scene = j_build.assemble_scene(frames, [track], Args(d),
                                   capacity_headroom=1.5)
    jt = j_loop.Trainer(scene, frames, Args(d), j_tracer.TraceConfig(
        tile=JTileConfig(**TILE), tile_batch=2))
    jt.run(2, log_every=1)
    src = tmp / "jax" / "ckpt_it_2_good.npz"
    j_ckpt.save(str(src), jt.state, {"iteration": 2,
                                     "eval_psnr": np.float32(12.5)})
    exported = _exporter().main([str(src), "--out", str(tmp / "exported")])
    models = tmp / "port" / "models"
    written = import_jax_ckpt.main(exported + ["--models_dir", str(models)])
    return jt.state, frames, written[0]


def test_export_is_plain_npz(carried):
    _, _, path = carried
    src = path.replace("port/models", "exported")
    with np.load(src, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        assert str(z["__kind__"]) == "dict"
        assert "scene.background.xyz" in z.files and "key" in z.files
    assert meta["kind"] == "TrainState"
    assert meta["metadata"] == {"iteration": 2, "eval_psnr": 12.5}
    assert set(meta["static"]) == {"background", "actors"}


def test_train_state_leaves_bit_for_bit(carried):
    j_state, _, path = carried
    t_state, meta = checkpoint.load(path, "cpu",
                                    opt_args=options.experiment_options().opt)
    assert meta["iteration"] == 2 and meta["eval_psnr"] == 12.5
    for part in ("background", "actors"):
        ja, ta = getattr(j_state.scene, part), getattr(t_state.scene, part)
        for f in ("xyz", "f_dc", "f_rest", "log_scale", "quat",
                  "opacity_logit", "alive"):
            np.testing.assert_array_equal(getattr(ta, f).detach().numpy(),
                                          np.asarray(getattr(ja, f)),
                                          err_msg=f"{part}.{f}")
        assert ta.active_sh_degree == int(np.max(ja.active_sh_degree))
        assert (ta.max_sh_degree, ta.extent) == (ja.max_sh_degree,
                                                 ja.extent)
    np.testing.assert_array_equal(j_state.scene.tracks.translations,
                                  t_state.scene.tracks.translations.numpy())
    for j_opt, t_opt, j_stats, t_stats in (
            (j_state.opt_state_bg, t_state.opt_bg, j_state.stats_bg,
             t_state.stats_bg),
            (j_state.opt_state_actors, t_state.opt_actors,
             j_state.stats_actors, t_state.stats_actors)):
        assert t_opt.steps == 2
        for g in optim.GROUPS:
            adam = next(n for n in jax.tree_util.tree_leaves(
                j_opt.inner_states[g],
                is_leaf=lambda n: hasattr(n, "mu")) if hasattr(n, "mu"))
            st = t_opt.adam.state[t_opt.params[g]]
            np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                          np.asarray(adam.mu[g]), err_msg=g)
            np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                          np.asarray(adam.nu[g]), err_msg=g)
            assert float(st["step"]) == int(adam.count) == 2
        assert np.abs(t_opt.moments("xyz")[0].numpy()).max() > 0.0
        for f in ("grad_accum", "denom"):
            np.testing.assert_array_equal(getattr(t_stats, f).numpy(),
                                          np.asarray(getattr(j_stats, f)))
        assert float(t_stats.denom.sum()) > 0.0
    # No generator crossed over: the fresh one of a new state.
    fresh = torch.Generator().manual_seed(0).get_state()
    assert torch.equal(t_state.generator.get_state(), fresh)
    with np.load(path, allow_pickle=False) as z:
        assert "generator" not in z.files and str(z["__kind__"]) == \
            "TrainState"


def test_resumed_trainer_takes_a_step(carried):
    _, frames, path = carried
    args = options.experiment_options(**OPT)
    t_state, meta = checkpoint.load(path, "cpu", opt_args=args.opt)
    t_frames = port_frames(frames)
    trainer = loop.Trainer(t_state.scene, t_frames, args,
                           t_tracer.TraceConfig(tile=TileConfig(**TILE)))
    trainer.restore(t_state, int(meta["iteration"]))
    before = trainer.state.scene.background.xyz.detach().clone()
    trainer.run(1, log_every=1)
    assert trainer.iteration == 3 and trainer.state.opt_bg.steps == 3
    assert np.isfinite(trainer.history[-1]["loss"])
    assert not torch.equal(trainer.state.scene.background.xyz, before)


def test_unet_variables_carry_over(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(1, 16, 64, 3)).astype(np.float32)
    model = ref_unet.RayDropUNet(in_ch=3)
    v = jax.tree.map(np.asarray, model.init(
        {"params": jax.random.key(1)}, jnp.asarray(x), train=False))
    v = {"params": jax.tree_util.tree_map_with_path(
        lambda p, a: a + (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        if p[-1].key in ("scale", "bias") else a, v["params"]),
        "batch_stats": jax.tree_util.tree_map_with_path(
            lambda p, a: (rng.normal(size=a.shape) * 0.05
                          if p[-1].key == "mean"
                          else rng.uniform(0.5, 1.5, a.shape)
                          ).astype(np.float32), v["batch_stats"])}
    want = np.asarray(model.apply(v, jnp.asarray(x), train=False))
    src = tmp_path / "models" / "unet.npz"
    j_ckpt.save(str(src), v, {"in_ch": 3, "final_loss": np.float32(0.25)})
    exported = _exporter().main([str(src), "--out", str(tmp_path / "x")])
    out = import_jax_ckpt.main(exported + ["--models_dir",
                                           str(tmp_path / "port")])
    assert out[0].endswith("port/unet.npz")
    weights, meta = checkpoint.load(out[0], "cpu")
    assert meta["in_ch"] == 3 and meta["final_loss"] == 0.25
    port = unet.make_unet(meta["in_ch"], "cpu")
    port.load_state_dict({k: torch.as_tensor(a) for k, a in weights.items()})
    port.eval()
    with torch.no_grad():
        got = port(torch.as_tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


def test_import_refuses_other_files(tmp_path):
    checkpoint.save(str(tmp_path / "a.npz"), {"x": np.zeros(3)})
    with pytest.raises(ValueError, match="export_jax_ckpt"):
        import_jax_ckpt.main([str(tmp_path / "a.npz"), "--models_dir",
                              str(tmp_path)])
