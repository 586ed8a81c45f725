"""The port's ray-drop U-Net and refine stage against the reference's flax
module and optax loop: the eval-mode forward from converted weights
(atol 1e-5), the train-mode BatchNorm statistics and gradients of the
submodules (atol 1e-5; gradients compared after scaling by the reference's
largest magnitude), the refine's BCE clip (1e-6 relative), its Adam
steps per epoch, and that it learns a toy mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu.models import unet as ref_unet
from lidar_rt_tpu_torch.models import unet
from lidar_rt_tpu_torch.train import losses, refine

torch.set_num_threads(1)


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _random_stats(stats, rng):
    """Running statistics a trained net could hold: small means, variances
    in [0.5, 1.5] (all-positive means would zero every ReLU)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.05 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        stats)


@pytest.mark.parametrize("shape", [(16, 64, 3), (12, 50, 9), (66, 40, 3)])
def test_unet_eval_forward_matches_flax(shape):
    """16x64, an odd 12x50 (pooled to an empty bottleneck, then padded
    back) and 66 rows (a KITTI-360 raster's odd halving)."""
    h, w, c = shape
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(1, h, w, c)).astype(np.float32)
    model = ref_unet.RayDropUNet(in_ch=c)
    v = _to_numpy(model.init({"params": jax.random.key(1)}, jnp.asarray(x),
                             train=False))
    # flax's initial kernels, BatchNorm affines and statistics off their
    # initial values.
    v = {"params": jax.tree_util.tree_map_with_path(
        lambda p, a: a + (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        if p[-1].key in ("scale", "bias") else a, v["params"]),
        "batch_stats": _random_stats(v["batch_stats"], rng)}
    want = np.asarray(model.apply(v, jnp.asarray(x), train=False))

    port = unet.make_unet(c, "cpu")
    port.load_state_dict({k: torch.as_tensor(a) for k, a in
                          unet.unet_state_from_flax(v).items()})
    port.eval()
    with torch.no_grad():
        got = port(torch.as_tensor(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, h, w, 1)
    assert float(want.std()) > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("block,shape", [
    ("double", (2, 6, 10, 8)), ("double", (1, 2, 3, 8)),
    ("attn", (2, 3, 5, 16)), ("attn", (1, 1, 2, 16))])
def test_train_mode_submodules_match_flax(block, shape):
    """Train-mode outputs, updated running statistics (flax's momentum 0.99
    and biased variance: at 1x2x3 the unbiased one would differ by 6/5)
    and the gradients of a fixed cotangent, against flax."""
    b, h, w, c = shape
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    if block == "double":
        ref = ref_unet.DoubleConv(16, mid_ch=12, dropout=0.0)
        port = unet.DoubleConv(c, 16, mid_ch=12, dropout=0.0)
        names = {"bn1": "BatchNorm_0", "conv1": "Conv_0", "bn2": "BatchNorm_1",
                 "conv2": "Conv_1"}
    else:
        ref = ref_unet.AttnBlock(dropout=0.0)
        port = unet.AttnBlock(c, dropout=0.0)
        names = {"norm": "BatchNorm_0", "qkv": "Conv_0", "proj": "Conv_1"}
    v = _to_numpy(ref.init(jax.random.key(2), jnp.asarray(x), train=False))
    params = jax.tree.map(
        lambda a: a + (rng.normal(size=a.shape) * 0.1).astype(np.float32),
        v["params"])
    stats = _random_stats(v["batch_stats"], rng)
    # Dropout 0.0 draws nothing, but flax's train mode asks for the rng.
    rngs = {"dropout": jax.random.key(3)}
    out_shape = jax.eval_shape(
        lambda: ref.apply({"params": params, "batch_stats": stats},
                          jnp.asarray(x), train=True, rngs=rngs,
                          mutable=["batch_stats"])[0]).shape
    cot = rng.normal(size=out_shape).astype(np.float32)

    def loss(p, xx):
        out, upd = ref.apply({"params": p, "batch_stats": stats}, xx,
                             train=True, rngs=rngs, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd["batch_stats"])

    (_, (want, want_stats)), (g_p, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    state = {}
    for mod, fl in names.items():
        if fl.startswith("Conv"):
            state[f"{mod}.weight"] = params[fl]["kernel"].transpose(3, 2, 0, 1)
        else:
            state[f"{mod}.weight"] = params[fl]["scale"]
            state[f"{mod}.bias"] = params[fl]["bias"]
            state[f"{mod}.running_mean"] = stats[fl]["mean"]
            state[f"{mod}.running_var"] = stats[fl]["var"]
            state[f"{mod}.num_batches_tracked"] = np.asarray(0)
    port.load_state_dict({k: torch.as_tensor(np.ascontiguousarray(a))
                          for k, a in state.items()})
    port.train()
    xt = torch.as_tensor(x).permute(0, 3, 1, 2).requires_grad_()
    got = port(xt)
    (got * torch.as_tensor(cot).permute(0, 3, 1, 2)).sum().backward()

    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)
    for mod, fl in names.items():
        if fl.startswith("Batch"):
            bn = getattr(port, mod)
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       want_stats[fl]["mean"], atol=1e-5)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       want_stats[fl]["var"], atol=1e-5)

    def close(a, b):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-5)

    close(xt.grad.permute(0, 2, 3, 1).numpy(), g_x)
    for mod, fl in names.items():
        m = getattr(port, mod)
        if fl.startswith("Conv"):
            close(m.weight.grad.permute(2, 3, 1, 0).numpy(),
                  g_p[fl]["kernel"])
        else:
            close(m.weight.grad.numpy(), g_p[fl]["scale"])
            close(m.bias.grad.numpy(), g_p[fl]["bias"])


def test_bce_clip_matches_the_reference():
    """The refine's BCE clips the prediction to [1e-7, 1 - 1e-7] (a
    certain wrong prediction costs -log(1e-7), not
    F.binary_cross_entropy's 100)."""
    pred = np.array([0.0, 1.0, 1e-9, 0.3, 1.0 - 1e-9, 0.999], np.float32)
    label = np.array([1.0, 0.0, 1.0, 0.0, 0.0, 1.0], np.float32)
    p = jnp.clip(jnp.asarray(pred), 1e-7, 1.0 - 1e-7)
    want = float(jnp.mean(-(label * jnp.log(p)
                            + (1 - label) * jnp.log(1 - p))))
    got = float(losses.bce_probs(torch.as_tensor(pred),
                                 torch.as_tensor(label)))
    assert got == pytest.approx(want, rel=1e-6)
    assert got < 50.0


def test_adam_steps_per_epoch_include_the_trailing_batch(monkeypatch):
    """5 frames in batches of 2: two full batches and a trailing one of 1,
    so 3 Adam steps an epoch."""
    steps = []
    real_step = torch.optim.Adam.step

    def counting_step(self, *a, **k):
        steps.append(1)
        return real_step(self, *a, **k)

    monkeypatch.setattr(torch.optim.Adam, "step", counting_step)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(size=(5, 3, 16, 16)).astype(np.float32))
    y = (x[:, 2:3] > 0.5).float()
    _, hist = refine.train_unet(x, y, epochs=2, batch_size=2, lr=1e-3)
    assert len(steps) == 6 and len(hist) == 2


def test_refinement_learns_mask():
    """The reference's toy task (tests/test_eval.py): drop = depth > 0.5."""
    rng = np.random.default_rng(0)
    n, h, w = 4, 16, 32
    inputs = rng.uniform(size=(n, 3, h, w)).astype(np.float32)
    labels = (inputs[:, 2:3] > 0.5).astype(np.float32)
    x, y = torch.as_tensor(inputs), torch.as_tensor(labels)
    model, hist = refine.train_unet(x, y, epochs=24, batch_size=2, lr=3e-3)
    assert hist[-1] < 0.5 * hist[0]
    accs = []
    for f in range(n):
        out = refine.apply_unet(model, x[f, 0], x[f, 1], x[f, 2])
        accs.append(((out > 0.5) == (y[f, 0] > 0.5)).float().mean().item())
    assert np.mean(accs) > 0.75, accs


def test_collect_inputs_and_rays():
    """Inputs stacked (F, 9, H, W) on the frames' device: raydrop,
    intensity, depth, ray origin, ray direction; labels 1 = dropped."""
    from lidar_rt_tpu_torch.data import synthetic

    frames, _ = synthetic.generate(num_frames=2, height=8, width=32,
                                   device="cpu")

    def render(f):
        d = frames.depth(f)
        return {"raydrop": d * 0 + 0.25, "intensity": frames.intensity(f),
                "depth": d}

    x, y = refine.collect_inputs(render, frames, [1, 0], use_spatial=True)
    assert x.shape == (2, 9, 8, 32) and y.shape == (2, 1, 8, 32)
    origin, dirs = frames.rays(1)
    torch.testing.assert_close(x[0, 3:6], origin[:, None, None].expand(
        3, 8, 32), rtol=0, atol=0)
    torch.testing.assert_close(x[0, 6:], dirs.permute(2, 0, 1), rtol=0,
                               atol=0)
    torch.testing.assert_close(y[1, 0], (~frames.mask(0)).float())
    x3, _ = refine.collect_inputs(render, frames, [0], use_spatial=False)
    assert x3.shape == (1, 3, 8, 32)


def test_dropout_needs_a_generator():
    model = unet.make_unet(3, "cpu", torch.Generator().manual_seed(0))
    model.train()
    with pytest.raises(ValueError, match="generator"):
        model(torch.zeros(1, 3, 16, 16))
