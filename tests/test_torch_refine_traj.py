"""The refine's trajectory in both packages: `train_unet` over several
epochs from one set of initial weights, on the same frames in the same
order, held per frame at the end.

Inputs are made from a seed with numpy: N frames of H x W with
`use_spatial`'s nine channels, the sensor drifting DRIFT metres along x
across them, as along a trajectory.  The initial weights are the
reference's `model.init` from `jax.random.key(SEED)` as its `train_unet`
draws them, carried to the port by `unet_state_from_flax`; both packages
shuffle frames with `random.Random(SEED)`; dropout is off in both, in
this test only (the reference's modules are subclassed with rate 0.0
under their own names, so their parameters keep their paths; the port's
modules get rate 0.0).

Both run in float64 (the reference's flax layers subclassed, in this test
only, to hold float64 parameters and statistics; the port's module
in float64): in float32 neither package's trajectory follows its own
float64 one, since a frame's gradient through the U-Net's small
BatchNorm levels (four samples a channel at 16 x 64) loses digits in
both, so two float32 trajectories part after the first Adam step;
`test_float32_gradient_against_float64` shows this on one frame.

Held, after EPOCHS epochs of BATCH-frame accumulation: the loss history
to 1e-6 relative; the running statistics and every frame's eval-mode
output within ATOL64;
every frame's train-mode output (its own batch statistics) likewise; and
in both packages the same split between the two modes, which grows with
the frame's distance from the frames' mean origin.
"""

import copy
import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu.models import unet as ref_unet
from lidar_rt_tpu.train import refine as ref_refine
from lidar_rt_tpu_torch.models import unet
from lidar_rt_tpu_torch.train import losses, refine

torch.set_num_threads(1)

SEED, N, H, W = 3, 6, 16, 64
EPOCHS, BATCH = 3, 2
DRIFT = 27.5            # metres along x from the first frame to the last
# float64 in both: 9 Adam steps through convolutions summed in another
# order part the outputs by up to ~4e-8 (eps 1e-8 lets a gradient summed
# to near zero over a batch take an lr-sized step either way); float32
# trajectories part by 0.2.
ATOL64 = 1e-6


def _inputs():
    """(N, H, W, 9) raydrop, intensity, depth, ray origin, ray direction
    and (N, H, W, 1) drop labels, as float64 numpy."""
    rng = np.random.default_rng(SEED)
    raydrop = rng.uniform(size=(N, H, W))
    inc = np.linspace(-0.31, 0.04, H)[:, None]
    az = np.linspace(np.pi, -np.pi, W, endpoint=False)[None, :]
    x = np.zeros((N, H, W, 9))
    x[..., 0] = raydrop
    x[..., 1] = rng.uniform(size=(N, H, W))
    x[..., 2] = rng.uniform(2.0, 60.0, size=(N, H, W))
    for f in range(N):
        x[f, ..., 3:6] = [DRIFT * f / (N - 1), 0.02 * f, 2.1]
    x[..., 6] = np.cos(inc) * np.cos(az)
    x[..., 7] = np.cos(inc) * np.sin(az)
    x[..., 8] = np.sin(inc)
    labels = (raydrop + 0.3 * rng.normal(size=raydrop.shape)) > 0.6
    return x, labels.astype(np.float64)[..., None]


class DoubleConv(ref_unet.DoubleConv):
    """The reference's block with dropout off; its name, and so its
    parameters' paths, unchanged."""

    dropout: float = 0.0


class AttnBlock(ref_unet.AttnBlock):
    dropout: float = 0.0


class Conv(flax.linen.Conv):
    param_dtype: jnp.dtype = jnp.float64


class BatchNorm(flax.linen.BatchNorm):
    param_dtype: jnp.dtype = jnp.float64
    force_float32_reductions: bool = False


class _Linen(types.ModuleType):
    """`flax.linen` with float64 Conv and BatchNorm under their names."""

    Conv, BatchNorm = Conv, BatchNorm

    def __getattr__(self, name):
        return getattr(flax.linen, name)


def _no_dropout(monkeypatch, float64: bool):
    monkeypatch.setattr(ref_unet, "DoubleConv", DoubleConv)
    monkeypatch.setattr(ref_unet, "AttnBlock", AttnBlock)
    if float64:
        monkeypatch.setattr(ref_unet, "nn", _Linen("nn"))


class _CompiledInit:
    """The reference's RayDropUNet whose `init` runs as one compiled
    function (flax initialises op by op otherwise, which would take most
    of this file's time); every other attribute is the module's."""

    def __init__(self, in_ch: int):
        self.module = ref_unet.RayDropUNet(in_ch=in_ch)
        self._init = jax.jit(lambda rngs, x: self.module.init(rngs, x,
                                                              train=True))

    def init(self, rngs, x, train: bool):
        assert train
        return self._init(rngs, x)

    def __getattr__(self, name):
        return getattr(self.module, name)


def _initial(model, x):
    """The variables the reference's train_unet initialises from SEED."""
    key, k_init = jax.random.split(jax.random.key(SEED))
    return jax.tree.map(np.asarray, model.init(
        {"params": k_init, "dropout": key}, jnp.asarray(x[:1]),
        train=True))


def _port_unet(variables, dtype):
    """The port's U-Net in `dtype` holding `variables` as they are (no
    rounding through float32 on the way), dropout off."""
    m = unet.make_unet(9, "cpu").to(dtype)
    m.load_state_dict({k: torch.as_tensor(np.array(a)) for k, a in
                       unet.unet_state_from_flax(variables).items()})
    for mod in m.modules():
        if hasattr(mod, "dropout"):
            mod.dropout = 0.0
    return m


@pytest.fixture(scope="module")
def trained():
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(True):
            _no_dropout(mp, float64=True)
            x, y = _inputs()
            compiled = _CompiledInit(9)
            mp.setattr(ref_refine, "RayDropUNet", lambda in_ch: compiled)
            init = _initial(compiled, x)
            assert jax.tree.leaves(init)[0].dtype == np.float64
            model, variables, ref_hist = ref_refine.train_unet(
                x, y, epochs=EPOCHS, batch_size=BATCH, seed=SEED)
            mp.setattr(refine, "make_unet",
                       lambda in_ch, device, generator=None:
                       _port_unet(init, torch.float64))
            xt = torch.as_tensor(x).permute(0, 3, 1, 2).contiguous()
            yt = torch.as_tensor(y).permute(0, 3, 1, 2).contiguous()
            port, port_hist = refine.train_unet(
                xt, yt, epochs=EPOCHS, batch_size=BATCH, seed=SEED)
            out = {"ref_hist": ref_hist, "port_hist": port_hist,
                   "ref_state": unet.unet_state_from_flax(
                       jax.tree.map(np.asarray, variables)),
                   "port_state": {k: v.numpy() for k, v in
                                  port.state_dict().items()}}
            # Each mode's forward compiled once for the N frames.
            eval_fn = jax.jit(lambda v, xf: ref_refine.apply_unet(
                model, v, xf[..., 0], xf[..., 1], xf[..., 2], xf[..., 3:6],
                xf[..., 6:]))
            train_fn = jax.jit(lambda v, xf: model.apply(
                v, xf[None], train=True, rngs={"dropout": jax.random.key(0)},
                mutable=["batch_stats"])[0][0, ..., 0])
            for f in range(N):
                xf = jnp.asarray(x[f])
                out["ref", "eval", f] = np.asarray(eval_fn(variables, xf))
                out["ref", "train", f] = np.asarray(train_fn(variables, xf))
                xtf = xt[f]
                out["port", "eval", f] = refine.apply_unet(
                    port, xtf[0], xtf[1], xtf[2],
                    xtf[3:6].permute(1, 2, 0),
                    xtf[6:].permute(1, 2, 0)).numpy()
                with torch.no_grad():
                    out["port", "train", f] = copy.deepcopy(port).train()(
                        xtf[None], torch.Generator())[0, 0].numpy()
        return out
    finally:
        mp.undo()


def test_loss_history(trained):
    assert len(trained["port_hist"]) == len(trained["ref_hist"]) == EPOCHS
    # The port sums an epoch's losses in float32.
    np.testing.assert_allclose(trained["port_hist"], trained["ref_hist"],
                               rtol=1e-6)
    assert trained["ref_hist"][-1] < trained["ref_hist"][0]


def test_running_statistics(trained):
    ref, port = trained["ref_state"], trained["port_state"]
    names = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 18
    for k in names:
        assert np.abs(port[k] - ref[k]).max() <= ATOL64 * max(
            1.0, np.abs(ref[k]).max()), k
    # Trained: every running mean moved off its initial zero.
    assert all(np.abs(ref[k]).max() > 0 for k in names
               if k.endswith("mean"))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_per_frame_outputs(trained, mode):
    for f in range(N):
        want = trained["ref", mode, f]
        assert want.shape == (H, W)
        np.testing.assert_allclose(trained["port", mode, f], want, rtol=0,
                                   atol=ATOL64, err_msg=f"frame {f}")


def test_train_eval_split_per_frame(trained):
    """Per frame, the mean |eval - train| drop probability: equal in both
    packages, and largest at the trajectory's ends, furthest from the
    frames' mean origin."""
    split = {}
    for side in ("ref", "port"):
        split[side] = np.array([
            np.abs(trained[side, "eval", f] - trained[side, "train", f]
                   ).mean() for f in range(N)])
    np.testing.assert_allclose(split["port"], split["ref"], rtol=0,
                               atol=ATOL64)
    middle = split["ref"][N // 2 - 1: N // 2 + 1].max()
    assert max(split["ref"][0], split["ref"][-1]) > middle


def _bce(out, y):
    """The reference's refine loss (train/refine.py's grad_one)."""
    pred = jnp.clip(out, 1e-7, 1.0 - 1e-7)
    return jnp.mean(-(y * jnp.log(pred) + (1 - y) * jnp.log(1 - pred)))


def test_float32_gradient_against_float64(monkeypatch):
    """One frame's train-mode gradient from one set of float32 weights,
    the frame furthest along the trajectory: the two packages' float64
    gradients agree to 1e-9 of each field's largest value.  Each float32
    gradient points the float64 one's way (cosine over all fields > 0.9)
    but loses digits field by field: the inputs' metres (depth, the
    sensor's origin) meet BatchNorm levels of four samples a channel.
    Printed (`-s`): each package's cosine and worst field's float32 error
    over its largest value."""
    _no_dropout(monkeypatch, float64=False)
    x, y = _inputs()
    f = N - 1
    model = _CompiledInit(9)
    init = _initial(model, x.astype(np.float32))
    grads = {}
    for name, dt in (("ref32", np.float32), ("ref64", np.float64)):
        with jax.enable_x64(dt == np.float64):
            v = jax.tree.map(lambda a: jnp.asarray(a, dt), init)

            @jax.jit
            def grad_fn(p, xx, yy):
                def loss_fn(p):
                    out = model.apply(
                        {"params": p, "batch_stats": v["batch_stats"]}, xx,
                        train=True, mutable=["batch_stats"],
                        rngs={"dropout": jax.random.key(0)})[0]
                    return _bce(out, yy)
                return jax.grad(loss_fn)(p)

            g = grad_fn(v["params"], jnp.asarray(x[f:f + 1], dt),
                        jnp.asarray(y[f:f + 1], dt))
            grads[name] = unet.unet_state_from_flax(
                {"params": jax.tree.map(lambda a: np.asarray(a, np.float64),
                                        g),
                 "batch_stats": init["batch_stats"]})
    for name, dt in (("port32", torch.float32), ("port64", torch.float64)):
        m = _port_unet(init, dt).train()
        xt = torch.as_tensor(x[f:f + 1]).permute(0, 3, 1, 2).to(dt)
        yt = torch.as_tensor(y[f:f + 1]).permute(0, 3, 1, 2).to(dt)
        losses.bce_probs(m(xt, torch.Generator()), yt).backward()
        grads[name] = {k: p.grad.double().numpy()
                       for k, p in m.named_parameters()}
    exact = grads["port64"]
    fields = [k for k in exact if k != "stem.bias"]   # zero: a BN follows
    worst = {}
    for k in fields:
        scale = np.abs(exact[k]).max()
        assert np.abs(grads["ref64"][k] - exact[k]).max() <= 1e-9 * scale, k
    flat = np.concatenate([exact[k].ravel() for k in fields])
    for name in ("ref32", "port32"):
        got = np.concatenate([grads[name][k].ravel() for k in fields])
        cos = got @ flat / (np.linalg.norm(got) * np.linalg.norm(flat))
        assert cos > 0.9, (name, cos)
        worst[name] = (float(cos), max(
            float(np.abs(grads[name][k] - exact[k]).max()
                  / np.abs(exact[k]).max()) for k in fields))
    print("float32 gradient (cosine, worst field's error / its largest "
          "value):", worst)
