"""Ray-drop refinement: train the U-Net on rendered channels (counterpart
of `lidar_rt_tpu.train.refine`).

The reference's post-hoc refinement loop (train.py:386-447): after the
surfels are trained, every train frame is rendered once (detached), and
the U-Net learns to map (raydrop, intensity, depth [+ rays]) to the
recorded drop mask with BCE on the prediction clipped to [1e-7, 1 - 1e-7],
Adam (lr 1e-3, betas 0.9/0.999, eps 1e-8: optax's defaults), gradients
accumulated over `batch_size` frames and divided by their count (a
trailing partial batch included), frames shuffled each epoch with
`random.Random(seed)`, and an optional random azimuth roll (`use_rot`,
train.py:419-424: rays wrap, so rolling the raster is pose-consistent).

The whole dataset stays on its device (46 Waymo train frames x 9 x
64 x 2650 float32 is 281 MB), and nothing is read back to the host but one
mean loss per epoch.
"""

from __future__ import annotations

import random

import torch

from lidar_rt_tpu_torch.data.frames import LiDARFrames
from lidar_rt_tpu_torch.models.unet import RayDropUNet, make_unet, unet_input
from lidar_rt_tpu_torch.train.losses import bce_probs

Tensor = torch.Tensor

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def collect_inputs(render_fn, frames: LiDARFrames, frame_ids: list[int],
                   use_spatial: bool) -> tuple[Tensor, Tensor]:
    """Render every frame once and stack the U-Net's inputs and labels on
    the frames' device.

    render_fn(frame_id) -> dict with depth/intensity/raydrop (H, W).
    Returns (inputs (F, C, H, W), labels (F, 1, H, W): 1 = dropped)."""
    xs, ys = [], []
    for f in frame_ids:
        out = render_fn(f)
        rays = ()
        if use_spatial:
            origin, dirs = frames.rays(f)
            rays = (origin.expand_as(dirs), dirs)
        xs.append(unet_input(out["raydrop"].detach(),
                             out["intensity"].detach(),
                             out["depth"].detach(), *rays)[0])
        ys.append((~frames.mask(f)).float()[None])
    return torch.stack(xs), torch.stack(ys)


def train_unet(inputs: Tensor, labels: Tensor, *, epochs: int = 400,
               batch_size: int = 16, lr: float = 1e-3, seed: int = 0,
               use_rot: bool = False) -> tuple[RayDropUNet, list[float]]:
    """Returns (the trained module in eval mode, mean loss per epoch).

    The weights, the dropout masks and the azimuth rolls are drawn from
    one generator on the inputs' device seeded with `seed`."""
    dev = inputs.device
    n, _, _, width = inputs.shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = make_unet(inputs.shape[1], dev, gen)
    model.train()
    params = list(model.parameters())
    opt = torch.optim.Adam(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)
    cols = torch.arange(width, device=dev)

    def apply_accumulated(count: int) -> None:
        for p in params:
            # A level pooled to nothing leaves its weights without a
            # gradient: Adam steps them with a zero one, as optax does.
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            p.grad.div_(count)
        opt.step()
        opt.zero_grad(set_to_none=True)

    rng = random.Random(seed)
    history = []
    for _ in range(epochs):
        order = list(range(n))
        rng.shuffle(order)
        total = torch.zeros((), device=dev)
        count = 0
        for f in order:
            x, y = inputs[f:f + 1], labels[f:f + 1]
            if use_rot:
                shift = torch.randint(0, width, (), generator=gen,
                                      device=dev)
                roll = torch.remainder(cols - shift, width)
                x, y = x.index_select(3, roll), y.index_select(3, roll)
            loss = bce_probs(model(x, gen), y)
            loss.backward()
            total += loss.detach()
            count += 1
            if count == batch_size:
                apply_accumulated(count)
                count = 0
        if count:
            apply_accumulated(count)
        history.append((total / n).item())
    model.eval()
    return model, history


def apply_unet(model: RayDropUNet, raydrop: Tensor, intensity: Tensor,
               depth: Tensor, ray_o: Tensor | None = None,
               ray_d: Tensor | None = None) -> Tensor:
    """Inference: the refined drop probability (H, W) (eval.py:129-144),
    with the module in eval mode (running BatchNorm statistics)."""
    model.eval()
    with torch.no_grad():
        return model(unet_input(raydrop, intensity, depth, ray_o,
                                ray_d))[0, 0]
