"""LPIPS with the AlexNet backbone (counterpart of
`lidar_rt_tpu.eval.lpips`), as torch modules.

The reference's `lpips.LPIPS(net="alex")` (eval.py:75,298-304): AlexNet
conv features after each ReLU, unit-normalised over channels, squared
differences, 1x1 "lin" weights, spatial mean, summed over the five stages.

Pretrained weights are not in the repository.  `make_lpips_fn` reads them
from `$LIDAR_RT_LPIPS_WEIGHTS` (or its argument) in either of two forms:

- one path ending in `.npz`, the reference's file
  (lidar_rt_tpu/eval/lpips.py:10-21): conv{i}_w (O, I, kh, kw), conv{i}_b
  (O,) and lin{i}_w (1, C_i, 1, 1) for i in 0..4, as
  `convert_torch_checkpoints` (or `python -m lidar_rt_tpu_torch.eval.lpips
  alexnet.pth alex.pth lpips.npz`) writes it;
- the two `.pth` state dicts joined by the path separator
  (`alexnet.pth:alex.pth` on Linux): the torchvision AlexNet state dict
  (`features.{0,3,6,8,10}.weight/bias`) and the LPIPS v0.1 lin heads
  (`{i}.1.weight` or `lin{i}.model.1.weight`), loaded as they are.

Without them (or where the files named are missing) it returns None, and
eval reports the metric as unavailable.

Inputs follow the reference's call (eval.py:300-304,328-332): clamped,
unscaled images with `normalize=True`, i.e. the net sees 2x - 1, and a
single-channel range or intensity image is repeated over 3 channels.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ENV_VAR = "LIDAR_RT_LPIPS_WEIGHTS"

# AlexNet features: (out_ch, kernel, stride, padding, pool_before), and the
# index of each conv in torchvision's `features` Sequential.
CONVS = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]
FEATURE_INDEX = (0, 3, 6, 8, 10)
N_CHANNELS = [c[0] for c in CONVS]

# Input z-score constants (lpipsPyTorch/modules/networks.py:40-43).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """`forward(x, y)`: the LPIPS distance (N,) between (N, 3, H, W)
    images in [-1, 1].  Parameters `convs.{i}.weight/bias` (torchvision's
    AlexNet convs in order) and `lins.{i}` (1, C_i, 1, 1)."""

    def __init__(self):
        super().__init__()
        in_ch, convs = 3, []
        for out_ch, k, stride, pad, _ in CONVS:
            convs.append(nn.Conv2d(in_ch, out_ch, k, stride, pad))
            in_ch = out_ch
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ParameterList(
            [nn.Parameter(torch.zeros(1, c, 1, 1)) for c in N_CHANNELS])
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None,
                                                           None])
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None,
                                                           None])

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """AlexNet conv features after each ReLU."""
        x = (x - self.shift) / self.scale
        feats = []
        for conv, (*_, pool_before) in zip(self.convs, CONVS):
            if pool_before:
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(conv(x))
            feats.append(x)
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for a, b, w in zip(self.features(x), self.features(y), self.lins):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            total = total + (d * w).sum(1).mean((-2, -1))
        return total


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt((x * x).sum(1, keepdim=True)) + eps)


def new_lpips(device: str | torch.device) -> LPIPS:
    """An LPIPS module on `device`, built without touching torch's global
    random state; its weights are left for `load_state` or
    `init_weights` to fill."""
    with torch.device("meta"):
        model = LPIPS()
    model = model.to_empty(device=device)
    model.shift.copy_(torch.tensor(_SHIFT)[None, :, None, None])
    model.scale.copy_(torch.tensor(_SCALE)[None, :, None, None])
    return model


def init_weights(model: LPIPS, generator: torch.Generator) -> LPIPS:
    """Seeded random weights with the reference's `init_params` scheme
    (conv weights N(0, 1/fan_in), zero biases, lin weights |N(0, 1)| /
    100), drawn from `generator`: the real topology without pretrained
    weights, for tests and the card's smoke run."""
    with torch.no_grad():
        for conv, lin in zip(model.convs, model.lins):
            w = conv.weight
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=w.device) / w[0].numel() ** 0.5)
            conv.bias.zero_()
            lin.copy_(torch.randn(lin.shape, generator=generator,
                                  device=lin.device).abs() * 0.01)
    return model


def load_state(model: LPIPS, alexnet_state: dict, lin_state: dict) -> LPIPS:
    """Load torchvision's AlexNet state dict and the LPIPS v0.1 lin heads
    (either key layout; a checkpoint's "state_dict" entry if it has one)
    into `model`, on the model's device."""
    alexnet_state = alexnet_state.get("state_dict", alexnet_state)
    lin_state = lin_state.get("state_dict", lin_state)
    state = {"shift": model.shift, "scale": model.scale}
    for i, idx in enumerate(FEATURE_INDEX):
        state[f"convs.{i}.weight"] = alexnet_state[f"features.{idx}.weight"]
        state[f"convs.{i}.bias"] = alexnet_state[f"features.{idx}.bias"]
        key = f"{i}.1.weight" if f"{i}.1.weight" in lin_state \
            else f"lin{i}.model.1.weight"
        state[f"lins.{i}"] = lin_state[key]
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) if
                           not isinstance(v, torch.Tensor) else v
                           for k, v in state.items()})
    return model


def _reference_state(arrays) -> tuple[dict, dict]:
    """The reference's `.npz` arrays as the two state dicts that
    `load_state` takes."""
    alexnet, lins = {}, {}
    for i, idx in enumerate(FEATURE_INDEX):
        alexnet[f"features.{idx}.weight"] = arrays[f"conv{i}_w"]
        alexnet[f"features.{idx}.bias"] = arrays[f"conv{i}_b"]
        lins[f"{i}.1.weight"] = arrays[f"lin{i}_w"]
    return alexnet, lins


def _load_weights(spec: str, device) -> LPIPS | None:
    """An LPIPS module on `device` from a weights spec (see the module
    docstring), or None where it names no existing file(s)."""
    if spec.endswith(".npz"):
        if not os.path.exists(spec):
            return None
        with np.load(spec, allow_pickle=False) as z:
            alexnet, lins = _reference_state({k: np.array(z[k])
                                              for k in z.files})
        return load_state(new_lpips(device), alexnet, lins)
    paths = spec.split(os.pathsep) if spec else []
    if len(paths) != 2 or not all(os.path.exists(p) for p in paths):
        return None
    alexnet, lins = (torch.load(p, map_location="cpu", weights_only=True)
                     for p in paths)
    return load_state(new_lpips(device), alexnet, lins)


def make_lpips_fn(model: LPIPS | None = None, weights: str | None = None,
                  device: str | torch.device = "cuda"):
    """-> callable(pred (H, W), gt (H, W)) -> float, or None without
    weights.  Resolution order: `model` > `weights` >
    $LIDAR_RT_LPIPS_WEIGHTS ("lpips.npz" or
    "alexnet.pth<pathsep>alex.pth").  The images are numpy arrays or
    tensors; the network runs on `device` (the card unless the caller
    names another) or on the given model's device."""
    if model is None:
        model = _load_weights(weights or os.environ.get(ENV_VAR, ""),
                              device)
        if model is None:
            return None
    model.eval()
    dev = next(model.parameters()).device

    def fn(pred, gt) -> float:
        def prep(img):
            a = torch.as_tensor(img, dtype=torch.float32, device=dev)
            return (a * 2.0 - 1.0)[None, None].expand(1, 3, *a.shape)

        with torch.no_grad():
            return float(model(prep(pred), prep(gt))[0])

    return fn


def _numpy(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def convert_torch_checkpoints(alexnet_state: dict, lin_state: dict,
                              out_path: str) -> None:
    """Write the reference's `.npz` (see the module docstring) from
    torchvision's AlexNet state dict (features.{0,3,6,8,10}) and the LPIPS
    v0.1 lin heads ({i}.1.weight, or lin{i}.model.1.weight); either may be
    a checkpoint with a "state_dict" entry."""
    alexnet_state = alexnet_state.get("state_dict", alexnet_state)
    lin_state = lin_state.get("state_dict", lin_state)
    arrays = {}
    for i, idx in enumerate(FEATURE_INDEX):
        arrays[f"conv{i}_w"] = _numpy(alexnet_state[f"features.{idx}.weight"])
        arrays[f"conv{i}_b"] = _numpy(alexnet_state[f"features.{idx}.bias"])
        key = f"{i}.1.weight" if f"{i}.1.weight" in lin_state \
            else f"lin{i}.model.1.weight"
        arrays[f"lin{i}_w"] = _numpy(lin_state[key])
    np.savez(out_path, **arrays)


def main(argv: list[str] | None = None) -> None:
    """Write the LPIPS weights file from the two torch checkpoints:

        python -m lidar_rt_tpu_torch.eval.lpips alexnet.pth alex.pth \
            lpips.npz [--device cuda]

    `alexnet.pth` is torchvision's AlexNet (ImageNet) state dict,
    `alex.pth` the LPIPS v0.1 lin heads; then
    `export LIDAR_RT_LPIPS_WEIGHTS=.../lpips.npz`.  Prints a self-check
    LPIPS value, computed on --device (the card by default), so that a bad
    file fails here rather than as unavailable columns at eval time."""
    p = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    p.add_argument("alexnet_pth")
    p.add_argument("lin_pth")
    p.add_argument("out_npz")
    p.add_argument("--device", default="cuda")
    ns = p.parse_args(argv)
    convert_torch_checkpoints(
        *(torch.load(path, map_location="cpu", weights_only=True)
          for path in (ns.alexnet_pth, ns.lin_pth)), ns.out_npz)
    fn = make_lpips_fn(weights=ns.out_npz, device=ns.device)
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (64, 64)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    val = fn(a, b)
    if not np.isfinite(val):
        raise SystemExit("self-check LPIPS is not finite: a bad checkpoint?")
    print(f"wrote {ns.out_npz} (self-check LPIPS {val:.4f})")


if __name__ == "__main__":
    main()
