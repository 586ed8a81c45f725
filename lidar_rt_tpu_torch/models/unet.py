"""Ray-drop refinement U-Net (counterpart of `lidar_rt_tpu.models.unet`),
NCHW.

The reference's LiDAR4D-derived refinement net (lib/scene/unet.py:148-181):
a 1x1 stem to 32 channels, four maxpool double-conv downs
(32-64-128-256-256), a multi-head self-attention bottleneck, four bilinear
2x upsample ups with skip connections, a BN-ReLU-1x1 head and a sigmoid.
Inputs are (raydrop, intensity, depth) [+ ray origin and direction with
`use_spatial`: 9 channels] (train.py:398-417); the output is the refined
ray-drop probability.

The layers follow the flax module's semantics, which `unet_state_from_flax`
maps weight for weight:
  * BatchNorm as flax's: momentum 0.99 (torch's `momentum=0.01`), eps
    1e-5, and in training the batch's *biased* variance (mean(x^2) -
    mean(x)^2) both to normalise and to update the running variance;
  * DoubleConv is (BN -> ReLU -> Dropout -> 3x3 conv without bias) x 2;
    the stem and the head convs have biases;
  * max pooling drops a trailing odd row or column (flax's VALID), and an
    upsampled map is zero-padded to its skip's size, then concatenated as
    [skip, up];
  * attention dropout masks the *logits* to -1e12 before the softmax;
  * a level pooled to zero rows or columns (a raster under 16 rows) is an
    empty tensor, as in flax: its convolutions give an empty map and its
    upsampling zeros.
Dropout masks are drawn from an explicit `torch.Generator` passed to
`forward`; in eval mode nothing is drawn.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

# flax's lecun_normal: a normal truncated at 2 std, rescaled to unit std.
_TRUNC_STD = 0.87962566103423978


def _dropout(x: Tensor, p: float, training: bool,
             generator: torch.Generator | None) -> Tensor:
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training draws from an explicit "
                         "torch.Generator: pass generator=")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


class BatchNorm(nn.BatchNorm2d):
    """flax `nn.BatchNorm` in NCHW (module docstring)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.01)

    def forward(self, x: Tensor) -> Tensor:
        if x.numel() == 0:
            return x
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = (0, 2, 3)
        mean = x.mean(dims)
        var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1.0 - m) * self.running_mean
                                    + m * mean)
            self.running_var.copy_((1.0 - m) * self.running_var + m * var)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class DoubleConv(nn.Module):
    """(BN -> ReLU -> Dropout -> Conv3x3) x 2 (reference unet.py:14-35)."""

    def __init__(self, in_ch: int, out_ch: int, mid_ch: int | None = None,
                 dropout: float = 0.1):
        super().__init__()
        mid = mid_ch or out_ch
        self.out_ch, self.dropout = out_ch, dropout
        self.bn1 = BatchNorm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, mid, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(mid)
        self.conv2 = nn.Conv2d(mid, out_ch, 3, padding=1, bias=False)

    def forward(self, x: Tensor,
                generator: torch.Generator | None = None) -> Tensor:
        if x.numel() == 0:
            return x.new_zeros(x.shape[0], self.out_ch, *x.shape[2:])
        for bn, conv in ((self.bn1, self.conv1), (self.bn2, self.conv2)):
            x = F.relu(bn(x))
            x = conv(_dropout(x, self.dropout, self.training, generator))
        return x


class AttnBlock(nn.Module):
    """Spatial multi-head self-attention bottleneck (unet.py:76-115),
    with a residual connection."""

    def __init__(self, channels: int, num_heads: int = 8,
                 dropout: float = 0.1):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout
        self.norm = BatchNorm(channels)
        self.qkv = nn.Conv2d(channels, 3 * channels, 1, bias=False)
        self.proj = nn.Conv2d(channels, channels, 1, bias=False)

    def forward(self, x: Tensor,
                generator: torch.Generator | None = None) -> Tensor:
        if x.numel() == 0:
            return x
        b, c, h, w = x.shape
        n, hd = self.num_heads, c // self.num_heads
        qkv = self.qkv(self.norm(x)).reshape(b, 3 * c, h * w).transpose(1, 2)

        def heads(t: Tensor) -> Tensor:              # -> (b, n, hw, hd)
            return t.reshape(b, h * w, n, hd).transpose(1, 2)

        q, k, v = (heads(t) for t in qkv.split(c, dim=-1))
        logits = torch.einsum("bnqd,bnkd->bnqk", q, k) * (hd ** -0.5)
        if self.training and self.dropout > 0.0:
            if generator is None:
                raise ValueError("attention dropout in training draws from "
                                 "an explicit torch.Generator")
            mask = torch.rand(logits.shape, generator=generator,
                              device=x.device) < self.dropout
            logits = logits.masked_fill(mask, -1e12)
        out = torch.einsum("bnqk,bnkd->bnqd", logits.softmax(-1), v)
        out = out.transpose(1, 2).reshape(b, h * w, c).transpose(1, 2)
        return x + self.proj(out.reshape(b, c, h, w))


def _pool(x: Tensor) -> Tensor:
    """2x2 max pool, stride 2, VALID (a trailing odd row/column dropped;
    empty in, empty out)."""
    b, c, h, w = x.shape
    x = x[:, :, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))


def _up_to(x: Tensor, target_hw: tuple[int, int]) -> Tensor:
    """Bilinear 2x upsample (half-pixel centres, edges clamped, as
    `jax.image.resize`), zero-padded to the skip's spatial shape."""
    b, c, h, w = x.shape
    if x.numel():
        x = F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear",
                          align_corners=False)
    else:
        x = x.new_zeros(b, c, 2 * h, 2 * w)
    th, tw = target_hw
    dh, dw = th - x.shape[2], tw - x.shape[3]
    if dh > 0 or dw > 0:
        x = F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
    return x[:, :, :th, :tw]


class RayDropUNet(nn.Module):
    """in: (B, in_ch, H, W); out: (B, 1, H, W) refined drop probability."""

    def __init__(self, in_ch: int = 3, channels: int = 32):
        super().__init__()
        ch = channels
        self.stem = nn.Conv2d(in_ch, ch, 1)
        self.down1 = DoubleConv(ch, ch * 2)
        self.down2 = DoubleConv(ch * 2, ch * 4)
        self.down3 = DoubleConv(ch * 4, ch * 8)
        self.down4 = DoubleConv(ch * 8, ch * 8)
        self.attn = AttnBlock(ch * 8)
        self.up1 = DoubleConv(ch * 16, ch * 4, mid_ch=ch * 16)
        self.up2 = DoubleConv(ch * 8, ch * 2, mid_ch=ch * 8)
        self.up3 = DoubleConv(ch * 4, ch, mid_ch=ch * 4)
        self.up4 = DoubleConv(ch * 2, ch, mid_ch=ch * 2)
        self.norm = BatchNorm(ch)
        self.head = nn.Conv2d(ch, 1, 1)

    def forward(self, x: Tensor,
                generator: torch.Generator | None = None) -> Tensor:
        g = generator
        x0 = self.stem(x)
        x1 = self.down1(_pool(x0), g)
        x2 = self.down2(_pool(x1), g)
        x3 = self.down3(_pool(x2), g)
        x4 = self.attn(self.down4(_pool(x3), g), g)
        y = x4
        for up, skip in ((self.up1, x3), (self.up2, x2), (self.up3, x1),
                         (self.up4, x0)):
            y = up(torch.cat([skip, _up_to(y, skip.shape[2:])], dim=1), g)
        return torch.sigmoid(self.head(F.relu(self.norm(y))))


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers, drawn from `generator`: lecun_normal conv
    kernels (a normal truncated at 2 std, std sqrt(1/fan_in) after
    truncation), zero biases, BatchNorm scale 1 and bias 0."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.reset_parameters()


def make_unet(in_ch: int, device: str | torch.device,
              generator: torch.Generator | None = None) -> RayDropUNet:
    """A RayDropUNet on `device` built without touching torch's global
    random state: initialised from `generator` (`init_weights`), or, with
    none, left for `load_state_dict` to fill."""
    with torch.device("meta"):
        model = RayDropUNet(in_ch)
    if torch.device(device).type == "meta":
        return model
    model = model.to_empty(device=device)
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.reset_parameters()
    if generator is not None:
        init_weights(model, generator)
    return model


def unet_input(raydrop: Tensor, intensity: Tensor, depth: Tensor,
               ray_o: Tensor | None = None, ray_d: Tensor | None = None
               ) -> Tensor:
    """Stack the refinement input channels (train.py:398-417): (1, 3, H, W),
    or (1, 9, H, W) with the rays' origins and directions (H, W, 3)."""
    chans = [raydrop[None], intensity[None], depth[None]]
    if ray_o is not None:
        chans.extend([ray_o.permute(2, 0, 1), ray_d.permute(2, 0, 1)])
    return torch.cat(chans, dim=0)[None]


# flax module path of each of the port's modules (nn.compact numbering).
_FLAX_NAMES = {
    "stem": "Conv_0", "head": "Conv_1", "norm": "BatchNorm_0",
    "attn": "AttnBlock_0", "attn.norm": "AttnBlock_0/BatchNorm_0",
    "attn.qkv": "AttnBlock_0/Conv_0", "attn.proj": "AttnBlock_0/Conv_1",
    **{f"{part}{i + 1}": f"DoubleConv_{i + off}"
       for part, off in (("down", 0), ("up", 4)) for i in range(4)},
}
_DOUBLE = {"bn1": "BatchNorm_0", "conv1": "Conv_0", "bn2": "BatchNorm_1",
           "conv2": "Conv_1"}


def _flax_path(module: str) -> str:
    if module in _FLAX_NAMES:
        return _FLAX_NAMES[module]
    parent, child = module.rsplit(".", 1)
    return f"{_FLAX_NAMES[parent]}/{_DOUBLE[child]}"


def unet_state_from_flax(variables) -> dict[str, np.ndarray]:
    """flax variables {"params": ..., "batch_stats": ...} (nested dicts of
    numpy arrays; HWIO kernels, BatchNorm scale/bias and mean/var) -> the
    port's `RayDropUNet` state_dict as numpy arrays (OIHW kernels)."""

    def leaf(tree, path):
        for part in path.split("/"):
            tree = tree[part]
        return np.asarray(tree)

    params, stats = variables["params"], variables["batch_stats"]
    bn_fields = {"weight": (params, "scale"), "bias": (params, "bias"),
                 "running_mean": (stats, "mean"),
                 "running_var": (stats, "var")}
    out = {}
    for name in make_unet(3, "meta").state_dict():
        module, field = name.rsplit(".", 1)
        path = _flax_path(module)
        if module in ("stem", "head", "attn.qkv", "attn.proj") \
                or module.endswith((".conv1", ".conv2")):
            out[name] = (np.ascontiguousarray(
                leaf(params, f"{path}/kernel").transpose(3, 2, 0, 1))
                if field == "weight" else leaf(params, f"{path}/bias"))
        elif field == "num_batches_tracked":
            out[name] = np.asarray(0, np.int64)
        else:
            tree, key = bn_fields[field]
            out[name] = leaf(tree, f"{path}/{key}")
    return out
