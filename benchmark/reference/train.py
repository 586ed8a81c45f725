"""The plain reference of one training step: compose the scene at a frame,
render it through its tail chain (`render.py`), the five-term loss, the
gradient to every raw leaf, and per-group Adam, in plain torch float32
with TF32 off.

It imports nothing of the program.  It restates the semantics of the
port's `train/loop.py` step (`scene/scene.py` composition, `train/losses.py`
terms with `ops/ssim.py` and `ops/chamfer.py`, `train/optim.py` Adam and
its position schedule) from the configuration's options:

  * compose: background slots, then each vehicle's slots moved by its box
    (R_box xyz + t_box, q_box * normalize(q)); dead slots get opacity 0;
  * loss: 0.1 masked L1 of depth, 0.85 masked L1 + 0.15 (1 - SSIM) of
    intensity (SSIM on the masked images, 11 x 11 Gaussian window, sigma
    1.5), 0.01 BCE of the ray-drop probability (softmax of the hit and
    drop logits) against the missing returns, 0.01 Chamfer of every
    cd_stride-th ray's returned points both ways, 0.01 box and scale
    regularisation;
  * Adam (beta 0.9, 0.999, eps 1e-15) per asset and group, the position
    rate log-linear from position_lr_init to position_lr_final over
    position_lr_max_steps, times the asset's extent.

The gradient is taken in three stages so that the render fits: the image
without autograd, the loss's gradient to the image, then the render again
in blocks of tiles carrying that gradient to the surfels.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference import render as ref

Tensor = torch.Tensor

GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
BETA1, BETA2, EPS = 0.9, 0.999, 1e-15
BIG = 1e12


class Asset(NamedTuple):
    leaves: dict          # group -> raw tensor (requires grad)
    alive: Tensor
    extent: float


class Tracks(NamedTuple):
    """The vehicles' boxes: translations (M, F, 3), quats (M, F, 4) wxyz,
    size (M, 3)."""

    translations: Tensor
    quats: Tensor
    size: Tensor


class State:
    """The reference's trainable state: background and stacked vehicles,
    their Adam moments and bias-correction counts by (asset, group), and
    the schedule's step count."""

    def __init__(self, bg: Asset, actors: Asset | None, tracks, opt,
                 step0: int):
        self.bg, self.actors, self.tracks, self.opt = bg, actors, tracks, opt
        self.steps = step0
        self.t = {}
        self.m = {}
        self.v = {}

    def assets(self):
        return [("bg", self.bg)] + ([("actors", self.actors)]
                                    if self.actors is not None else [])


def quat_norm(q: Tensor) -> Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1,
                                        keepdim=True).clamp_min(1e-12)


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def activated(a: Asset):
    lv = a.leaves
    return (torch.exp(lv["scaling"].clamp(-13.8, 13.8)),
            torch.where(a.alive, torch.sigmoid(lv["opacity"]), 0.0),
            torch.cat([lv["f_dc"], lv["f_rest"]], -2))


def compose(s: State, frame: int) -> list[Tensor]:
    """(means, quats, scales, opacities, sh) of the scene at `frame`."""
    scales, opac, sh = activated(s.bg)
    out = [[s.bg.leaves["xyz"]], [quat_norm(s.bg.leaves["rotation"])],
           [scales], [opac], [sh]]
    if s.actors is not None:
        lv = s.actors.leaves
        t_box, q_box = s.tracks.translations[:, frame], \
            s.tracks.quats[:, frame]
        r_box = ref.quat_matrix(q_box)                       # (M, 3, 3)
        m, a = lv["xyz"].shape[:2]
        xyz = (r_box[:, None] * lv["xyz"][:, :, None, :]).sum(-1) \
            + t_box[:, None]
        q = quat_mul(q_box[:, None].expand(m, a, 4), quat_norm(lv["rotation"]))
        sc, op, shs = activated(s.actors)
        for lst, x in zip(out, (xyz, q, sc, op, shs)):
            lst.append(x.reshape(m * a, *x.shape[2:]))
    return [torch.cat(x) for x in out]


def _window(device) -> Tensor:
    x = torch.arange(11, dtype=torch.float64)
    g = torch.exp(-((x - 5) ** 2) / (2.0 * 1.5 ** 2))
    return (g / g.sum()).float().to(device)


def _blur(img: Tensor, win: Tensor) -> Tensor:
    x = img[None, None]
    x = torch.nn.functional.conv2d(x, win.view(1, 1, 11, 1), padding=(5, 0))
    x = torch.nn.functional.conv2d(x, win.view(1, 1, 1, 11), padding=(0, 5))
    return x[0, 0]


def ssim(a: Tensor, b: Tensor) -> Tensor:
    win = _window(a.device)
    mu1, mu2 = _blur(a, win), _blur(b, win)
    s1 = (_blur(a * a, win) - mu1 * mu1).clamp_min(0.0)
    s2 = (_blur(b * b, win) - mu2 * mu2).clamp_min(0.0)
    bound = torch.sqrt(s1 * s2 + 1e-24)
    s12 = torch.clamp(_blur(a * b, win) - mu1 * mu2, -bound, bound)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()


def nearest(a: Tensor, am: Tensor, b: Tensor, bm: Tensor, chunk: int = 512
            ) -> Tensor:
    """Each valid point of a's squared distance to its nearest valid point
    of b (0 for invalid rows), differentiable through the pair at the
    minimum."""
    with torch.no_grad():
        best = torch.full((a.shape[0],), BIG, device=a.device)
        arg = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
        for s in range(0, b.shape[0], chunk):
            d = ((a.detach()[:, None, :] - b.detach()[None, s:s + chunk, :])
                 ** 2).sum(-1)
            d = torch.where(bm[None, s:s + chunk], d, BIG)
            v, i = d.min(1)
            better = v < best
            best = torch.where(better, v, best)
            arg = torch.where(better, i + s, arg)
    keep = am & (best < BIG)
    d2 = ((a - b[arg]) ** 2).sum(-1)
    return torch.where(keep, d2, torch.zeros_like(d2))


def chamfer(a: Tensor, am: Tensor, b: Tensor, bm: Tensor) -> Tensor:
    na = am.sum().clamp_min(1)
    nb = bm.sum().clamp_min(1)
    return 0.5 * (nearest(a, am, b, bm).sum() / na
                  + nearest(b, bm, a, am).sum() / nb)


def masked_mean(x: Tensor, m: Tensor) -> Tensor:
    mf = m.to(x.dtype)
    return (x * mf).sum() / mf.sum().clamp_min(1.0)


def image_terms(ch: Tensor, gt_depth: Tensor, gt_int: Tensor, mask: Tensor,
                origin: Tensor, dirs: Tensor, opt, cd_stride: int) -> dict:
    """The four terms that read the image (H, W, 9)."""
    depth, inten = ch[..., 3], ch[..., 0]
    drop = torch.softmax(ch[..., 1:3], -1)[..., 1]
    mf = mask.to(inten.dtype)
    t = {"depth": opt["lambda_depth_l1"] * masked_mean(
        (depth - gt_depth).abs(), mask)}
    t["intensity"] = (
        opt["lambda_intensity_l1"] * masked_mean((inten - gt_int).abs(), mask)
        + opt["lambda_intensity_l2"] * masked_mean((inten - gt_int) ** 2,
                                                    mask)
        + opt["lambda_intensity_dssim"] * (1.0 - ssim(inten * mf,
                                                      gt_int * mf)))
    p = drop.clamp(1e-7, 1.0 - 1e-7)
    lab = (~mask).to(p.dtype)
    t["raydrop"] = opt["lambda_raydrop_bce"] * (
        -(lab * torch.log(p) + (1.0 - lab) * torch.log(1.0 - p))).mean()
    d = dirs.reshape(-1, 3)[::cd_stride]
    m = mask.reshape(-1)[::cd_stride]
    pred = origin + d * depth.reshape(-1)[::cd_stride, None]
    gt = origin + d * gt_depth.reshape(-1)[::cd_stride, None]
    t["cd"] = opt["lambda_cd"] * chamfer(pred, m, gt, m)
    return t


def reg_term(s: State) -> Tensor:
    """Scale (and, for vehicles, box) regularisation of every asset."""
    def scale_loss(a: Asset, lv) -> Tensor:
        sc = torch.exp(lv["scaling"].clamp(-13.8, 13.8))
        m = a.alive.to(sc.dtype)
        return masked_mean(sc.amax(-1) * m, a.alive) / a.extent

    total = scale_loss(s.bg, s.bg.leaves)
    if s.actors is not None:
        size = s.tracks.size
        for i in range(size.shape[0]):
            lv = {k: v[i] for k, v in s.actors.leaves.items()}
            a = Asset(lv, s.actors.alive[i], s.actors.extent)
            m = a.alive.to(torch.float32)
            over = (lv["xyz"] - size[i] / 2.0).clamp_min(0.0)
            under = (-size[i] / 2.0 - lv["xyz"]).clamp_min(0.0)
            a3 = a.alive[:, None].expand(over.shape)
            box = (masked_mean(over * m[:, None], a3)
                   + masked_mean(under * m[:, None], a3)) / a.extent
            total = total + box * 100.0 + scale_loss(a, lv)
    return s.opt["lambda_reg"] * total


class StepOut(NamedTuple):
    terms: dict            # depth, intensity, raydrop, cd, reg, loss
    channels: Tensor       # (H, W, 9)
    grads: dict            # (asset, group) -> gradient


def step(s: State, frame: int, raster: ref.Raster, s2w: Tensor,
         tiling: ref.Tiling, degree: int, gt: tuple, cd_stride: int,
         dtype=torch.float32) -> StepOut:
    """One training step at `frame`: the loss, the gradient and Adam."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _step(s, frame, raster, s2w, tiling, degree, gt, cd_stride,
                     dtype)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _step(s, frame, raster, s2w, tiling, degree, gt, cd_stride, dtype):
    bg = torch.tensor([0.0, 0.0, 1.0], device=s2w.device)
    for _, a in s.assets():
        for x in a.leaves.values():
            x.grad = None
    bundle = compose(s, frame)
    image = ref.render([x.detach() for x in bundle], raster, s2w, tiling,
                       degree, bg, dtype=dtype).channels
    ch = image.clone().requires_grad_()
    origin, dirs = ref.rays(raster, s2w)
    terms = image_terms(ch, *gt, origin, dirs, s.opt, cd_stride)
    sum(terms.values()).backward()
    up = ch.grad.reshape(-1, 9)
    r = ref.render([x.detach() for x in bundle], raster, s2w, tiling,
                   degree, bg, loss=lambda c, pid: (c * up[pid]).sum(),
                   dtype=dtype)
    reg = reg_term(s)
    torch.autograd.backward(bundle + [reg],
                            r.grads + [torch.ones_like(reg)])
    terms["reg"] = reg
    terms = {k: float(v.detach()) for k, v in terms.items()}
    terms["loss"] = sum(terms.values())
    grads = {}
    with torch.no_grad():
        for name, a in s.assets():
            for g in GROUPS:
                p = a.leaves[g]
                grad = (torch.zeros_like(p) if p.grad is None
                        else p.grad.clone())
                grads[(name, g)] = grad
                key = (name, g)
                m = s.m.setdefault(key, torch.zeros_like(p))
                v = s.v.setdefault(key, torch.zeros_like(p))
                m.mul_(BETA1).add_(grad, alpha=1.0 - BETA1)
                v.mul_(BETA2).addcmul_(grad, grad, value=1.0 - BETA2)
                t = s.t[key] = s.t.get(key, 0) + 1
                mh = m / (1.0 - BETA1 ** t)
                vh = v / (1.0 - BETA2 ** t)
                p.sub_(lr(s.opt, g, a.extent, s.steps) * mh
                       / (torch.sqrt(vh) + EPS))
    s.steps += 1
    return StepOut(terms, image, grads)


def lr(opt: dict, group: str, extent: float, steps: int) -> float:
    if group == "xyz":
        t = min(max(steps / opt["position_lr_max_steps"], 0.0), 1.0)
        return math.exp(math.log(opt["position_lr_init"] * extent) * (1 - t)
                        + math.log(opt["position_lr_final"] * extent) * t)
    return {"f_dc": opt["feature_lr"], "f_rest": opt["feature_lr"] / 20.0,
            "opacity": opt["opacity_lr"], "scaling": opt["scaling_lr"],
            "rotation": opt["rotation_lr"]}[group]
