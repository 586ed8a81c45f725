"""Analytic ray <-> 2D-Gaussian-surfel intersection (counterpart of
`lidar_rt_tpu.ops.geometry`).

A ray  x = o + t*d  meets a surfel plane at  t = n . (mu - o) / (n . d);
splat-frame coordinates  u = w1 . (x - mu) / s1,  v = w2 . (x - mu) / s2;
G = exp(-(u^2+v^2)/2) and alpha = min(0.99, opacity*G).  The five gate
constants below are shared with the CUDA kernels (`csrc/tracer_common.cuh`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

ALPHA_MAX = 0.99          # alpha clamp
ALPHA_MIN = 1.0 / 255.0   # contribution threshold
T_MIN = 1e-4              # transmittance early-out
DEPTH_MIN = 0.2           # minimum hit range in meters
DENOM_EPS = 1e-12         # |n.d| guard for grazing rays


class SurfelFrames(NamedTuple):
    """Per-surfel frame for a shared ray origin o.

      w1, w2, n:  (N, 3) splat axes / plane normal (columns of R(q))
      p:          (N,)   n . (mu - o)
      a_u, a_v:   (N,)   w_i . (o - mu)
      sign:       (N,)   dual-visible normal orientation (+-1)
    """

    w1: Tensor
    w2: Tensor
    n: Tensor
    p: Tensor
    a_u: Tensor
    a_v: Tensor
    sign: Tensor


def build_frames(means: Tensor, rotations: Tensor, origin: Tensor
                 ) -> SurfelFrames:
    """means (N, 3); rotations (N, 3, 3) (columns are splat axes); origin
    (3,).  sign = +1 if n.(mu-o) < 0 (normal flipped toward the sensor)."""
    w1 = rotations[..., :, 0]
    w2 = rotations[..., :, 1]
    n = rotations[..., :, 2]
    o_minus_mu = origin - means
    p = -(n * o_minus_mu).sum(-1)
    a_u = (w1 * o_minus_mu).sum(-1)
    a_v = (w2 * o_minus_mu).sum(-1)
    sign = torch.where(p < 0.0, 1.0, -1.0)
    return SurfelFrames(w1, w2, n, p, a_u, a_v, sign)


class Hits(NamedTuple):
    """Per-(ray, surfel) intersection quantities, all (R, N)."""

    t: Tensor
    u: Tensor
    v: Tensor
    g: Tensor
    alpha: Tensor
    valid: Tensor


def ray_dot(dirs: Tensor, axis: Tensor) -> Tensor:
    """(..., R, 3) x (..., N, 3) -> (..., R, N), as elementwise products:
    qd is a near-cancelling dot at grazing incidence and t = p / qd
    amplifies any rounding, so it never goes through a (TF32) matmul."""
    return (dirs[..., :, None, 0] * axis[..., None, :, 0]
            + dirs[..., :, None, 1] * axis[..., None, :, 1]
            + dirs[..., :, None, 2] * axis[..., None, :, 2])


def intersect(frames: SurfelFrames, scales: Tensor, opacities: Tensor,
              dirs: Tensor) -> Hits:
    """Intersect rays (R, 3) against all surfels -> (R, N) hit fields.

    Hits closer than DEPTH_MIN, grazing (|n.d| <= DENOM_EPS), on degenerate
    planes (p == 0) or with alpha < ALPHA_MIN are invalid (alpha 0)."""
    qd = ray_dot(dirs, frames.n)
    b_u = ray_dot(dirs, frames.w1)
    b_v = ray_dot(dirs, frames.w2)
    safe_qd = torch.where(qd.abs() > DENOM_EPS, qd, DENOM_EPS)
    t = frames.p[None, :] / safe_qd
    u = (frames.a_u[None, :] + t * b_u) / scales[None, :, 0]
    v = (frames.a_v[None, :] + t * b_v) / scales[None, :, 1]
    g = torch.exp(-0.5 * (u * u + v * v))
    alpha_raw = (opacities[None, :] * g).clamp_max(ALPHA_MAX)
    valid = ((t >= DEPTH_MIN)
             & (qd.abs() > DENOM_EPS)
             & (frames.p[None, :] != 0.0)
             & (alpha_raw >= ALPHA_MIN))
    alpha = torch.where(valid, alpha_raw, 0.0)
    return Hits(t=t, u=u, v=v, g=g, alpha=alpha, valid=valid)


def composite_weights(alpha: Tensor, init_trans: Tensor | None = None
                      ) -> tuple[Tensor, Tensor]:
    """Front-to-back weights from alphas ordered along the last axis.

        T_j   = T_0 * prod_{k<j} (1 - alpha_k)
        live  = all_{k<=j} [ T_k (1 - alpha_k) >= T_MIN ]
        w_j   = live_j * alpha_j * T_j
        T_out = T_0 * prod over live hits of (1 - alpha)

    The live mask drops the hit that would push transmittance below T_MIN
    and everything behind it.  Returns (w, T_out).
    """
    one_minus = 1.0 - alpha
    t0 = (torch.ones_like(alpha[..., :1]) if init_trans is None
          else init_trans[..., None])
    t_incl = t0 * torch.cumprod(one_minus, dim=-1)
    t_excl = torch.cat([t0, t_incl[..., :-1]], dim=-1)
    live = torch.cumprod((t_incl >= T_MIN).to(alpha.dtype), dim=-1)
    w = live * alpha * t_excl
    final_t = t0[..., 0] * torch.prod(1.0 - live * alpha, dim=-1)
    return w, final_t
