"""Ablation probe of the forward tracer kernel's body on the card
(counterpart of the reference's `scripts/kernel_microbench.py`).

    python -m lidar_rt_tpu_torch.scripts.kernel_microbench [LEVEL ...] \
        [--seed 0] [--k 128] [--save PATH] [--against PATH]

Synthetic candidates in the forward kernel's layout, made from the seed as
the reference makes them, at its shape (T=42 tiles of R=4096 rays, K=128
candidates): per ray its direction and 16 SH basis values, per candidate
its axes, plane, inverse scales, opacity and SH coefficients.  Each
ablation level (LEVELS; by default the reference's own list) stacks one
more stage of the body and writes a (T, 16, R) float32 block; the kernel,
`csrc/kernel_microbench.cu`, runs one thread per ray.  For each level it
prints ms per launch (CUDA events over ITERS launches after one), G pairs
per second, and the level's bound: its operations per pair (OPS_PER_PAIR)
over the card's float32 rate, or its bytes over its memory rate, whichever
is larger.  `--k` sets the candidates a tile.  `--save` keeps each
level's ms and output; `--against` holds this run's to such a file from
another run (another tree's probe, say): both ms, and whether the
outputs are the same bits, else how many elements differ and by how
much.  Measures on a CUDA card only.

`ablation(level, inputs)` launches the kernel on CUDA tensors and runs
the plain PyTorch version, `ablation_reference`, on CPU tensors; nothing
falls back from one to the other.
"""

from __future__ import annotations

import argparse
from typing import NamedTuple

import numpy as np
import torch

from lidar_rt_tpu_torch.ops import kernels

T, R, K = 42, 4096, 128
ITERS = 20
SLEEP_CYCLES = 40_000_000     # ~20 ms of the card's clock before timing
LEVELS = ("minimal", "chain", "chain_bf16", "broadcasts", "intersect",
          "scan", "full", "nodiv", "noexp", "rowloop")
DEFAULT_LEVELS = ("intersect", "scan", "full", "nodiv", "noexp", "rowloop")
# Operations per (ray, candidate) pair, counted from the reference's body:
# each add, multiply, min/max, compare, select, and/or, convert and exp
# counts one.  minimal: the 3-dot (5) and the sum (1); chain: + 8 x 5;
# broadcasts: + 12; intersect (rowloop the same): the two other 3-dots
# (10), safe_qd (3), the divide, u and v (6), their squares (3), the
# exp's argument and the exp (2), alpha (2), the four gates and their
# ands (7), the select and the sum; scan: + 1 - alpha, the product,
# t_incl, live (2) and w (2); full: scan's but its sum, + 3 SH dots of
# 16 (93), + 0.5 (3), the clamp, 7 products and 8 sums of the channel
# rows; nodiv a multiply for the divide; noexp the polynomial (4) for the
# exp (2).
OPS_PER_PAIR = {"minimal": 6, "chain": 46, "chain_bf16": 48,
                "broadcasts": 18, "intersect": 41, "rowloop": 41,
                "scan": 48, "full": 159, "nodiv": 159, "noexp": 161}
# Of chain_bf16's, the chain's 40 run on packed bfloat16 pairs, and the
# conversions (2) on their own.
BF16_OPS_PER_PAIR = {"chain_bf16": 40}
# The inputs each level reads (its bytes are these, each read once, and
# the (T, 16, R) float32 output).
LEVEL_INPUTS = {
    **dict.fromkeys(("minimal", "chain", "chain_bf16"), ("dirs", "axes")),
    "broadcasts": ("dirs", "axes", "plane", "scale"),
    **dict.fromkeys(("intersect", "scan", "rowloop"),
                    ("dirs", "axes", "plane", "scale", "opac")),
    **dict.fromkeys(("full", "nodiv", "noexp"),
                    ("dirs", "basis", "axes", "plane", "scale", "opac",
                     "sh"))}
# The card's published peaks (NVIDIA H100 SXM, 700 W): float32 outside the
# tensor cores, and twice that for packed bfloat16 pairs (an instruction
# gives two results); device memory bandwidth.
PEAK_F32, PEAK_BF16X2, PEAK_BYTES = 67e12, 134e12, 3.35e12

# The kernel against its plain version: within 2e-4 (the tracer kernels'
# bar, on channels of order 1) times the level's largest magnitude where
# that exceeds 1, as the gradient bars scale by the field's largest
# magnitude: the levels sum K float32 terms of magnitude up to ~100 in
# another order, with multiply-adds the compiler fuses (`full` read 2.5e-3
# at a largest magnitude of 158, 1.6e-5 of it, on the card).
ATOL = 2e-4

# Launches of the kernel per level: raised by one per launch in
# `ablation`, nowhere else.
launches = dict.fromkeys(LEVELS, 0)


def reset_launches() -> None:
    for level in LEVELS:
        launches[level] = 0


class Inputs(NamedTuple):
    """The probe's synthetic candidates, float32: dirs (T, R, 3), basis
    (T, R, 16), axes (T, 3, 3, K), plane (T, 3, K), scale (T, 2, K; the
    inverse scales), opac (T, 1, K), sh (T, 3, 16, K)."""

    dirs: torch.Tensor
    basis: torch.Tensor
    axes: torch.Tensor
    plane: torch.Tensor
    scale: torch.Tensor
    opac: torch.Tensor
    sh: torch.Tensor


def make_inputs(seed: int = 0, t: int = T, r: int = R, k: int = K,
                device="cuda") -> Inputs:
    """The reference's run() inputs, drawn from `seed` with numpy in its
    order."""
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(t, r, 3)), rng.normal(size=(t, r, 16)),
              rng.normal(size=(t, 3, 3, k)), rng.normal(size=(t, 3, k)) + 10,
              rng.uniform(1, 5, (t, 2, k)), rng.uniform(0.3, 0.9, (t, 1, k)),
              rng.normal(size=(t, 3, 16, k)))
    return Inputs(*(torch.tensor(np.asarray(a, np.float32), device=device)
                    for a in arrays))


def _check(inputs: Inputs) -> tuple[int, int, int]:
    """(T, R, K) of inputs the kernel takes; raises on any other."""
    t, r = inputs.dirs.shape[:2]
    k = inputs.axes.shape[-1]
    shapes = {"dirs": (t, r, 3), "basis": (t, r, 16), "axes": (t, 3, 3, k),
              "plane": (t, 3, k), "scale": (t, 2, k), "opac": (t, 1, k),
              "sh": (t, 3, 16, k)}
    dev = inputs.dirs.device
    for name, shape in shapes.items():
        x = getattr(inputs, name)
        if (tuple(x.shape) != shape or x.dtype != torch.float32
                or x.device != dev or not x.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous float32 {shape} "
                             f"on {dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    if k % 2 or not 2 <= k <= 896 or t > 65535:
        raise ValueError(f"the probe takes an even K in [2, 896] and at most "
                         f"65535 tiles, got K={k}, T={t}")
    return t, r, k


def ablation(level: str, inputs: Inputs) -> torch.Tensor:
    """Level `level` of the probe: (T, 16, R) float32.  Launches the CUDA
    kernel on CUDA tensors (raising on a failed launch) and runs
    `ablation_reference` on CPU tensors."""
    if level not in LEVELS:
        raise ValueError(f"unknown level {level!r}: one of {LEVELS}")
    t, r, k = _check(inputs)
    dev = inputs.dirs.device
    if dev.type == "cpu":
        return ablation_reference(level, inputs)
    out = torch.empty((t, 16, r), dtype=torch.float32, device=dev)
    kernels.launch("kernel_microbench", dev,
                   [x.data_ptr() for x in inputs] + [out.data_ptr()],
                   (t, r, k, LEVELS.index(level)))
    launches[level] += 1
    return out


def ablation_reference(level: str, inputs: Inputs) -> torch.Tensor:
    """The plain PyTorch version of each level: the reference kernel's
    arithmetic on (T, R, K) arrays, its sums over K."""
    dirs, basis, axes, plane, scale, opac, sh = inputs
    t, r = dirs.shape[:2]
    d0, d1, d2 = (dirs[..., i, None] for i in range(3))     # (T, R, 1)

    def row(x):                                     # (T, K) -> (T, 1, K)
        return x[:, None, :]

    n0, n1, n2 = (row(axes[:, 0, i]) for i in range(3))
    w10, w11, w12 = (row(axes[:, 1, i]) for i in range(3))
    w20, w21, w22 = (row(axes[:, 2, i]) for i in range(3))
    p, a_u, a_v = (row(plane[:, i]) for i in range(3))
    inv_s0, inv_s1 = row(scale[:, 0]), row(scale[:, 1])
    op = row(opac[:, 0])

    def rows(x):                     # (T, R, K) summed -> all 16 rows
        return x.sum(-1)[:, None, :].expand(t, 16, r).contiguous()

    qd = d0 * n0 + d1 * n1 + d2 * n2
    if level == "minimal":
        return rows(qd)
    if level == "chain":
        x = qd
        for _ in range(8):
            x = x * 1.0001 + 0.1
            x = torch.maximum(x * 0.9999, x - 0.1)
        return rows(x)
    if level == "chain_bf16":
        mul, add, shrink = (torch.tensor(v, dtype=torch.bfloat16,
                                         device=dirs.device)
                            for v in (1.0001, 0.1, 0.9999))
        x = qd.to(torch.bfloat16)
        for _ in range(8):
            x = x * mul + add
            x = torch.maximum(x * shrink, x - add)
        return rows(x.float())
    if level == "broadcasts":
        x = qd
        x = x + d0 * p + d1 * a_u + d2 * a_v
        x = x + d0 * inv_s0 + d1 * inv_s1 + d2 * n0
        return rows(x)
    b_u = d0 * w10 + d1 * w11 + d2 * w12
    b_v = d0 * w20 + d1 * w21 + d2 * w22
    qd_ok = qd.abs() > 1e-8
    safe_qd = torch.where(qd_ok, qd, 1e-8)
    tt = p * safe_qd if level == "nodiv" else p / safe_qd
    u = (a_u + tt * b_u) * inv_s0
    v = (a_v + tt * b_v) * inv_s1
    dd = u * u + v * v
    if level == "noexp":
        g = torch.clamp_min(1.0 - 0.25 * dd, 0.0) ** 2
    else:
        g = torch.exp(-0.5 * dd)
    alpha_raw = torch.clamp_max(op * g, 0.99)
    ok = (tt >= 0.2) & qd_ok & (p != 0.0) & (alpha_raw >= 0.004)
    alpha = torch.where(ok, alpha_raw, 0.0)
    if level in ("intersect", "rowloop"):
        return rows(alpha)
    one_m = 1.0 - alpha
    t_excl = torch.cat([torch.ones_like(one_m[..., :1]),
                        torch.cumprod(one_m, -1)[..., :-1]], -1)
    t_incl = t_excl * one_m
    w = alpha * t_excl * (t_incl >= 1e-4).float()
    if level == "scan":
        return rows(w)
    cols = torch.einsum("trj,tcjk->tcrk", basis, sh) + 0.5   # (T, 3, R, K)
    chans = [cols[:, 0].clamp_min(0.0), cols[:, 1], cols[:, 2], tt,
             torch.ones_like(tt), n0.expand_as(tt), n1.expand_as(tt),
             n2.expand_as(tt)]
    contrib = torch.stack([(w * c).sum(-1) for c in chans], 1)   # (T, 8, R)
    return torch.cat([contrib, torch.zeros_like(contrib)], 1)


def error(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error of `got` against the plain version's `want`, its
    ratio to the bar ATOL x max(1, max|want|)): within the bar at a ratio
    <= 1."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / (ATOL * max(1.0, want.float().abs().max().item()))


def work(level: str, inputs: Inputs) -> dict[str, float]:
    """The level's work on `inputs`: float32 and packed-bfloat16
    operations, and bytes (each input it reads once, its output once)."""
    t, r = inputs.dirs.shape[:2]
    pairs = t * r * inputs.axes.shape[-1]
    bf16 = BF16_OPS_PER_PAIR.get(level, 0)
    nbytes = sum(getattr(inputs, name).numel() * 4
                 for name in LEVEL_INPUTS[level]) + t * 16 * r * 4
    return {"pairs": pairs, "ops": pairs * (OPS_PER_PAIR[level] - bf16),
            "bf16_ops": pairs * bf16, "bytes": nbytes}


def bound(level: str, inputs: Inputs) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time the card could take
    for the level's work, the larger of its operations over their peak
    rates and its bytes over the memory rate."""
    w = work(level, inputs)
    ops_ms = 1e3 * (w["ops"] / PEAK_F32 + w["bf16_ops"] / PEAK_BF16X2)
    bytes_ms = 1e3 * w["bytes"] / PEAK_BYTES
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def event_ms(fn, iters: int) -> float:
    """Mean device ms per call over `iters` calls after one warm-up call
    (CUDA events).  The device first sleeps while the host queues every
    call, so that the host's cost per launch (tens of microseconds, as
    long as a probe kernel) opens no gaps between them."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def hold(record: dict[str, dict], outs: dict[str, torch.Tensor],
         save=None, against=None) -> None:
    """Save each level's or mode's ms (from `record`) and output to
    `save`; hold them to another run's file at `against`: print both ms
    and whether the outputs are the same bits, else how many elements
    differ and by how much, and add those to `record`."""
    if save:
        torch.save({name: {"ms": record[name]["ms"], "out": out.cpu()}
                    for name, out in outs.items()}, save)
    if not against:
        return
    other = torch.load(against)
    for name, out in outs.items():
        if name not in other:
            continue
        mine, theirs = out.cpu(), other[name]["out"]
        ints = torch.int16 if mine.element_size() == 2 else torch.int32
        differ = int((mine.view(ints) != theirs.view(ints)).sum())
        diff = (mine.float() - theirs.float()).abs().max().item()
        record[name].update(against_ms=other[name]["ms"], differ=differ,
                            max_abs_diff=diff)
        print(f"[against] {name:10s}: {record[name]['ms']:.4f} ms here, "
              f"{other[name]['ms']:.4f} there; " + (
                  "same bits" if not differ else
                  f"{differ} elements differ, by up to {diff:.3e}"),
              flush=True)


def run(levels=DEFAULT_LEVELS, seed: int = 0, k: int = K, device="cuda",
        save=None, against=None) -> dict[str, dict]:
    """Time each level's kernel on the card (ITERS + 1 launches each) and
    print ms, G pairs/s and the bound, with K=`k` candidates a tile; save
    and hold the outputs as `hold` does; returns {level: {"ms",
    "bound_ms", "bound_by", "gpairs_s"}}."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise SystemExit("the probe measures a CUDA card: no device time "
                         "on the CPU")
    inputs = make_inputs(seed, k=k, device=dev)
    out, outs = {}, {}
    for level in levels:
        ms = event_ms(lambda: outs.__setitem__(level,
                                               ablation(level, inputs)),
                      ITERS)
        b_ms, b_by = bound(level, inputs)
        pairs = work(level, inputs)["pairs"]
        out[level] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                      "gpairs_s": pairs / ms / 1e6}
        print(f"{level:10s}: {ms:7.4f} ms  {pairs / ms / 1e6:7.2f} G pairs/s"
              f"  bound {b_ms:.4f} ms ({b_by}, {OPS_PER_PAIR[level]} "
              f"operations a pair)", flush=True)
    hold(out, outs, save, against)
    return out


def main(argv=None) -> dict[str, dict]:
    p = argparse.ArgumentParser(
        prog="python -m lidar_rt_tpu_torch.scripts.kernel_microbench")
    p.add_argument("levels", nargs="*", metavar="LEVEL",
                   help=f"any of {', '.join(LEVELS)} (default: "
                        f"{' '.join(DEFAULT_LEVELS)})")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--k", type=int, default=K,
                   help="candidates a tile (even, 2 to 896)")
    p.add_argument("--save", help="keep each level's ms and output here")
    p.add_argument("--against", help="hold them to another run's --save")
    a = p.parse_args(argv)
    unknown = sorted(set(a.levels) - set(LEVELS))
    if unknown:
        p.error(f"unknown levels {unknown}: choose from {LEVELS}")
    return run(a.levels or DEFAULT_LEVELS, a.seed, a.k, save=a.save,
               against=a.against)


if __name__ == "__main__":
    main()
