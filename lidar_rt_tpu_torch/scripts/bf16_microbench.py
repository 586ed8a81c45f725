"""Does packed bfloat16 arithmetic run a gate-shaped body twice as fast as
float32 on the card?  (Counterpart of the reference's
`scripts/bf16_microbench.py`.)

    python -m lidar_rt_tpu_torch.scripts.bf16_microbench [--seed 0] \
        [--save PATH] [--against PATH]

The kernel, `csrc/bf16_microbench.cu`, repeats a body shaped like the
forward kernel's gate phase (two multiply-adds, two multiplies, an
optional exp, a min and a clamp, a multiply-add into an accumulator)
REPS times over a (ROWS, LANES) block, in float32 or in bfloat16 on
packed bf16x2 instructions.  For each of with and without the exp it
prints the float32 and the bfloat16 ms per launch (CUDA events over ITERS
launches after one), their ratio (about 2 if packing doubles the rate,
about 1 if it buys nothing) and each one's bound: its operations over the
card's rate for the type, or its bytes over the memory rate.  `--save`
and `--against` keep and hold each mode's ms and output as
`kernel_microbench`'s do.  Measures on a CUDA card only.

`probe(a, b, with_exp)` launches the kernel on CUDA tensors and runs the
plain PyTorch version, `probe_reference`, on CPU tensors; nothing falls
back from one to the other.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lidar_rt_tpu_torch.ops import kernels
from lidar_rt_tpu_torch.scripts import kernel_microbench

ROWS, LANES, REPS = 512, 1024, 64
ITERS = 20
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# The probe's modes: its type and whether the body takes the exp.
MODES = (("f32", False), ("bf16", False), ("f32", True), ("bf16", True))
# Operations an element a repetition: a * b + 0.5 and u * a - 0.5 (4),
# u*u + v*v (3), g*b and its min (2), the clamp (4: subtract, multiply, min,
# max), acc + al * gate (2) and a + 1e-6 (1); the exp and
# its negation add 2.
OPS_PER_REP = {False: 16, True: 18}
# The kernel against its plain version: both round every operation of the
# body apart, in the same order; in bfloat16 within BF16_ULPS ulps of each
# value (h2exp is not torch's exp, and 64 roundings of the accumulator can
# carry a one-ulp difference on), in float32 as the ablation probe's bar.
BF16_ULPS = 8

# Launches of the kernel per mode name (`mode_name`): raised by one per
# launch in `probe`, nowhere else.
launches: dict[str, int] = {}


def mode_name(dtype: str, with_exp: bool) -> str:
    return dtype + ("_exp" if with_exp else "")


def reset_launches() -> None:
    for dtype, with_exp in MODES:
        launches[mode_name(dtype, with_exp)] = 0


reset_launches()


def make_inputs(dtype: str, seed: int = 0, rows: int = ROWS,
                lanes: int = LANES, device="cuda"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's a and b: uniform in [0.1, 0.9), drawn from `seed`
    with numpy, in `dtype` ("f32" or "bf16")."""
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.uniform(0.1, 0.9, (rows, lanes)),
                              device=device).to(DTYPES[dtype])
                 for _ in range(2))


def probe(a: torch.Tensor, b: torch.Tensor, with_exp: bool,
          reps: int = REPS) -> torch.Tensor:
    """The body `reps` times over a and b (same shape, float32 or
    bfloat16): the accumulator, in their type.  Launches the CUDA kernel
    on CUDA tensors (raising on a failed launch) and runs
    `probe_reference` on CPU tensors."""
    dtype = next((k for k, v in DTYPES.items() if v == a.dtype), None)
    if (dtype is None or b.dtype != a.dtype or b.shape != a.shape
            or b.device != a.device or not a.is_contiguous()
            or not b.is_contiguous() or a.numel() % 2
            or a.numel() >= 2 ** 31):
        raise ValueError(f"the probe takes two contiguous float32 or "
                         f"bfloat16 tensors of one shape with an even "
                         f"number of elements, got {a.dtype} "
                         f"{tuple(a.shape)} and {b.dtype} {tuple(b.shape)}")
    if a.device.type == "cpu":
        return probe_reference(a, b, with_exp, reps)
    out = torch.empty_like(a)
    kernels.launch("bf16_microbench", a.device,
                   [a.data_ptr(), b.data_ptr(), out.data_ptr()],
                   (a.numel(), reps, int(dtype == "bf16"), int(with_exp)))
    launches[mode_name(dtype, with_exp)] += 1
    return out


def probe_reference(a: torch.Tensor, b: torch.Tensor, with_exp: bool,
                    reps: int = REPS) -> torch.Tensor:
    """The plain PyTorch version: the reference's body, each operation in
    the inputs' type."""
    def const(x):
        return torch.tensor(x, dtype=a.dtype, device=a.device)

    half, amax, amin = const(0.5), const(0.99), const(1.0 / 255.0)
    zero, eps = const(0.0), const(1e-6)
    acc = torch.zeros_like(a)
    for _ in range(reps):
        u = a * b + half
        v = u * a - half
        s = u * u + v * v
        g = torch.exp(-s) if with_exp else s
        al = torch.minimum(amax, g * b)
        gate = torch.maximum(torch.minimum((al - amin) * amax, amax), zero)
        acc = acc + al * gate
        a = a + eps
    return acc


def error(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error of `got` against the plain version's `want`, its
    ratio to the bar): within the bar at a ratio <= 1."""
    if got.dtype != torch.bfloat16:
        return kernel_microbench.error(got, want)
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp_min(torch.finfo(torch.bfloat16).tiny))) - 7)
    return err.max().item(), (err / (BF16_ULPS * ulp)).max().item()


def bound(a: torch.Tensor, with_exp: bool, reps: int = REPS
          ) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time the card could take,
    the larger of the operations over the type's peak rate (packed pairs
    for bfloat16) and a, b and the output once each over the memory
    rate."""
    ops = a.numel() * reps * OPS_PER_REP[with_exp]
    peak = (kernel_microbench.PEAK_BF16X2 if a.dtype == torch.bfloat16
            else kernel_microbench.PEAK_F32)
    ops_ms = 1e3 * ops / peak
    bytes_ms = (1e3 * 3 * a.numel() * a.element_size()
                / kernel_microbench.PEAK_BYTES)
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def run(seed: int = 0, device="cuda", save=None, against=None
        ) -> dict[str, dict]:
    """Time every mode on the card (ITERS + 1 launches each) and print the
    reference's lines with the bounds; save and hold the outputs as
    `kernel_microbench.hold` does; returns {mode name: {"ms", "bound_ms",
    "bound_by"}}."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise SystemExit("the probe measures a CUDA card: no device time "
                         "on the CPU")
    out, outs = {}, {}
    for dtype, with_exp in MODES:
        name = mode_name(dtype, with_exp)
        a, b = make_inputs(dtype, seed, device=dev)
        ms = kernel_microbench.event_ms(
            lambda: outs.__setitem__(name, probe(a, b, with_exp)), ITERS)
        b_ms, b_by = bound(a, with_exp)
        out[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by}
    for with_exp in (False, True):
        f32 = out[mode_name("f32", with_exp)]
        bf16 = out[mode_name("bf16", with_exp)]
        print(f"{'with exp' if with_exp else 'no exp  '}: f32 "
              f"{f32['ms']:7.4f} ms  bf16 {bf16['ms']:7.4f} ms  ratio "
              f"f32/bf16 = {f32['ms'] / bf16['ms']:.2f}x; bounds f32 "
              f"{f32['bound_ms']:.4f} ms ({f32['bound_by']}), bf16 "
              f"{bf16['bound_ms']:.4f} ms ({bf16['bound_by']})", flush=True)
    print("(ratio ~2x => packed bf16x2 doubles the rate; ~1x => packing "
          "buys nothing)")
    kernel_microbench.hold(out, outs, save, against)
    return out


def main(argv=None) -> dict[str, dict]:
    p = argparse.ArgumentParser(
        prog="python -m lidar_rt_tpu_torch.scripts.bf16_microbench")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save", help="keep each mode's ms and output here")
    p.add_argument("--against", help="hold them to another run's --save")
    a = p.parse_args(argv)
    return run(a.seed, save=a.save, against=a.against)


if __name__ == "__main__":
    main()
