"""Chip smoke run of the PyTorch/CUDA port (`lidar_rt_tpu_torch`).

    python3 chip_smoke.py [--seed 0]

On one CUDA card it:
  1. builds the CUDA forward and backward tracer kernels and the two
     probe kernels from `lidar_rt_tpu_torch/csrc` (one nvcc each, started
     together), prints
     each device kernel's ptxas registers and spills and its occupancy
     (resident blocks per SM) at the flagship K;
  2. builds a scene with numpy from --seed: the street soup of `bench.py`
     (131,072 background surfels) plus one 4,096-surfel actor on a 4-frame
     track, loaded with `scene_from_numpy`;
  3. holds the forward kernel to its plain PyTorch twin on the tile inputs
     of one flagship render (64 x 2650 scan, 8x128 tiles, K=256, hier
     binner);
  4. serves re-simulation requests through `lidar_rt_tpu_torch.sim` (one
     `render_scan`, one 4-pose `resimulate`), counts the kernel launches
     they made, and holds one render to the plain torch engine;
  5. prints serving times (median ms per render, kernel vs plain twin with
     CUDA events, a per-stage breakdown) and peak device memory;
  6. holds the backward kernel to its plain twin on the same tile inputs,
     with upstream gradients drawn from the seed, and again at 1/20 of the
     opacity (no ray reaches T_MIN) with an upstream gradient on raw T;
  7. holds the kernel path's render gradients to torch autograd through
     the plain torch engine;
  8. trains: renders ground truth from the scene at the 4 poses, perturbs
     a copy of the scene, and runs `train.loop.Trainer` for 20 steps at the
     flagship width (rebinning every 10 steps), counting both kernels'
     launches; then prints ms per step, kernel times against their twins,
     peak memory and a device profile of one step;
  9. holds the exact-order (per-ray depth order) forward and backward
     kernels to their plain twins on phase 3's tile inputs and at K=128,
     and times them beside the tile-order kernels; then, for both forward
     kernels, prints the share of (warp, candidate) steps their box test
     skips at the training and the serving inputs, times each at both,
     and checks in both orders that the same tiles with their rays
     permuted (where the test skips almost nothing) give the same bits;
 10. serves in the other modes: an exact-order `render_scan` and 4-pose
     `resimulate`, `render_multi_return` (dual returns) and a
     `render_scan` with one tail pass, each against the torch engine in
     the same mode, counting each mode's launches;
 11. holds the exact-order render gradients to torch autograd through the
     torch engine;
 12. trains 10 steps in exact order and 10 with one tail pass, counting
     launches per mode and rebins;
 13. the data path: renders the rehearsal's Waymo segment (50 frames,
     64 x 2650, two returns, 3 moving vehicles) and KITTI-360 sequence (40
     frames, 66 x 1030, one car) on the card with the rehearsal runner's
     generators (`scripts/e2e_rehearsal.py`) and the port's `synthetic`,
     writes them in their wire formats with its `writers`, loads them with
     its loaders (Waymo through the native ingest, held to the Python
     parser on two frames to the bit), assembles both scenes on the card
     with the rehearsal's options, holds the tile-order forward and
     backward kernels, uncached and cached (16's checks), to their twins
     on a render of the assembled Waymo scene at K=512 and K=256, and
     trains the Waymo scene 20 steps and the
     KITTI-360 scene 10 with the rehearsal's tracer settings (K=512 warm-up,
     K=256 after, one tail pass), the warm-up cut short so that both
     budgets and the switch run; then the Waymo scene 4 steps with those
     settings and exact_order: true, across the switch: the K=512
     warm-up resolves to the torch engine (no kernel), K=256 to the exact
     kernels (engine, launches, ms per step and peak memory per budget);
 14. the CLI on phase 13's Waymo segment, in phase 13's directory:
     `python -m lidar_rt_tpu_torch.cli` `train` (20 of the rehearsal's
     4,000 iterations, a held-out PSNR every 10, warm-up budget to 10,
     2 refine epochs in batches of 16), `train --resume --iterations 25`,
     then `eval -t test -e -i -p` with the refined U-Net; checks the
     artifacts, that every metric is finite (LPIPS reads unavailable),
     that the saved checkpoint renders an eval frame's channels
     bit-identically to the trainer, and the U-Net and the LPIPS network
     (seeded weights) on the card against the CPU; prints each CLI
     stage's seconds, ms per eval frame and peak memory.
 15. the scale-out path (`lidar_rt_tpu_torch.parallel`) on the Waymo
     segment's scene, assembled again and handed to the ranks as a
     checkpoint; ranks are processes sharing this card through gloo
     (`parallel.run_world`), each importing only this script and the
     port: (a) in a rays = 2 world, each band's kernels (both orders,
     the exact backward's fast sums, and on band 0 the cached pair)
     against their twins on its tile inputs (8 x 128 tiles, K = 256: 88
     tiles of 1325 columns each), and the bands of `trace_ray_sharded`,
     gathered, against this process's band traces (channels to the bit);
     (b) the bundle's gradients of a loss on the gathered scan against
     this process's; (c) `ShardedTrainer` on a 1 x 1 mesh against
     `Trainer`: at each of 20 rehearsal steps one sharded step from a copy
     of the plain trainer's state (same frame and bins), its loss and its
     gradients before the optimizer held to the plain step's; then the
     20-step trajectories of both (the Trainer run three times, to
     measure how far runs part on the card), ms per step of both; (d) a
     dp = 2 x rays = 2
     world of 4 ranks, 10 tile-order steps with the rehearsal's tracer
     settings and 2 in exact order: losses, distinct frames per row, the
     state bit-identical on every rank, ms per step and the bytes and ms
     of its all-reduces (four ranks share one card: no scaling figure).
     Phases 13-15 train with the rehearsal's tracer settings, whose
     fast_math selects the training modes on the card (16).
 16. the tracer's training modes (the reference's fast_math and
     cache_fwd) at phase 8's training render before its first step (a
     state the seed alone fixes) and after its 20 steps: the forward
     writing its bf16 cache against the uncached forward (channels to the
     bit) and its twin's encoding, the decoding backward with one TF32
     product per d_sh term against its twin and the float32 replay (held
     to the cache bars before the first step, reported after the 20, where
     the state differs run to run), the cache poisoned two ways, the exact
     order's fast sums against its twin, CUDA-event times
     of each mode beside the other, 20 training steps replayed in float32
     and 20 cached from the same state (ms per step and peak memory of
     each), 5 exact-order steps with the fast sums, and a serving render's
     peak memory in the cached configuration.
 17. (run after 15, while phase 13's directory exists) the
     reference-checkpoint workflow on phase 14's checkpoint: `python -m
     lidar_rt_tpu_torch.scripts.import_roundtrip` exports it to a
     reference `.pth`, imports it with the import command, fine-tunes 10
     steps with `cli train --resume` and evaluates every frame with `cli
     eval -t all -e`, each a child process on this card; the imported
     scene's render of an eval frame held to the source's, the
     children's kernel launches, every metric finite, each stage's
     seconds and peak memory;
 18. (run after 17, in phase 13's directory) the rehearsal runner,
     `python -m lidar_rt_tpu_torch.scripts.e2e_rehearsal` `train`, `eval`
     (`cli eval -t all -e -i`) on both of phase 13's datasets and
     `collect`, at phase 14's reduced depth: the record's keys are
     E2E_r05.json's plus the card, every metric finite, each stage's
     seconds, the children's launches; then `train kitti --split 10`
     once more, densifying every 5 steps: 10 + 10 steps, the second chunk
     resumed from the first one's checkpoint, must leave one contiguous
     log.json (history, densify events, held-out evals) and refine the
     U-Net once;
 19. the two probe kernels (`lidar_rt_tpu_torch/scripts/
     kernel_microbench.py`, the forward body's ablation ladder, every
     level; `bf16_microbench.py`, a gate-shaped body in float32 and on
     packed bfloat16 pairs, with and without the exp): each probe's main
     path with its launches counted, then every level and mode against its
     plain version (errors and bars printed), ms, bounds and the ptxas
     registers and spills per level;
 20. (run after 18, in phase 13's directory) the tile-order kernels,
     uncached and cached, against their twins at the tools' shapes
     (quality_check's 16x32 K=128 with its tail pass at 32 x 512,
     nan_forensics' 8x256 K=128 at 64 x 2650; errors by tool in the
     kernel table's `max_abs_err_by_path`); then the user tools as child
     processes on this card: `python -m
     lidar_rt_tpu_torch.scripts.quality_check` on two configs (8x128
     K=256, 16x32 K=128 with a tail pass) at 32 x 512 for 50 iterations,
     `...nan_forensics` for 20 steps (every gradient finite) and
     `...refine_spread` on phase 14's checkpoint (2 seeds of 2 epochs,
     the test frames): each one's results, engine and launches; and
     `...truncation_trace` on the KITTI-360 sequence for two chunks of 10
     steps (each pass's truncation), then three trainers in this
     process, one read by `chain_truncation` after each chunk: each read
     leaves the state and generators bit-identical, and the read
     trainer's history equals an unread one's bit for bit where the card
     trains bit-reproducibly;
 21. (run after 19) the tile-order kernels, uncached and cached, against
     their twins at the two shapes `scripts/sweep_perf.py` adds (4x128 and
     8x64 at K=128, on the street scene: errors by shape in the kernel
     table's `max_abs_err_by_path`), the cached decode also against the
     float32 replay on an upstream draw from --seed; then the eight
     design probes of `lidar_rt_tpu_torch/scripts/` in this process at
     the bench's full shape (64 x 2650, 131,072 surfels), printing their
     lines:
     `survivor_stats`, `overcount_probe`, `subtile_demand`,
     `occlusion_stats`, `selection_probe`, `profile_binner`, `sweep_perf`
     (both modes) and `compact_probe`, the tracer kernels' launches of
     the last two counted per path; `profile_binner`'s m1024 row (the hier
     binner's macro-column level) beside plain hier's with its macro
     truncation, and the macro level held to plain hier's lists at the
     smallest macro_factor (or thinned soup) where no macro sector
     truncates.  The JAX checkpoints' export needs jax and is tested on
     the CPU only.
 22. (run after 21) the bench, `lidar_rt_tpu_torch/bench.py`, on the
     street scene at its flagship (20 coupled steps of the card's training
     mode, re-binned at 0 and 10), timed from a CUDA graph and eagerly: the
     opacity gradient a replay carries out of its last step against the
     eager run's at the gradient bars, the launches the capture holds (one
     cached forward and backward a step); 2 steps in exact order captured
     the same way; the tile-order forward against its twin at the tile
     shapes only `grid_overhead_probe` gives it (16x128, 32x128, 8x256 at
     K=256); then the six stage profilers of `lidar_rt_tpu_torch/
     scripts/` (`profile_stages`, `profile_amortized`, `stage_bench`,
     `prep_bench`, `intercept_probe`, `grid_overhead_probe`) in this
     process at 5 steps a timing, printing their lines: every time and
     stage value finite, `intercept_probe`'s every-count-zero forward
     compositing nothing; the launches of each path, a capture's counted
     once a replay.

Every failed check raises.  Without a CUDA device it exits non-zero before
any phase.  The last two lines of standard output are the kernel table
{"kernels": [...]} (each kernel's launches per path, error, time, plain
twin's time and the bound of its work on this run's data) and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# bench.py's street soup, drawn with numpy from the seed: the port's one
# copy (`lidar_rt_tpu_torch/scripts/street.py`), and its device profile
# (`device_profile`: busy ms, idle share, top kernels, device operations a
# call), which the stage profilers share.
from lidar_rt_tpu_torch.scripts.street import device_profile as _device_profile
from lidar_rt_tpu_torch.scripts.street import street_soup

H, W = 64, 2650
N_BACKGROUND = 131_072
N_ACTOR = 4_096
N_FRAMES = 4
# Bars: channels as the reference's on-device parity bar (max abs error);
# accum is a sum of up to 1024 per-ray weights, taken with atomics in no
# fixed order, so it gets a relative bar on top.
CHAN_ATOL = 1e-3
ACCUM_RTOL, ACCUM_ATOL = 1e-4, 1e-3
# Gradients are sums over rays taken with atomics in no fixed order: per
# field, cosine above the reference's on-device bar and max abs error
# within 3e-3 of the field's largest magnitude (its CPU bar, scaled).
GRAD_COS, GRAD_REL = 0.999, 3e-3
# The training modes (fast_math, cache_fwd) against the float32 replay:
# the reference's cache bars (tests/test_pallas_tracer.py:354-379: within
# 1.5e-2 of the field's largest magnitude, cosine > 0.999) and the cosine
# its fast mode met on the TPU (PARITY_r03.json: >= 0.9996 per field).
FAST_COS, FAST_REL = 0.9996, 1.5e-2
# The cache's sign bits against the twin's float32 gates: a gate within
# these margins of its threshold may fall either way (the kernel's expf
# and the twin's exp differ by an ulp or two; the twin's cumulative
# product of (1 - alpha) associates differently from the kernel's running
# product), anywhere else the bits must agree.
ALPHA_GATE_ULPS = 4
LIVE_GATE_REL = 1e-5
TRAIN_STEPS = 20
MODE_STEPS = 10        # training steps in each other mode (phase 12)

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W):
# float32 outside the tensor cores, TF32 on them, and device memory
# bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# Operations the tracer's work needs, counted per (ray, candidate) pair the
# kernel must evaluate (the intersection and gates: three 3-dots, the
# range, splat coordinates, exp, opacity, clamps) and per composited hit
# (forward: 48 SH multiply-adds and the channel sums; backward: the replay,
# dL/dw, dL/dalpha, the chain to the candidate's fields and its 63 sums).
# Ordering a ray's hits by depth is not counted: the bound stays a floor.
PAIR_FLOPS = 30
# Per box test of a (32-ray warp, candidate) step: the splat axes U and V,
# the bounds of |n.d|, |U.d| and |V.d| over the warp's box, their slacks
# and the gate's radius.
CONE_FLOPS = 130
FWD_HIT_FLOPS = 120
BWD_HIT_FLOPS = 230
# Of the backward's, the d_sh sums (48 multiply-adds) run on the tensor
# cores, each product as three TF32 products (3xTF32), or one in the fast
# mode.
BWD_SH_FLOPS = 96
# A backward pair decoded from the forward's cache: the intersection's
# locals without the exp, the gates or the transmittance product.
CACHE_PAIR_FLOPS = 22
CACHE_BYTES = 4        # per cached (ray, candidate) step: two bfloat16


def _raw_asset(part: str, act: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Activated arrays -> `part.*` raw leaves (inverse activations)."""
    o = act["opacities"].astype(np.float64)
    lead = act["means"].shape[:-1]
    return {
        f"{part}.xyz": act["means"],
        f"{part}.quat": act["rotations"],
        f"{part}.log_scale": np.log(act["scales"]).astype(np.float32),
        f"{part}.opacity_logit": np.log(o / (1.0 - o)).astype(np.float32),
        f"{part}.f_dc": act["sh"][..., :1, :],
        f"{part}.f_rest": act["sh"][..., 1:, :],
        f"{part}.alive": np.ones(lead, bool),
        f"{part}.active_sh_degree": np.full(lead[:-1], 3, np.int32),
    }


def scene_arrays(seed: int) -> dict[str, np.ndarray]:
    """Background soup + one actor (a car-sized box of surfels) driving
    along +x past the sensor over N_FRAMES frames."""
    arrays = _raw_asset("background", street_soup(N_BACKGROUND, seed))
    rng = np.random.default_rng(seed + 1)
    size = np.array([4.5, 2.0, 1.6], np.float32)
    actor = {
        "means": (rng.uniform(-0.5, 0.5, (1, N_ACTOR, 3)) * size
                  ).astype(np.float32),
        "rotations": rng.normal(size=(1, N_ACTOR, 4)).astype(np.float32),
        "scales": rng.uniform(0.05, 0.2, (1, N_ACTOR, 2)).astype(np.float32),
        "opacities": rng.uniform(0.5, 0.95, (1, N_ACTOR)).astype(np.float32),
        "sh": np.concatenate(
            [rng.uniform(-0.5, 1.0, (1, N_ACTOR, 1, 3)),
             rng.normal(0, 0.1, (1, N_ACTOR, 15, 3))], 2).astype(np.float32),
    }
    arrays.update(_raw_asset("actors", actor))
    f = np.arange(N_FRAMES, dtype=np.float32)
    yaw = 0.1 * f
    arrays.update({
        "tracks.size": size[None],
        "tracks.translations": np.stack(
            [-4.0 + 2.5 * f, np.full_like(f, 3.5), np.full_like(f, 0.8)],
            -1)[None].astype(np.float32),
        "tracks.quats": np.stack(
            [np.cos(yaw / 2), 0 * f, 0 * f, np.sin(yaw / 2)],
            -1)[None].astype(np.float32),
        "tracks.present": np.ones((1, N_FRAMES), bool),
    })
    return arrays


def ptxas_report(log: str) -> list[tuple[str, str]]:
    """[(device kernel, "N registers, S bytes spill stores, L bytes spill
    loads")] from an `nvcc -Xptxas -v` log; a kernel template's arguments
    are named as `kernels.DEVICE_KERNELS` names them (<false>, <2,true>)."""
    out, kernel, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"((?:tracer|probe|candidate)_[a-z_]+_kernel)"
                          r"((?:L[bi]\d+E)*)",
                          line.replace("_kernelI", "_kernel"))
            args = [("true" if v == "1" else "false") if t == "b" else v
                    for t, v in re.findall(r"L([bi])(\d+)E",
                                           m.group(2) if m else "")]
            kernel = (m.group(1) + (f"<{','.join(args)}>" if args else "")
                      if m else line.split("'")[1])
        elif "spill stores" in line:
            spills = ", ".join(x.strip() for x in line.split(",")[1:])
        elif "registers" in line and kernel is not None:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((kernel, f"{regs} registers, {spills}"))
            kernel = None
    return out


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _accum_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, bool]:
    err = (a - b).abs()
    return err.max().item(), bool((err <= ACCUM_ATOL
                                   + ACCUM_RTOL * b.abs()).all())


def _event_ms(fn, iters: int) -> float:
    """Mean device ms per call over `iters` calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _grad_errors(got, ref, names) -> dict[str, tuple[float, float]]:
    """Per field: (cosine, max abs error / max |ref|), in float64."""
    out = {}
    for name, a, b in zip(names, got, ref):
        a, b = a.double().flatten(), b.double().flatten()
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        out[name] = (cos, ((a - b).abs().max()
                           / (b.abs().max() + 1e-30)).item())
    return out


def _check_grads(errors: dict, what: str) -> None:
    for name, (cos, rel) in errors.items():
        _check(cos > GRAD_COS and rel <= GRAD_REL,
               f"{what} {name}: cosine {cos:.6f}, rel err {rel:.3e}")


def _fmt_grads(errors: dict) -> str:
    return ", ".join(f"{name} cos {cos:.6f} err {rel:.2e}"
                     for name, (cos, rel) in errors.items())


def perturbed(arrays: dict[str, np.ndarray], seed: int
              ) -> dict[str, np.ndarray]:
    """A copy of the scene to train back: positions jittered by 3 cm,
    log-scales +0.3, opacity logits -1, SH noise."""
    rng = np.random.default_rng(seed)
    out = dict(arrays)
    for part in ("background", "actors"):
        def noisy(key, scale):
            a = arrays[f"{part}.{key}"]
            return (a + rng.normal(0, scale, a.shape)).astype(np.float32)

        out[f"{part}.xyz"] = noisy("xyz", 0.03)
        out[f"{part}.log_scale"] = arrays[f"{part}.log_scale"] + 0.3
        out[f"{part}.opacity_logit"] = arrays[f"{part}.opacity_logit"] - 1.0
        out[f"{part}.f_dc"] = noisy("f_dc", 0.05)
        out[f"{part}.f_rest"] = noisy("f_rest", 0.02)
    return out


def expected_rebins(frames_seen: list[int], num_frames: int,
                    interval: int) -> int:
    """Rebins a trainer makes over a frame sequence: a frame is binned when
    its age (steps since its last binning) reaches the interval."""
    age = [interval] * num_frames
    count = 0
    for f in frames_seen:
        stale = age[f] >= interval
        age = [a + 1 for a in age]
        if stale:
            age[f] = 1
            count += 1
    return count


def tracer_work(inputs, exact: bool) -> dict[str, int | float]:
    """The work of a tracer kernel on these tile inputs, from the plain
    twin's replay and the kernels' box test (`cone_skips`, its plain twin),
    in (tile, 32-ray warp, candidate) steps and (ray, candidate) pairs.  A
    ray reaches its candidates up to the one that stops it in tile order,
    and every candidate in exact order (any may be the nearest).

    `steps`: every step below cnt; `skipped`: those the box test rules
    out; `tests`: the steps some ray of the warp reaches, one box test
    each; `visited`: those of them the test leaves (in tile order
    candidate 0 always); `composited`: the steps holding a composited
    pair; `pairs`: the pairs of visited steps that their ray reaches;
    `all_pairs`: every pair a ray reaches, with no box test; `hits`: the
    pairs composited; and the visited steps per warp and per 128-ray block
    (its busiest warp), mean and max."""
    from lidar_rt_tpu_torch.ops import cuda_tracer

    t, r = inputs.dirs.shape[:2]
    k = inputs.axes.shape[-1]
    warps = -(-r // 32)

    def by_warp(x):                   # (T, R, K) -> (T, W, 32, K)
        return torch.nn.functional.pad(x, (0, 0, 0, warps * 32 - r)).view(
            t, warps, 32, k)

    with torch.no_grad():
        f = cuda_tracer._pairs(*inputs[:8], exact=exact)
        cnt = inputs.cnt.clamp(0, k)
        idx = torch.arange(k, device=cnt.device)
        in_cnt = idx < cnt[:, None]                                  # (T, K)
        if exact:
            walk = cnt[:, None].expand(t, r)
        else:
            walk = torch.minimum((f.live & in_cnt[:, None]).sum(-1) + 1,
                                 cnt[:, None])                       # (T, R)
        reached = idx < walk[..., None]                           # (T, R, K)
        tested = by_warp(reached).any(2)                          # (T, W, K)
        skip = cuda_tracer.cone_skips(inputs.cnt, inputs.dirs, inputs.axes,
                                      inputs.plane, inputs.inv_scale,
                                      inputs.opac)
        visited = tested & (~skip if exact else ~skip | (idx == 0))
        per_warp = visited.sum(-1).float()                           # (T, W)
        per_block = torch.nn.functional.pad(
            per_warp, (0, -warps % 4)).view(t, -1, 4).amax(-1)
        return {
            "steps": int(in_cnt.sum()) * warps, "skipped": int(skip.sum()),
            "tests": int(tested.sum()), "visited": int(visited.sum()),
            "composited": int(by_warp(f.w > 0).any(2).sum()),
            "pairs": int((by_warp(reached) & visited[:, :, None]).sum()),
            "all_pairs": int(reached.sum()), "hits": int((f.w > 0).sum()),
            "warp_mean": per_warp.mean().item(),
            "warp_max": per_warp.max().item(),
            "block_mean": per_block.mean().item(),
            "block_max": per_block.max().item()}


def bound(inputs, work: dict, backward: bool, culled: bool = True,
          cache: bool = False, fast: bool = False) -> tuple[float, str]:
    """The least ms the card could take for a tracer kernel's work, and
    what bounds it: the larger of its bytes (each input read once, each
    output written once) over the memory rate and its operations (from
    `tracer_work`) over the float32 rate, the backward's d_sh sums over
    the TF32 rate (three products per term, one with `fast`).  The
    operations are the box tests and the pairs they leave (whether or not
    the kernel culls yet: a floor), or, with `culled` False, every pair a
    ray reaches and no box test.  With `cache` the forward also writes,
    and the backward reads, CACHE_BYTES per pair its rays reach at a
    visited step, and each ray's int32 last index; the backward's pairs
    cost CACHE_PAIR_FLOPS."""
    t, r = inputs.dirs.shape[:2]
    k = inputs.axes.shape[-1]
    hits = work["hits"]
    pair_flops = CACHE_PAIR_FLOPS if cache and backward else PAIR_FLOPS
    flops = (work["pairs"] * pair_flops + work["tests"] * CONE_FLOPS
             if culled else work["all_pairs"] * pair_flops)
    nbytes = 4 * (t + 5 * t * r + 64 * t * k)   # cnt, dirs/mind/t0, candidates
    if cache:
        nbytes += CACHE_BYTES * work["pairs"] + 4 * t * r
    tf32_flops = 0
    if backward:
        nbytes += 4 * (2 * 16 * t * r + 64 * t * k)   # channels, grads in/out
        flops += hits * (BWD_HIT_FLOPS - BWD_SH_FLOPS)
        tf32_flops = (1 if fast else 3) * hits * BWD_SH_FLOPS
    else:
        nbytes += 4 * (16 * t * r + t * k)            # channels, accum out
        flops += hits * FWD_HIT_FLOPS
    by_bytes = nbytes / PEAK_BYTES * 1e3
    by_ops = (flops / PEAK_F32_FLOPS + tf32_flops / PEAK_TF32_FLOPS) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def candidate_bound(index: torch.Tensor, valid: torch.Tensor,
                    n: int) -> dict[str, float]:
    """The least ms the card could take for the candidate gather and
    scatter at these slots, by bytes (each input read once, each output
    written once) over the memory rate.  The gather reads each slot's
    int64 index and bool validity and the row of each surfel it lists (58
    floats; sentinel slots list surfel N - 1) and writes 64 floats a slot;
    the scatter reads the index and validity, the 63 gradient floats of
    each valid slot and 10 floats of each surfel they list, and writes the
    five (N, .) gradients, 58 floats a surfel."""
    slots = index.numel()
    idx = index.clamp(0, n - 1)
    listed = int(torch.unique(idx).numel())
    listed_valid = int(torch.unique(idx[valid]).numel())
    gather = 9 * slots + 4 * (58 * listed + 64 * slots)
    scatter = 9 * slots + 4 * (63 * int(valid.sum()) + 10 * listed_valid
                               + 58 * n)
    return {"candidate_gather": gather / PEAK_BYTES * 1e3,
            "candidate_scatter": scatter / PEAK_BYTES * 1e3}


def _reached(f) -> tuple[torch.Tensor, torch.Tensor]:
    """Of the twin's pairs `f` in tile order: the (T, R, K) steps each ray
    reaches (its stop included), and the (T, R) rays whose transmittance
    at a step they reach comes within LIVE_GATE_REL of T_MIN, where the
    kernel's running product may stop a ray a step apart from the twin's
    cumulative one."""
    from lidar_rt_tpu_torch.ops import geometry

    reached = torch.cat([torch.ones_like(f.live[..., :1]),
                         torch.cumprod(f.live.int(), -1)[..., :-1].bool()],
                        -1)
    t_incl = f.t_excl * (1.0 - f.alpha)
    border = (reached & ((t_incl - geometry.T_MIN).abs()
                         <= LIVE_GATE_REL * geometry.T_MIN)).any(-1)
    return reached, border


def cache_check(inputs, got: torch.Tensor) -> dict[str, int]:
    """The forward kernel's cache pairs `got` (`kernels.cache_shape`,
    bfloat16), written into a NaN-filled buffer, against the plain twin's
    encoding of the same tile inputs (`cuda_tracer.encode_cache`).  Counts of (tile,
    candidate, ray) steps: `written` (not NaN); `stray`, written where the
    twin's ray had stopped before the step; `missed`, a step the twin's
    ray reaches, holding a pair that passes its gates, left unwritten;
    `magnitude`, written with |x| or |y| more than one bfloat16 ulp from
    the twin's; `sign`, with a sign bit other than the twin's where the
    twin's gate is clear of its threshold (ALPHA_GATE_ULPS of the alpha
    before its clamp, LIVE_GATE_REL); `near_gate`, sign bits that differ at a gate within
    those margins (excused).  A ray whose twin transmittance comes within
    LIVE_GATE_REL of T_MIN may stop a step apart in the two: its steps
    are left out of `stray`, `missed` and `sign` (`borderline_rays`)."""
    from lidar_rt_tpu_torch.ops import cuda_tracer, geometry

    with torch.no_grad():
        f = cuda_tracer._pairs(*inputs[:8])
        want = cuda_tracer.encode_cache(f, inputs.cnt).pairs

        def ckr(x):                                  # (T, R, K) -> (T, K, R)
            return x.transpose(1, 2)

        reached, border = _reached(f)
        reached = ckr(reached)
        t, k, r = reached.shape
        border = border[:, None, :].expand_as(reached)
        ulp = ALPHA_GATE_ULPS * torch.finfo(torch.float32).eps
        # Before the ALPHA_MAX clamp, which sets every clamped pair to the
        # threshold itself.
        a_raw = ckr(inputs.opac[:, None, :] * f.g)
        near_alpha = (((a_raw - geometry.ALPHA_MAX).abs()
                       <= ulp * geometry.ALPHA_MAX)
                      | ((a_raw - geometry.ALPHA_MIN).abs()
                         <= ulp * geometry.ALPHA_MIN))
        written = ~got[..., 0].float().isnan()
        bits_got = got.view(torch.int16).int()
        bits_want = want.view(torch.int16).int()
        mag = ((bits_got & 0x7fff) - (bits_want & 0x7fff)).abs().amax(-1)
        sign_diff = (bits_got < 0) != (bits_want < 0)          # (T, K, R, 2)
        sign_ok_ac = near_alpha | border
        both = written & reached
        return {
            "written": int(written.sum()),
            "stray": int((written & ~reached & ~border).sum()),
            "missed": int((reached & ~written & ~border & ~near_alpha
                           & (want[..., 0].float() != 0.0)).sum()),
            "magnitude": int((both & (mag > 1)).sum()),
            "sign": int((both & ((sign_diff[..., 0] & ~sign_ok_ac)
                                 | (sign_diff[..., 1] & ~border))).sum()),
            "near_gate": int((both & ((sign_diff[..., 0] & sign_ok_ac)
                                      | (sign_diff[..., 1] & border))).sum()),
            "borderline_rays": int(border[:, 0].sum()),
            "steps": t * k * r}


def last_index_check(inputs, last: torch.Tensor) -> dict[str, int]:
    """The forward kernel's last index of each ray (`TracerCache.last`,
    (T, R) int32) against the twin's (`cuda_tracer.last_index`: the
    candidate at which the float32 replay stops the ray, else cnt - 1).
    Counts of rays: `differ`, another index than the twin's; `borderline`,
    another index on a ray whose twin transmittance comes within
    LIVE_GATE_REL of T_MIN (excused, as in `cache_check`)."""
    from lidar_rt_tpu_torch.ops import cuda_tracer

    with torch.no_grad():
        f = cuda_tracer._pairs(*inputs[:8])
        _, border = _reached(f)
        differ = last != cuda_tracer.last_index(f.live, inputs.cnt)
        return {"rays": last.numel(), "differ": int((differ & ~border).sum()),
                "borderline": int((differ & border).sum())}


def check_cached_pair(inputs, chans, accum, g, what: str,
                      report=print, replay_bar: bool = True) -> dict:
    """The cached tile-order pair on `inputs` (upstream `g`), held to the
    uncached forward's `chans` and `accum` and to the plain twins: the
    forward writing its cache into a NaN-filled buffer (channels to the
    uncached forward's bits, accum within 1e-5 relative; channels and
    accum against the twin; the cache against the twin's encoding,
    `cache_check`; the last indices by `last_index_check`), then the
    decoding backward with the fast sums against its twin (decoding the
    twin's cache) and the float32 replay, at FAST_COS and FAST_REL; and
    the same forward's cache written into a buffer filled with a live pair
    (a read of an unwritten step decodes as a stop from the NaN-filled
    buffer and as a composited pair from this one; zeros would decode as a
    stop too): the gradients from both buffers apart by no more than 4 x
    the spread of two runs of one buffer (sums with atomics in no fixed
    order) or 1e-5 x the field's largest magnitude.  Each finding goes to
    `report` before it is checked; every failed check raises, naming
    `what`.  With `replay_bar` False the decode against the float32 replay
    is reported and not checked (a state that differs run to run).
    Returns the largest errors against the twins (`fwd_err`, `bwd_err`),
    the decode's against the replay by field (`replay_errs`: cosine,
    error / max|replay|) and both caches (`cache`, `twin_cache`)."""
    from lidar_rt_tpu_torch.ops import cuda_tracer, kernels

    t, r = inputs.dirs.shape[:2]
    k = inputs.axes.shape[-1]
    with torch.no_grad():
        poisoned = torch.full(kernels.cache_shape(t, k, r), float("nan"),
                              dtype=torch.bfloat16, device=chans.device)
        c_chans, c_accum, cache = kernels.tracer_forward(
            *inputs, cache=True, cache_out=poisoned)
        p_chans, p_accum, p_cache = cuda_tracer.forward_tiles_reference(
            *inputs, cache=True)
        torch.cuda.synchronize()
    same = torch.equal(c_chans, chans)
    acc_rel = ((c_accum - accum).abs()
               / accum.abs().clamp_min(1e-30)).max().item()
    counts = cache_check(inputs, cache.pairs)
    fwd_err = (c_chans - p_chans).abs().max().item()
    acc_err, acc_ok = _accum_err(c_accum, p_accum)
    written = ~cache.pairs[..., 0].isnan()
    cache_err = (cache.pairs.float()
                 - p_cache.pairs.float())[written].abs().max().item()
    last = last_index_check(inputs, cache.last)
    cache_mib = sum(x.numel() * x.element_size() for x in cache) / 2 ** 20
    report(f"forward {what}, T={t} R={r} K={k}, cache {cache_mib:.1f} MiB: "
           f"channels {'bit-identical' if same else 'DIFFER'} to the "
           f"uncached forward, accum max rel diff {acc_rel:.3e} (atomics; "
           f"bar 1e-05); vs twin channels {fwd_err:.3e} (bar {CHAN_ATOL}), "
           f"accum {acc_err:.3e}; cache steps {counts} (bars: stray, "
           f"missed, magnitude and sign 0), written values within "
           f"{cache_err:.3e} of the twin's; last indices {last} (bar: "
           f"differ 0)")
    _check(same, f"{what}: cached forward channels vs the uncached "
           "forward's bits")
    _check(acc_rel <= 1e-5, f"{what}: cached forward accum vs the uncached "
           "forward")
    _check(fwd_err <= CHAN_ATOL and acc_ok, f"{what}: cached forward vs its "
           "twin")
    _check(last["differ"] == 0, f"{what}: cached forward's last indices vs "
           f"the twin's: {last}")
    _check(counts["written"] > 0 and counts["stray"] == counts["missed"]
           == counts["magnitude"] == counts["sign"] == 0,
           f"{what}: the forward's cache against its twin's encoding: "
           f"{counts}")
    del p_chans, p_accum, written
    with torch.no_grad():
        replay = kernels.tracer_backward(*inputs, chans, g)
        got = kernels.tracer_backward(*inputs, chans, g, cache=cache,
                                      fast=True)
        again = kernels.tracer_backward(*inputs, chans, g, cache=cache,
                                        fast=True)
        twin = cuda_tracer.backward_tiles_reference(*inputs, chans, g,
                                                    cache=p_cache)
        _, _, live_cache = kernels.tracer_forward(
            *inputs, cache=True, cache_out=torch.full_like(poisoned, 0.5))
        live = kernels.tracer_backward(*inputs, chans, g, cache=live_cache,
                                       fast=True)
        torch.cuda.synchronize()
    del poisoned, live_cache
    rows, poison_ok = [], True
    for name, a, b, c in zip(TWIN_GRADS, got, again, live):
        spread = (a - b).abs().max().item()
        diff = (a - c).abs().max().item()
        poison_ok &= diff <= max(4.0 * spread, 1e-5 * a.abs().max().item())
        rows.append(f"{name} {diff:.3e} (two runs of one buffer "
                    f"{spread:.3e})")
    report(f"poison {what}: gradients from the cache in a NaN-filled vs a "
           f"live-pair-filled buffer: {', '.join(rows)}; bar 4 x the spread "
           f"or 1e-5 x max")
    for x in got:
        _check(bool(torch.isfinite(x).all()), f"{what}: cached backward "
               "finite")
    _check(poison_ok, f"{what}: poisoned caches: {rows}")
    for label, ref, bar in (("its twin", twin, True),
                            ("the float32 replay", replay, replay_bar)):
        errs = _grad_errors(got, ref, TWIN_GRADS)
        report(f"backward {what}, T={t} R={r} K={k}, cache decoded, fast "
               f"sums, vs {label}: {_fmt_grads(errs)} " + (
                   f"(bars: cosine >= {FAST_COS}, err <= {FAST_REL} x "
                   f"max|ref|)" if bar else "(reported, no bar)"))
        if bar:
            _check(all(cos >= FAST_COS and rel <= FAST_REL
                       for cos, rel in errs.values()),
                   f"{what}: cached backward vs {label}: {errs}")
    bwd_err = max((a - b).abs().max().item() for a, b in zip(got, twin))
    return {"fwd_err": fwd_err, "bwd_err": bwd_err, "replay_errs": errs,
            "cache": cache, "twin_cache": p_cache}


def permuted_rays(inputs, seed: int = 0):
    """The same tiles with each tile's rays in one random order, and that
    order (ray i of a permuted tile is ray order[i]): each ray's channels
    and each sum over a tile's rays are the same, but each warp's 32 rays
    scatter over the tile, so that the kernels' box test rules out almost
    nothing."""
    order = torch.randperm(inputs.mind.shape[1], generator=torch.Generator(
        ).manual_seed(seed)).to(inputs.dirs.device)
    return inputs._replace(dirs=inputs.dirs[:, order].contiguous(),
                           mind=inputs.mind[:, order].contiguous(),
                           t0=inputs.t0[:, order].contiguous()), order


def render_grads(scene, grid, s2w, degree, heads, exact: bool):
    """Gradients of every bundle field through `render_frame`'s heads
    weighted by `heads`, on the kernel path and through torch autograd of
    the plain engine: {engine: [grads]}."""
    from lidar_rt_tpu_torch.ops import tracer
    from lidar_rt_tpu_torch.scene import compose

    fields = ("means", "rotations", "scales", "opacities", "sh")
    out_grads = {}
    for engine in ("cuda", "torch"):
        with torch.no_grad():
            bundle, _ = compose(scene, 0)
        leaf = bundle._replace(**{f: getattr(bundle, f).clone()
                                  .requires_grad_() for f in fields})
        out = tracer.render_frame(leaf, grid, W, s2w, degree,
                                  tracer.TraceConfig(engine=engine,
                                                     exact_order=exact))
        sum((out[key] * w).sum() for key, w in heads.items()).backward()
        out_grads[engine] = [getattr(leaf, f).grad for f in fields]
    torch.cuda.synchronize()
    return _grad_errors(out_grads["cuda"], out_grads["torch"], fields)


# The rehearsal datasets (`lidar_rt_tpu_torch.scripts.e2e_rehearsal`
# `gen_waymo`, `gen_kitti`): a Waymo segment of 50 frames at 64 x 2650
# with two returns, a street scene and 3 moving vehicles, and a
# KITTI-360 sequence of 40 frames at 66 x 1030 with one moving car.
WAYMO_H, WAYMO_W, WAYMO_FRAMES = 64, 2650, 50
KITTI_FRAMES = 40
DATA_TRAIN_STEPS = 20      # Waymo rehearsal steps (phase 13)
DATA_WARMUP_UNTIL = 10     # of the rehearsal's 2000, so both budgets run
KITTI_TRAIN_STEPS = 10
KITTI_WARMUP_UNTIL = 5
EXACT_DATA_STEPS = 4       # Waymo rehearsal steps with exact_order: true
EXACT_DATA_WARMUP_UNTIL = 2


def _timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _train_budgets(trainer, steps: int, what: str, card: str):
    """Run `steps` single steps with the tile-order kernels' launches
    counted from 0, in the trainer's mode (cached or replayed), and print
    them per budget: {K: (steps, forward launches, backward launches,
    host ms per step)}.  Checks every loss and parameter finite, that no
    kernel of another mode ran and that the candidate kernels launched
    with each pass (their counts are left for the caller)."""
    from lidar_rt_tpu_torch.ops import kernels

    cached = trainer.trace_cfg.use_cache

    def counts():
        return ((kernels.forward_cache_launches,
                 kernels.backward_cache_launches) if cached
                else (kernels.forward_launches, kernels.backward_launches))

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    rows = []
    for _ in range(steps):
        fwd, bwd = counts()
        _, s = _timed(lambda: trainer.run(1, log_every=1))
        rows.append((trainer.step_cfg.tile.max_per_tile,
                     counts()[0] - fwd, counts()[1] - bwd, s * 1e3))
    others = ((kernels.forward_launches, kernels.backward_launches)
              if cached else (kernels.forward_cache_launches,
                              kernels.backward_cache_launches))
    _check((kernels.forward_exact_launches, kernels.backward_exact_launches,
            kernels.backward_exact_fast_launches) + others == (0,) * 5,
           f"{what}: launches of another mode in "
           f"{'cached' if cached else 'replayed'} tile-order training")
    _check(_launch_counts() == _with_prep(_launch_counts()[:7]),
           f"{what}: one candidate gather a forward and one scatter a "
           f"backward launch: {dict(zip(LAUNCH_KEYS, _launch_counts()))}")
    loss = [h["loss"] for h in trainer.history]
    _check(len(loss) == steps and all(np.isfinite(loss)),
           f"{what}: training losses finite")
    for part in ("background", "actors"):
        asset = getattr(trainer.state.scene, part)
        if asset is not None:
            for name, v in asset.params().items():
                _check(bool(torch.isfinite(v).all()),
                       f"{what}: {part}.{name} finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    by_k = {}
    for k, fwd, bwd, ms in rows:
        n, f, b, times = by_k.get(k, (0, 0, 0, []))
        by_k[k] = (n + 1, f + fwd, b + bwd, times + [ms])
    mode = "cached" if cached else "replayed"
    print(f"[data-train] {card}: {what}, {steps} steps, "
          f"{trainer.state.bins.rebins} rebins; "
          + "; ".join(f"K={k}: {n} steps, {f} forward and {b} backward "
                      f"{mode} launches, median {statistics.median(t):.3f} "
                      f"ms per "
                      f"step (min {min(t):.3f}, max {max(t):.3f}, host "
                      f"clock)" for k, (n, f, b, t) in by_k.items())
          + f"; peak allocated {peak:.1f} MiB; loss "
          f"{[round(x, 5) for x in loss]}")
    return by_k


def data_phase(seed: int, card: str, dev, gen, tmp: str) -> dict:
    """Phase 13: the data path from files on disk (written under `tmp`)
    to a trained scene.  Returns the kernels' launches on its training
    paths and their errors (uncached and cached) on the assembled scene's
    tile inputs."""
    from lidar_rt_tpu_torch import native
    from lidar_rt_tpu_torch.data import build, kitti, waymo
    from lidar_rt_tpu_torch.ops import cuda_tracer, kernels
    from lidar_rt_tpu_torch.scene import compose
    from lidar_rt_tpu_torch.scripts.e2e_rehearsal import gen_kitti, gen_waymo
    from lidar_rt_tpu_torch.train import loop, options

    names = ("d_axes", "d_plane", "d_inv_scale", "d_opac", "d_sh")
    out = {"fwd_err": 0.0, "bwd_err": 0.0, "fwd_c_err": 0.0,
           "bwd_c_err": 0.0, "fwd_paths": {}, "bwd_paths": {},
           "fwd_c_paths": {}, "bwd_c_paths": {}, "fwd_x_paths": {},
           "bwd_xf_paths": {}, "prep_g_paths": {}, "prep_s_paths": {}}
    w_dir = os.path.join(tmp, "waymo")
    k_dir = os.path.join(tmp, "kitti360")
    w_imgs, gen_w_s = _timed(lambda: gen_waymo(
        w_dir, dev, WAYMO_FRAMES, WAYMO_H, WAYMO_W))
    k_imgs, gen_k_s = _timed(lambda: gen_kitti(k_dir, dev,
                                               KITTI_FRAMES))
    record = next(p for p in os.listdir(w_dir)
                  if p.endswith(".tfrecord"))
    size_mb = os.path.getsize(os.path.join(w_dir, record)) / 1e6
    print(f"[data-gen] Waymo segment {WAYMO_FRAMES} x {WAYMO_H}x"
          f"{WAYMO_W}, 2 returns, 3 vehicles: {gen_w_s:.2f} s "
          f"({size_mb:.1f} MB); KITTI-360 {KITTI_FRAMES} x 66x1030, 1 "
          f"car: {gen_k_s:.2f} s")

    opts_w = _waymo_options()
    opts_k = options.rehearsal_options("kitti")
    opts_k.frame_length = [0, KITTI_FRAMES - 1]
    (frames_w, tracks_w), load_w_s = _timed(lambda: waymo.load(
        w_dir, opts_w, use_native=True, device=dev))
    (frames_k, tracks_k), load_k_s = _timed(lambda: kitti.load(
        k_dir, opts_k, device=dev))

    # The native decode against the Python parser, first and last
    # frame, to the bit.
    path = os.path.join(w_dir, record)
    buf = open(path, "rb").read()
    offs, lens = native.tfrecord_index(buf)
    _check(len(offs) == WAYMO_FRAMES, f"{len(offs)} records")
    py_records = list(waymo.pw.tfrecord_iter(path))
    for i in (0, WAYMO_FRAMES - 1):
        rec = buf[offs[i]:offs[i] + lens[i]]
        _check(rec == py_records[i], f"record {i} framing")
        fd = native.waymo_decode_frame(rec)
        parsed = waymo._FrameParse(rec)
        r1, r2 = parsed.top_range_images()
        extr, beams, _ = parsed.top_calibration()
        _check(np.array_equal(fd.r1, r1) and np.array_equal(fd.r2, r2)
               and np.array_equal(fd.pose.astype(np.float32),
                                  parsed.pose())
               and np.array_equal(fd.extrinsic.astype(np.float32), extr)
               and np.array_equal(fd.beams, np.asarray(beams))
               and [b[0] for b in parsed.labels()] == fd.box_ids,
               f"native decode vs Python parser, frame {i}")
    # The loaded images are the rendered ones (-1 re-coded to 0).
    for key, img in w_imgs.items():
        _check(np.array_equal(getattr(frames_w, key).cpu().numpy(), img),
               f"loaded Waymo {key} equals the rendered images")
    k_r = frames_k.range1.cpu().numpy()
    both = (k_r > 0) & (k_imgs["range1"] > 0)
    k_agree = float((np.abs(k_r - k_imgs["range1"])[both] < 0.01).mean())
    k_hits = float((k_r > 0).mean() / (k_imgs["range1"] > 0).mean())
    print(f"[data-load] {card}: Waymo {load_w_s:.2f} s (native ingest "
          f"and npz cache, {len(tracks_w)} tracks); KITTI-360 "
          f"{load_k_s:.2f} s ({len(tracks_k)} tracks); native decode "
          f"bit-identical to the Python parser on frames 0 and "
          f"{WAYMO_FRAMES - 1}; KITTI re-rasterized ranges within 1 cm "
          f"of the rendered ones on {k_agree:.4f} of shared hits, hit "
          f"ratio {k_hits:.4f}")
    _check(len(tracks_w) == 3 and len(tracks_k) == 1, "tracks loaded")
    _check(k_agree > 0.95 and k_hits > 0.95,
           "KITTI-360 loader re-rasterizes the rendered images")

    # Assembly, and its normals alone, each beside the card.
    def normals_alone(frames):
        for f in range(frames.num_frames):
            pts, _ = frames.inverse_projection(f)
            build._estimate_normals_padded(pts, frames.sensor_center(f))

    scenes = {}
    for label, frames, tracks, opts in (
            ("Waymo", frames_w, tracks_w, opts_w),
            ("KITTI-360", frames_k, tracks_k, opts_k)):
        _, normals_s = _timed(lambda: normals_alone(frames))
        scene, asm_s = _timed(lambda: build.assemble_scene(
            frames, tracks, opts,
            torch.Generator(device=dev).manual_seed(seed)))
        scenes[label] = scene
        n_pts = sum(int((frames.range1[f] > 0).sum()) + (
            0 if frames.range2 is None else int((frames.range2[f] > 0).sum()))
            for f in range(frames.num_frames))
        print(f"[data-assembly] {card}: {label}: {n_pts} points -> "
              f"{int(scene.background.num_alive)} background surfels "
              f"(capacity {scene.background.capacity}), {scene.num_actors} "
              f"actors x {scene.actors.capacity} slots "
              f"({[int(a) for a in scene.actors.alive.sum(1)]} alive); "
              f"assembly {asm_s:.2f} s, of which normals (timed alone) "
              f"{normals_s:.2f} s")
        for asset in (scene.background, scene.actors):
            for name, v in asset.params().items():
                _check(bool(torch.isfinite(v).all()),
                       f"{label} assembled {name} finite")
        _check(scene.num_actors == len(tracks), f"{label}: every moving "
               f"vehicle became an actor")

    # The tile-order kernels, uncached and cached, against their twins on
    # the tile inputs of one render of the assembled Waymo scene, at both
    # budgets.
    scene = scenes["Waymo"]
    cfg, warm_cfg, _ = options.trace_configs(opts_w)
    f0 = frames_w.train_frames[0]
    for budget in (warm_cfg, cfg):
        k = budget.tile.max_per_tile
        with torch.no_grad():
            bundle, _ = compose(scene, f0)
            inputs, asg = cuda_tracer.tile_inputs(
                bundle, frames_w.grid, frames_w.width, frames_w.pose(f0),
                scene.background.active_sh_degree, budget.tile)
            chans_k, acc_k = kernels.tracer_forward(*inputs)
            chans_p, acc_p = cuda_tracer.forward_tiles_reference(*inputs)
            g = torch.randn(chans_k.shape, generator=gen, device=dev)
            g[:, 9:] = 0.0     # raw T: never read by the training loss
            grads_k = kernels.tracer_backward(*inputs, chans_k, g)
            grads_p = cuda_tracer.backward_tiles_reference(*inputs, chans_k,
                                                           g)
            torch.cuda.synchronize()
        err = (chans_k - chans_p).abs().max().item()
        acc_err, acc_ok = _accum_err(acc_k, acc_p)
        g_err = _grad_errors(grads_k, grads_p, names)
        g_abs = max((a - b).abs().max().item()
                    for a, b in zip(grads_k, grads_p))
        with torch.no_grad():
            fwd_ms = _event_ms(lambda: kernels.tracer_forward(*inputs), 10)
            bwd_ms = _event_ms(lambda: kernels.tracer_backward(
                *inputs, chans_k, g), 10)
        print(f"[data-kernel] assembled Waymo scene, frame {f0}, "
              f"T={inputs.dirs.shape[0]} R={inputs.dirs.shape[1]} K={k}: "
              f"{inputs.cnt.float().mean().item():.1f} candidates/tile, "
              f"{int((asg.truncated > 0).sum())} tiles truncated; forward "
              f"channels max abs err {err:.3e} (bar {CHAN_ATOL}), accum "
              f"{acc_err:.3e}; backward {_fmt_grads(g_err)}; kernels "
              f"{fwd_ms:.3f} / {bwd_ms:.3f} ms forward / backward (CUDA "
              f"events, {card})")
        _check(bool(torch.isfinite(chans_k).all()), "data kernel finite")
        _check(err <= CHAN_ATOL, f"forward kernel vs twin at K={k}")
        _check(acc_ok, f"forward accum vs twin at K={k}")
        _check_grads(g_err, f"backward kernel vs twin at K={k}")
        out["fwd_err"] = max(out["fwd_err"], err)
        out["bwd_err"] = max(out["bwd_err"], g_abs)
        # The rehearsal's settings train this budget cached on the card:
        # the cached pair against its twins on the same inputs.
        _check(budget.use_cache, f"K={k}: the rehearsal's tracer settings "
               "(fast_math) train with the cache on the card")
        pair = check_cached_pair(
            inputs, chans_k, acc_k, g, f"assembled Waymo scene, frame {f0}",
            lambda line: print(f"[data-cache] {line}", flush=True))
        out["fwd_c_err"] = max(out["fwd_c_err"], pair["fwd_err"])
        out["bwd_c_err"] = max(out["bwd_c_err"], pair["bwd_err"])
        del inputs, chans_k, chans_p, grads_k, grads_p, g, pair

    # Training with the rehearsal's tracer settings: both budgets and the
    # switch between them.
    w_scene = scenes["Waymo"]
    for label, frames, opts, steps, until in (
            ("Waymo", frames_w, opts_w, DATA_TRAIN_STEPS, DATA_WARMUP_UNTIL),
            ("KITTI-360", frames_k, opts_k, KITTI_TRAIN_STEPS,
             KITTI_WARMUP_UNTIL)):
        cfg, warm_cfg, rehearsal_until = options.trace_configs(opts)
        print(f"[data-train] reduction: {label} warmup_until {until} in "
              f"place of the rehearsal's {rehearsal_until}, {steps} steps "
              f"in place of {opts.opt.iterations}")
        trainer = loop.Trainer(scenes.pop(label), frames, opts, cfg,
                               warmup_cfg=warm_cfg, warmup_until=until)
        by_k = _train_budgets(trainer, steps,
                                    f"{label} rehearsal at {frames.height}x"
                                    f"{frames.width}", card)
        passes = cfg.tail_passes + 1
        want = {warm_cfg.tile.max_per_tile: until,
                cfg.tile.max_per_tile: steps - until}
        _check({k: v[0] for k, v in by_k.items()} == want,
               f"{label}: steps per budget {by_k}, want {want}")
        for k, (n, fwd, bwd, _) in by_k.items():
            _check(fwd == bwd == passes * n,
                   f"{label} K={k}: {fwd} forward / {bwd} backward launches "
                   f"for {n} steps of {passes} passes")
        path = f"train_rehearsal_{label.split('-')[0].lower()}"
        mode = "_c" if cfg.use_cache else ""
        _check(cfg.use_cache, f"{label}: the rehearsal's tracer settings "
               "(fast_math) train with the cache on the card")
        out[f"fwd{mode}_paths"][path] = sum(v[1] for v in by_k.values())
        out[f"bwd{mode}_paths"][path] = sum(v[2] for v in by_k.values())
        out["prep_g_paths"][path] = kernels.prep_gather_launches
        out["prep_s_paths"][path] = kernels.prep_scatter_launches
        prof = _device_profile(trainer.step, 3)
        if prof is None:
            print(f"[data-profile] {card}: the trace holds no device "
                  "events; device busy time not measured")
        else:
            busy, idle, top, per_step = prof
            print(f"[data-profile] {card}: {label} rehearsal step at "
                  f"K={trainer.step_cfg.tile.max_per_tile}: device busy "
                  f"{busy:.3f} ms, idle share of the device span "
                  f"{idle:.3f} (upper bound), {per_step} device kernels "
                  f"per step")
            for name, ms in top:
                print(f"[data-profile]   {ms:8.3f} ms  {name[:100]}")
        del trainer
    l256 = exact_rehearsal(w_scene, frames_w, card, dev)
    for key in ("fwd_x", "bwd_xf", "prep_g", "prep_s"):
        out[f"{key}_paths"]["train_rehearsal_exact"] = l256[key]
    return out


def exact_rehearsal(scene, frames, card: str, dev) -> dict[str, int]:
    """Phase 13's Waymo scene trained with the rehearsal's tracer block
    and exact_order: true, across the switch: the K=512 warm-up resolves
    to the torch engine (the exact kernels take K <= 256), K=256 to the
    exact kernels with the rehearsal's fast sums.  Prints the engine,
    launches, host ms per step and peak memory per budget; returns the
    K=256 steps' launches by LAUNCH_KEYS."""
    from lidar_rt_tpu_torch.train import loop, options

    opts = _waymo_options()
    opts.tracer.exact_order = True
    cfg, warm_cfg, rehearsal_until = options.trace_configs(opts)
    engines = {c.tile.max_per_tile: c.resolve_engine()
               for c in (warm_cfg, cfg)}
    print(f"[data-exact] reduction: Waymo rehearsal with exact_order: "
          f"true, warmup_until {EXACT_DATA_WARMUP_UNTIL} in place of "
          f"{rehearsal_until}, {EXACT_DATA_STEPS} steps in place of "
          f"{opts.opt.iterations}; engines per budget {engines}")
    _check(engines == {512: "torch", 256: "cuda"}, "exact order: K=512 "
           "resolves to the torch engine, K=256 to the exact kernels")
    trainer = loop.Trainer(scene, frames, opts, cfg, warmup_cfg=warm_cfg,
                           warmup_until=EXACT_DATA_WARMUP_UNTIL)
    by_k = {}
    for _ in range(EXACT_DATA_STEPS):
        before = _launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _, s = _timed(lambda: trainer.run(1, log_every=1))
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        n = tuple(b - a for a, b in zip(before, _launch_counts()))
        k = trainer.step_cfg.tile.max_per_tile
        steps, launches, ms, peaks = by_k.get(
            k, (0, (0,) * len(LAUNCH_KEYS), [], []))
        by_k[k] = (steps + 1, tuple(a + b for a, b in zip(launches, n)),
                   ms + [1e3 * s], peaks + [peak])
    loss = [h["loss"] for h in trainer.history]
    print(f"[data-exact] {card}: " + "; ".join(
        f"K={k} on the {engines[k]} engine: {n} steps, launches "
        f"{dict(zip(LAUNCH_KEYS, launches))}, median "
        f"{statistics.median(ms):.3f} ms per step (min {min(ms):.3f}, max "
        f"{max(ms):.3f}, host clock), peak allocated {max(peaks):.1f} MiB"
        for k, (n, launches, ms, peaks) in by_k.items())
        + f"; loss {[round(x, 5) for x in loss]}")
    passes = cfg.tail_passes + 1
    n512, l512 = by_k[512][:2]
    n256, l256 = by_k[256][:2]
    _check((n512, n256) == (EXACT_DATA_WARMUP_UNTIL,
                            EXACT_DATA_STEPS - EXACT_DATA_WARMUP_UNTIL),
           f"exact rehearsal steps per budget {by_k.keys()}")
    _check(l512 == (0,) * len(LAUNCH_KEYS),
           f"K=512 exact steps launch no kernel: {l512}")
    want = _with_prep((0, 0, passes * n256, 0, 0, 0, passes * n256))
    _check(l256 == want, f"K=256 exact steps: launches {l256}, want {want} "
           "(the exact forward and the fast exact backward, fed by the "
           "candidate gather and scatter)")
    _check(len(loss) == EXACT_DATA_STEPS and all(np.isfinite(loss)),
           "exact rehearsal losses finite")
    for part in ("background", "actors"):
        for name, v in getattr(trainer.state.scene, part).params().items():
            _check(bool(torch.isfinite(v).all()),
                   f"exact rehearsal: {part}.{name} finite")
    # The torch engine's K=512 steps leave gigabytes in the allocator's
    # cache: give them back to the card for the later phases' processes.
    del trainer
    torch.cuda.empty_cache()
    return dict(zip(LAUNCH_KEYS, l256))


CLI_ITERATIONS, CLI_RESUMED = 20, 25     # of the rehearsal's 4,000
CLI_TESTING, CLI_WARMUP_UNTIL = 10, 10   # of its 1,000 and 2,000
CLI_EPOCHS, CLI_BATCH = 2, 16            # of its 40 refine epochs; 46 train
# frames in batches of 16 leave a trailing batch of 14.


def cli_phase(tmp: str, card: str, dev) -> dict:
    """Phase 14: the port's CLI on phase 13's Waymo segment under `tmp`:
    `train`, `train --resume`, `eval` with the refined U-Net, in this
    process, with the rehearsal's configs under a child config that cuts
    the depth.  Returns the tracer kernels' launches per CLI command."""
    from lidar_rt_tpu_torch import cli
    from lidar_rt_tpu_torch.eval import lpips
    from lidar_rt_tpu_torch.models import unet
    from lidar_rt_tpu_torch.ops import kernels
    from lidar_rt_tpu_torch.ops import tracer as tracer_lib
    from lidar_rt_tpu_torch.scene import compose
    from lidar_rt_tpu_torch.train import refine
    from lidar_rt_tpu_torch.utils import checkpoint

    data_cfg = "configs/rehearsal/waymo.yaml"
    exp_cfg = os.path.join(tmp, "cli_exp.yaml")
    with open(exp_cfg, "w") as f:
        f.write(f"""# The rehearsal's experiment, its depth cut.
parent_config: configs/rehearsal/exp.yaml
model_dir: "{tmp}/output"
source_dir: "{tmp}/waymo"
testing_iterations: {CLI_TESTING}
saving_iterations: [{CLI_ITERATIONS}]
opt:
  iterations: {CLI_ITERATIONS}
tracer:
  warmup_until: {CLI_WARMUP_UNTIL}
refine:
  epochs: {CLI_EPOCHS}
  batch_size: {CLI_BATCH}
""")
    mdir = os.path.join(tmp, "output", "rehearsal", "exp", "scene_we1")
    log_path = os.path.join(mdir, "logs", "log.json")
    print(f"[cli] reduction: configs/rehearsal/exp.yaml + waymo.yaml with "
          f"{CLI_ITERATIONS} iterations (then a resume to {CLI_RESUMED}) "
          f"of 4000, testing every {CLI_TESTING} of 1000, warmup_until "
          f"{CLI_WARMUP_UNTIL} of 2000, refine {CLI_EPOCHS} epochs of 40 in "
          f"batches of {CLI_BATCH}")
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    runs = {}
    for label, extra in (("train", []), ("resume", [
            "--resume", "--iterations", str(CLI_RESUMED)])):
        trainer, wall = _timed(lambda: cli.main(
            ["train", "-dc", data_cfg, "-ec", exp_cfg, *extra]))
        with open(log_path) as f:
            log = json.load(f)
        runs[label] = (trainer, log)
        secs = ", ".join(f"{k} {v:.2f}" for k, v in log["seconds"].items())
        psnr = [round(e["eval_psnr"], 3) for e in log["eval_history"]]
        print(f"[cli-{label}] {card}: {wall:.2f} s; stages (s, host clock "
              f"to a synchronize): {secs}; {len(log['history'])} history "
              f"entries, held-out PSNR {psnr}, "
              f"{trainer.state.bins.rebins} rebins, "
              f"{int(trainer.state.scene.background.num_alive)} surfels")
    train_launches = _launch_counts()
    trainer, log = runs["resume"]
    _check([h["iteration"] for h in log["history"]]
           == list(range(1, CLI_RESUMED + 1)),
           "log.json holds every iteration of both runs")
    _check(all(np.isfinite(h["loss"]) for h in log["history"]),
           "CLI training losses finite")
    models = os.path.join(mdir, "models")
    names = sorted(os.listdir(models))
    _check(any(n.endswith("_good.npz") for n in names)
           and "unet.npz" in names, f"checkpoints {names}")
    _check(sorted(os.listdir(os.path.join(mdir, "visuals")))
           == [f"it_{i:06d}.png" for i in (10, 20, 25)], "visuals")

    kernels.reset_launches()
    _, eval_wall = _timed(lambda: cli.main(
        ["eval", "-dc", data_cfg, "-ec", exp_cfg, "-t", "test", "-e", "-i",
         "-p"]))
    eval_launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    metrics_dir = os.path.join(mdir, "metrics")
    with open(os.path.join(metrics_dir, "results_all.json")) as f:
        saved = json.load(f)
    frames = trainer.frames
    test_ids = list(frames.eval_frames)
    images = set(os.listdir(os.path.join(metrics_dir, "images")))
    _check(images == {f"{kind}_{f:04d}.{ext}" for f in test_ids
                      for kind, ext in (("frame", "png"), ("gt", "ply"),
                                        ("pred", "ply"))}
           and os.path.exists(os.path.join(metrics_dir, "depth_anim.png")),
           f"eval artifacts {sorted(images)}")
    _check("depth_return2" in saved["mean"], "second-return metrics")
    for where, table in [("mean", saved["mean"])] + [
            (f"frame {f}", t) for f, t in saved["per_frame"].items()]:
        for group, row in table.items():
            for k, v in row.items():
                ok = (v == "unavailable(no-weights)" if where == "mean"
                      else np.isnan(v)) if "lpips" in k else np.isfinite(v)
                _check(bool(ok), f"results_all.json {where} {group}/{k} = "
                       f"{v}")
    mean = saved["mean"]
    print(f"[cli-eval] {card}: {eval_wall:.2f} s for {len(test_ids)} test "
          f"frames with artifacts; metric pass "
          f"{1e3 * saved['eval_seconds'] / len(test_ids):.1f} ms per frame "
          f"(render, U-Net, second return, metrics; host clock); depth "
          f"RMSE {mean['depth']['rmse']:.4f} MedAE "
          f"{mean['depth']['medae']:.4f}, intensity PSNR "
          f"{mean['intensity']['psnr']:.4f}, raydrop F1 "
          f"{mean['raydrop']['f1']:.4f}, Chamfer "
          f"{mean['points']['chamfer_dist']:.4f}, F-score "
          f"{mean['points']['fscore']:.4f}, return-2 MedAE "
          f"{mean['depth_return2']['medae']:.4f}; peak allocated over "
          f"phase 14 {peak:.1f} MiB")

    # The saved checkpoint renders an eval frame as the trainer that saved
    # it does, to the bit.
    f0 = test_ids[0]
    ckpt = next(os.path.join(models, n) for n in names
                if n.startswith(f"ckpt_it_{CLI_RESUMED}"))
    scene, _ = checkpoint.load_scene(ckpt, dev)
    with torch.no_grad():
        bundle, _ = compose(scene, f0)
        reloaded = tracer_lib.render_frame(
            bundle, frames.grid, frames.width, frames.pose(f0),
            scene.background.active_sh_degree, trainer.trace_cfg,
            bool(trainer.args.opt.use_rayhit))
    live = trainer.render_eval(f0)
    # Channels to the bit (each ray's composite runs in one thread);
    # accum is a sum over rays taken with atomics in no fixed order.
    acc_err, acc_ok = _accum_err(reloaded["accum_weights"],
                                 live["accum_weights"])
    _check(torch.equal(reloaded["channels"], live["channels"]) and acc_ok,
           f"{ckpt} renders frame {f0} bit-identically (accum "
           f"{acc_err:.3e})")

    # The U-Net and the LPIPS network on the card against the CPU.
    weights, umeta = checkpoint.load(os.path.join(models, "unet.npz"))
    x, _ = refine.collect_inputs(trainer.render_eval, frames, [f0], True)
    outs = []
    for where in ("cpu", dev):
        net = unet.make_unet(int(umeta["in_ch"]), where)
        net.load_state_dict({k: torch.as_tensor(v)
                             for k, v in weights.items()})
        xw = x[0].to(where)
        outs.append(refine.apply_unet(net, *xw[:3], xw[3:6].permute(1, 2, 0),
                                      xw[6:].permute(1, 2, 0)).cpu())
    unet_err = (outs[1] - outs[0]).abs().max().item()
    gen = torch.Generator().manual_seed(0)
    cpu_lpips = lpips.init_weights(lpips.new_lpips("cpu"), gen)
    card_lpips = lpips.new_lpips(dev)
    card_lpips.load_state_dict(cpu_lpips.state_dict())
    pred = live["intensity"].clamp(0, 1)
    gt = frames.intensity(f0).clamp(0, 1)
    lp_cpu = lpips.make_lpips_fn(cpu_lpips)(pred.cpu(), gt.cpu())
    lp_card, lp_s = _timed(lambda: lpips.make_lpips_fn(card_lpips)(pred, gt))
    print(f"[cli-check] {card}: {os.path.basename(ckpt)} renders frame "
          f"{f0}'s channels bit-identically to the trainer (accum, summed "
          f"with atomics, within {acc_err:.3e}); U-Net (in_ch "
          f"{umeta['in_ch']}, final loss {umeta['final_loss']:.4f}) card vs "
          f"CPU max abs err {unet_err:.3e} (bar 1e-4); LPIPS with seeded "
          f"weights {lp_card:.6f} card vs {lp_cpu:.6f} CPU, abs err "
          f"{abs(lp_card - lp_cpu):.3e} (bar 1e-4), {1e3 * lp_s:.1f} ms on "
          f"the card; launches {LAUNCH_KEYS}: train + resume "
          f"{train_launches}, eval {eval_launches}")
    _check(unet_err <= 1e-4, "U-Net on the card vs the CPU")
    _check(lp_card > 0 and abs(lp_card - lp_cpu) <= 1e-4,
           "LPIPS on the card vs the CPU")
    train_n = dict(zip(LAUNCH_KEYS, train_launches))
    eval_n = dict(zip(LAUNCH_KEYS, eval_launches))
    _check(train_n["fwd_c"] == train_n["bwd_c"] > 0
           and train_n["bwd"] == 0
           and train_n["fwd_x"] == train_n["bwd_x"] == train_n["bwd_xf"] == 0,
           "CLI training: the cached tile-order kernels (the rehearsal's "
           "fast_math), grad-free renders uncached")
    _check(train_launches == _with_prep(train_launches[:7]),
           "CLI training: a candidate gather a pass, a scatter a backward")
    _check(eval_n["fwd"] > 0
           and eval_launches == _with_prep((eval_n["fwd"],) + (0,) * 6),
           "CLI eval: uncached tile-order forwards and their gathers only")
    return {"fwd_paths": {"cli_train": train_n["fwd"],
                          "cli_eval": eval_n["fwd"]},
            "fwd_c_paths": {"cli_train": train_n["fwd_c"]},
            "bwd_c_paths": {"cli_train": train_n["bwd_c"]},
            "prep_g_paths": {"cli_train": train_n["prep_g"],
                             "cli_eval": eval_n["prep_g"]},
            "prep_s_paths": {"cli_train": train_n["prep_s"]}}


SHARDED_STEPS, SHARDED_EXACT_STEPS = 10, 2     # phase 15 (d)
SHARDED_WARMUP_UNTIL = 5                      # of the 10 tile-order steps
SHARDED_DEADLINE_S = 300.0                    # per world
BUNDLE_FIELDS = ("means", "rotations", "scales", "opacities", "sh")
TWIN_GRADS = ("d_axes", "d_plane", "d_inv_scale", "d_opac", "d_sh")


def _waymo_options():
    """The rehearsal's Waymo options for phase 13's 50-frame segment."""
    from lidar_rt_tpu_torch.train import options

    opts = options.rehearsal_options("waymo")
    opts.frame_length = [0, WAYMO_FRAMES - 1]
    return opts


def _rank_inputs(dev: str, w_dir: str, scene_path: str):
    """A phase 15 rank's copy of phase 13's Waymo segment (its loader,
    from the segment's npz cache) and of the assembled scene (its
    checkpoint), on the rank's device, TF32 off as in the parent."""
    from lidar_rt_tpu_torch.data import waymo
    from lidar_rt_tpu_torch.utils import checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frames, _ = waymo.load(w_dir, _waymo_options(), device=dev)
    return frames, checkpoint.load_scene(scene_path, dev)[0]


def _leaf_bundle(scene, frame: int):
    """The scene's render bundle at a frame, each field a leaf that
    requires grad."""
    from lidar_rt_tpu_torch.scene import compose

    with torch.no_grad():
        bundle, _ = compose(scene, frame)
    return type(bundle)(*(x.clone().requires_grad_() for x in bundle))


def _scan_loss(scan: torch.Tensor) -> torch.Tensor:
    return (scan[..., 3] ** 2).sum() * 1e-3 + scan[..., 0].sum()


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _state_digest(trainer) -> str:
    """Digest of every parameter and Adam moment of a trainer's scene."""
    from lidar_rt_tpu_torch.train.optim import GROUPS

    st = trainer.state
    parts = []
    for asset, opt in ((st.scene.background, st.opt_bg),
                       (st.scene.actors, st.opt_actors)):
        if asset is not None:
            for g in GROUPS:
                parts += [asset.params()[g], *opt.moments(g)]
    return _digest(parts)


# The launch counts of `_launch_counts`, in order: tile order, exact order,
# the cached tile order and the exact order's fast sums, then the candidate
# gather and scatter; and their names in `kernels.launch_counts()`.
LAUNCH_KEYS = ("fwd", "bwd", "fwd_x", "bwd_x", "fwd_c", "bwd_c", "bwd_xf",
               "prep_g", "prep_s")
LAUNCH_COUNTERS = ("forward_launches", "backward_launches",
                   "forward_exact_launches", "backward_exact_launches",
                   "forward_cache_launches", "backward_cache_launches",
                   "backward_exact_fast_launches", "prep_gather_launches",
                   "prep_scatter_launches")


def _with_prep(tracer: tuple[int, ...]) -> tuple[int, ...]:
    """The launches by LAUNCH_KEYS of a run that made `tracer`, its
    tracer kernels' (the first seven keys), through the render path: a
    pass gathers its tile inputs once, for its forward launch, and
    scatters once, for its backward launch."""
    f, b, fx, bx, fc, bc, bxf = tracer
    return (*tracer, f + fx + fc, b + bx + bc + bxf)


def _prep_launches(path: str) -> tuple[int, int]:
    """The candidate gather's and scatter's launches since the counters
    were last reset, in the run of `path`; checks that they are one a
    render pass and one a backward launch (`_with_prep`)."""
    n = _launch_counts()
    _check(n == _with_prep(n[:7]), f"{path}: a candidate gather a forward "
           f"and a scatter a backward launch: {dict(zip(LAUNCH_KEYS, n))}")
    return n[7], n[8]


def _launch_counts() -> tuple[int, ...]:
    from lidar_rt_tpu_torch.ops import kernels

    n = kernels.launch_counts()
    return tuple(n[c] for c in LAUNCH_COUNTERS)


def band_rank(mesh, dev: str, w_dir: str, scene_path: str, frame: int,
              seed: int) -> dict:
    """Phase 15 (a) and (b) on one rank of a rays = 2 world: both kernels
    in both orders against their twins on this band's tile inputs (the
    flagship tiling), the exact backward's fast sums too and, on band 0,
    the cached pair (`check_cached_pair`), then the ray-sharded render of
    the band in each
    order with a loss on the gathered scan, its launches counted from 0.
    Returns the errors, the launches and a digest of the bundle's
    gradients; band 0 also the cached pair's errors and report and the
    gathered scans, accums and gradients."""
    from lidar_rt_tpu_torch.ops import cuda_tracer, kernels, tracer
    from lidar_rt_tpu_torch.parallel import gather_bands, trace_ray_sharded
    from lidar_rt_tpu_torch.parallel.sharding import band_columns

    frames, scene = _rank_inputs(dev, w_dir, scene_path)
    grid, width, pose = frames.grid, frames.width, frames.pose(frame)
    degree = scene.background.active_sh_degree
    col_offset, band_w = band_columns(width, mesh)
    cfg = tracer.TraceConfig()
    out = {"band": (col_offset, band_w)}
    gen = torch.Generator(device=dev).manual_seed(seed + mesh.band)
    with torch.no_grad():
        inputs, asg = cuda_tracer.tile_inputs(
            _leaf_bundle(scene, frame), grid, width, pose, degree, cfg.tile,
            col_offset=col_offset, render_width=band_w)
        out["tiles"] = (tuple(inputs.dirs.shape[:2]),
                        inputs.cnt.float().mean().item(),
                        int((asg.truncated > 0).sum()))
        for exact in (False, True):
            chans, accum = kernels.tracer_forward(*inputs, exact=exact)
            ref_c, ref_a = cuda_tracer.forward_tiles_reference(*inputs,
                                                               exact=exact)
            g = torch.randn(chans.shape, generator=gen, device=dev)
            g[:, 9:] = 0.0     # raw T: never read by the training loss
            grads = kernels.tracer_backward(*inputs, chans, g, exact=exact)
            ref_g = cuda_tracer.backward_tiles_reference(*inputs, chans, g,
                                                         exact=exact)
            out["twin", exact] = (
                (chans - ref_c).abs().max().item(), *_accum_err(accum, ref_a),
                _grad_errors(grads, ref_g, TWIN_GRADS),
                max((a - b).abs().max().item() for a, b in zip(grads, ref_g)))
            if exact:
                # The sharded trainer's exact order runs the fast sums.
                fast = kernels.tracer_backward(*inputs, chans, g, exact=True,
                                               fast=True)
                out["fast_sums"] = (
                    _grad_errors(fast, ref_g, TWIN_GRADS),
                    max((a - b).abs().max().item()
                        for a, b in zip(fast, ref_g)))
                del fast
            elif mesh.band == 0:
                # Its tile order trains cached: the pair on this band.
                pair = check_cached_pair(
                    inputs, chans, accum, g, f"band {mesh.band}",
                    lambda line: print(f"[sharded-cache] {line}",
                                       flush=True))
                out["cached"] = (pair["fwd_err"], pair["bwd_err"])
                del pair
            del chans, accum, ref_c, ref_a, g, grads, ref_g
        del inputs, asg
    torch.cuda.synchronize()

    background = torch.tensor([0.0, 0.0, 1.0], device=dev)
    kernels.reset_launches()
    runs = {}
    for exact in (False, True):
        bundle = _leaf_bundle(scene, frame)
        o = trace_ray_sharded(bundle, grid, width, pose, background, degree,
                              dataclasses.replace(cfg, exact_order=exact),
                              mesh)
        scan = gather_bands(o.channels, mesh)
        _scan_loss(scan).backward()
        runs[exact] = (scan.detach(), o.accum_weights,
                       [x.grad for x in bundle])
    torch.cuda.synchronize()
    out["launches"] = _launch_counts()
    out["digest"] = {exact: _digest(r[2]) for exact, r in runs.items()}
    if mesh.band == 0:
        out["runs"] = runs
    return out


def train_rank(mesh, dev: str, w_dir: str, scene_path: str, seed: int
               ) -> dict:
    """Phase 15 (d) on one rank of a dp = 2 x rays = 2 world: the
    `ShardedTrainer` for SHARDED_STEPS steps with the rehearsal's tracer
    settings (K = 512 until SHARDED_WARMUP_UNTIL, then K = 256; one tail
    pass), then from the same scene SHARDED_EXACT_STEPS in exact order at
    K = 256.  Per run: losses, each step's frames, a digest of the state,
    launches counted from 0, host ms per step, and the collectives' bytes
    and ms per step."""
    from lidar_rt_tpu_torch.ops import kernels
    from lidar_rt_tpu_torch.parallel import ShardedTrainer
    from lidar_rt_tpu_torch.train import options

    frames, scene = _rank_inputs(dev, w_dir, scene_path)
    opts = _waymo_options()
    cfg, warm, _ = options.trace_configs(opts)
    out = {}
    for label, kw, steps in (
            ("tile", dict(trace_cfg=cfg, warmup_cfg=warm,
                          warmup_until=SHARDED_WARMUP_UNTIL), SHARDED_STEPS),
            ("exact", dict(trace_cfg=dataclasses.replace(cfg,
                                                         exact_order=True)),
             SHARDED_EXACT_STEPS)):
        trainer = ShardedTrainer(scene, frames, opts, mesh, seed=seed, **kw)
        kernels.reset_launches()
        bytes0, secs0 = mesh.collective_bytes, mesh.collective_s
        ms = []
        for _ in range(steps):
            _, s = _timed(lambda: trainer.run(1, log_every=1))
            ms.append(1e3 * s)
        out[label] = {
            "loss": [h["loss"] for h in trainer.history],
            "frames": [h["frame"] for h in trainer.history],
            "digest": _state_digest(trainer), "launches": _launch_counts(),
            "ms": ms, "rebins": trainer.state.bins.rebins,
            "bytes": (mesh.collective_bytes - bytes0) / steps,
            "collective_ms": 1e3 * (mesh.collective_s - secs0) / steps}
        del trainer
    return out


def _param_grads(state) -> tuple[list[str], list[torch.Tensor]]:
    """Every parameter's gradient in a train state (zeros where none)."""
    names, grads = [], []
    for part in ("background", "actors"):
        asset = getattr(state.scene, part)
        if asset is not None:
            for group, p in asset.params().items():
                names.append(f"{part}.{group}")
                grads.append(torch.zeros_like(p) if p.grad is None
                             else p.grad)
    return names, grads


def _field_errors(got, want, names) -> dict[str, tuple[float, float]]:
    """`_grad_errors`, where a field that is zero in `want` must be zero
    in `got` too (the SH rest coefficients at degree 0, for one): (1, 0)
    if it is, (0, inf) if not."""
    out = {}
    for name, a, b in zip(names, got, want):
        if not bool(b.any()):
            out[name] = (1.0, 0.0) if not bool(a.any()) else (0.0, np.inf)
        else:
            out.update(_grad_errors([a], [b], [name]))
    return out


def paired_trainer(scene, frames, opts, **kw):
    """A `Trainer` each of whose steps is paired with a 1 x 1 sharded step
    (`make_sharded_train_step`) from a copy of the state before it, on the
    same frame and bins.  Its `pairs` hold per step (plain loss, sharded
    loss, the sharded gradients' `_field_errors` against the plain ones,
    both read before the optimizer steps).  The plain state takes only
    the plain steps."""
    import copy

    from lidar_rt_tpu_torch.parallel import make_mesh
    from lidar_rt_tpu_torch.parallel.train_step import \
        make_sharded_train_step
    from lidar_rt_tpu_torch.train import loop

    class Paired(loop.Trainer):
        def _make_step(self, cfg):
            plain = super()._make_step(cfg)
            sharded = make_sharded_train_step(self.frames, self.args, cfg,
                                              make_mesh(), self.rebin_every)

            def step(state, batch):
                twin = loop.init_train_state(state.scene, self.args.opt)
                twin.bins = copy.deepcopy(state.bins)
                state, metrics = plain(state, batch)
                twin, twin_metrics = sharded(
                    twin, loop.frame_batch(self.frames, [batch.frame]))
                names, want = _param_grads(state)
                self.pairs.append((
                    float(metrics["loss"]), float(twin_metrics["loss"]),
                    _field_errors(_param_grads(twin)[1], want, names)))
                return state, metrics

            return step

    trainer = Paired(scene, frames, opts, **kw)
    trainer.pairs = []
    return trainer


def sharded_phase(tmp: str, card: str, dev, seed: int) -> dict:
    """Phase 15: the scale-out path on the card, from phase 13's Waymo
    segment under `tmp`, its scene assembled again and handed to the ranks
    as a checkpoint.  Ranks are processes sharing this one card through
    gloo (NCCL takes a card per rank).  Returns each kernel's launches on
    the sharded paths and the band kernels' largest errors."""
    from lidar_rt_tpu_torch.data import build, waymo
    from lidar_rt_tpu_torch.ops import kernels, tracer
    from lidar_rt_tpu_torch.parallel import (ShardedTrainer, make_mesh,
                                             run_world)
    from lidar_rt_tpu_torch.train import loop, options
    from lidar_rt_tpu_torch.utils import checkpoint

    w_dir = os.path.join(tmp, "waymo")
    opts = _waymo_options()
    frames, tracks = waymo.load(w_dir, opts, device=dev)
    scene = build.assemble_scene(
        frames, tracks, opts, torch.Generator(device=dev).manual_seed(seed))
    scene_path = os.path.join(tmp, "sharded_scene.npz")
    checkpoint.save(scene_path, scene)
    frame = frames.train_frames[0]
    launches = collections.Counter()

    # (a), (b): a rays = 2 world.
    rank_dev = str(dev)      # every rank on this process's card
    bands, world_s = _timed(lambda: run_world(
        band_rank, 1, 2, "gloo", device=rank_dev,
        timeout_s=SHARDED_DEADLINE_S,
        args=(rank_dev, w_dir, scene_path, frame, seed)))
    out = {"fwd_err": 0.0, "bwd_err": 0.0, "fwd_x_err": 0.0,
           "bwd_x_err": 0.0, "bwd_xf_err": 0.0}
    for r in bands:
        (t, rays), cand, trunc = r["tiles"]
        for exact in (False, True):
            c_err, a_err, a_ok, g_err, g_abs = r["twin", exact]
            order = "exact" if exact else "tile"
            print(f"[sharded-band] band {r['band']} (offset, columns) of "
                  f"{frames.width}, frame {frame}: T={t} R={rays} K="
                  f"{tracer.FLAGSHIP_TILE.max_per_tile}, {cand:.1f} "
                  f"candidates/tile, {trunc} tiles truncated; {order} "
                  f"order, kernels vs twins: channels max abs err "
                  f"{c_err:.3e} (bar {CHAN_ATOL}), accum {a_err:.3e}; "
                  f"backward {_fmt_grads(g_err)}")
            _check(c_err <= CHAN_ATOL and a_ok,
                   f"band {r['band']} {order} forward kernel vs twin")
            _check_grads(g_err, f"band {r['band']} {order} backward kernel "
                         "vs twin")
            key = "_x" if exact else ""
            out[f"fwd{key}_err"] = max(out[f"fwd{key}_err"], c_err)
            out[f"bwd{key}_err"] = max(out[f"bwd{key}_err"], g_abs)
        f_err, f_abs = r["fast_sums"]
        print(f"[sharded-band] band {r['band']}: exact backward, fast sums, "
              f"vs its twin: {_fmt_grads(f_err)} (bars: cosine >= "
              f"{FAST_COS}, err <= {FAST_REL} x max|ref|)")
        _check(all(cos >= FAST_COS and rel <= FAST_REL
                   for cos, rel in f_err.values()),
               f"band {r['band']} exact fast sums vs twin: {f_err}")
        out["bwd_xf_err"] = max(out["bwd_xf_err"], f_abs)
        launches.update(dict(zip(LAUNCH_KEYS, r["launches"])))
    # Checked and reported in the rank: a failed check raises there.
    out["fwd_c_err"], out["bwd_c_err"] = bands[0]["cached"]
    _check(bands[0]["digest"] == bands[1]["digest"],
           "both ranks hold the same bundle gradients")
    _check(all(tuple(r["launches"]) == _with_prep((1, 1, 1, 1, 0, 0, 0))
               for r in bands),
           f"one launch of each kernel per rank and order, a candidate "
           f"gather and scatter with each: {[r['launches'] for r in bands]}")

    # The same bands rendered in this process, one after the other.
    background = torch.tensor([0.0, 0.0, 1.0], device=dev)
    degree = scene.background.active_sh_degree
    band_w = frames.width // 2
    for exact in (False, True):
        bundle = _leaf_bundle(scene, frame)
        cfg = tracer.TraceConfig(exact_order=exact)
        parts = [tracer.trace(bundle, frames.grid, frames.width,
                              frames.pose(frame), background, degree, cfg,
                              col_offset=c, render_width=band_w)
                 for c in (0, band_w)]
        scan = torch.cat([p.channels for p in parts], 1)
        _scan_loss(scan).backward()
        got_scan, got_accum, got_grads = bands[0]["runs"][exact]
        same = torch.equal(torch.as_tensor(got_scan).to(dev), scan.detach())
        acc_err, acc_ok = _accum_err(
            torch.as_tensor(got_accum).to(dev),
            parts[0].accum_weights + parts[1].accum_weights)
        g_err = _grad_errors([torch.as_tensor(g).to(dev) for g in got_grads],
                             [x.grad for x in bundle], BUNDLE_FIELDS)
        order = "exact" if exact else "tile"
        print(f"[sharded-render] {card}: trace_ray_sharded, 2 ranks sharing "
              f"the card (gloo), {order} order, gathered {tuple(scan.shape)}"
              f" vs this process's two band traces: channels "
              f"{'bit-identical' if same else 'DIFFER'}, accum max abs err "
              f"{acc_err:.3e}; bundle gradients of a loss on the scan, "
              f"summed over the bands: {_fmt_grads(g_err)}")
        _check(same, f"{order} gathered bands vs one-process band traces")
        _check(acc_ok, f"{order} sharded accum vs one-process band accums")
        _check_grads(g_err, f"{order} ray-sharded gradients")
        del bundle, parts, scan
    print(f"[sharded-render] {card}: rays = 2 world {world_s:.2f} s (2 "
          f"processes: start, load the segment and the scene, twins, "
          f"renders)")

    # (c): a 1 x 1 mesh against the plain trainer.  Before each of the
    # plain trainer's 20 rehearsal steps, a copy of its state takes the
    # sharded step on the same frame and bins: the step's loss must agree
    # to 1e-6 and its gradients, before the optimizer, at the gradient
    # bars.  (The kernels and the gathers' backward sum with atomics in no
    # fixed order, and Adam's eps 1e-15 turns a noise-sized gradient into
    # a whole lr-sized step, so two runs of one trainer part after the
    # first step: the updated parameters are not compared.)  Then the
    # 20-step trajectories: three Trainer runs measure how far runs part,
    # and the ShardedTrainer's losses are held to 2e-3 or twice the
    # largest gap between two of them, whichever is larger.
    cfg, warm, _ = options.trace_configs(opts)
    kw = dict(trace_cfg=cfg, warmup_cfg=warm,
              warmup_until=DATA_WARMUP_UNTIL, seed=seed)
    paired = paired_trainer(scene, frames, opts, **kw)
    paired.run(DATA_TRAIN_STEPS, log_every=DATA_TRAIN_STEPS)
    loss_rel = [abs(sh - pl) / abs(pl) for pl, sh, _ in paired.pairs]
    worst = {}
    for _, _, errors in paired.pairs:
        for name, (cos, rel) in errors.items():
            c0, r0 = worst.get(name, (1.0, 0.0))
            worst[name] = (min(c0, cos), max(r0, rel))
    print(f"[sharded-1x1] {card}: {len(paired.pairs)} rehearsal steps, each "
          f"a plain step and a 1x1 sharded step from one state (same frame "
          f"and bins): loss max rel diff {max(loss_rel):.3e} (bar 1e-6); "
          f"gradients before the optimizer, worst over the steps: "
          f"{_fmt_grads(worst)} (bars: cosine > {GRAD_COS}, err <= "
          f"{GRAD_REL} x max|plain|)")
    _check(len(paired.pairs) == DATA_TRAIN_STEPS
           and max(loss_rel) <= 1e-6, "1x1 sharded step losses vs Trainer")
    for i, (_, _, errors) in enumerate(paired.pairs):
        _check_grads(errors, f"1x1 sharded step {i + 1} gradients vs "
                     "Trainer")
    del paired
    results = {}
    for label in ("Trainer", "Trainer again", "Trainer third",
                  "ShardedTrainer 1x1"):
        trainer = (ShardedTrainer(scene, frames, opts, make_mesh(), **kw)
                   if label.startswith("Sharded")
                   else loop.Trainer(scene, frames, opts, **kw))
        kernels.reset_launches()
        ms = [1e3 * _timed(lambda: trainer.run(1, log_every=1))[1]
              for _ in range(DATA_TRAIN_STEPS)]
        results[label] = (np.array([h["loss"] for h in trainer.history]),
                          ms, _launch_counts())
        del trainer
    *runs, (loss, ms, one) = results.values()
    ref, ref_ms = runs[0][0], runs[0][1]
    spread = max(float(np.max(np.abs(a[0] - b[0]) / np.abs(ref)))
                 for i, a in enumerate(runs) for b in runs[i + 1:])
    rel = np.abs(loss - ref) / np.abs(ref)
    bar = max(2e-3, 2.0 * spread)
    print(f"[sharded-1x1] {card}: {DATA_TRAIN_STEPS} rehearsal steps "
          f"(K=512 to {DATA_WARMUP_UNTIL}, one tail pass): ShardedTrainer "
          f"on a 1x1 mesh median {statistics.median(ms):.3f} ms per step "
          f"(min {min(ms):.3f}, max {max(ms):.3f}) vs Trainer "
          f"{statistics.median(ref_ms):.3f} (min {min(ref_ms):.3f}, max "
          f"{max(ref_ms):.3f}), host clock; losses: step 1 rel diff "
          f"{rel[0]:.3e} (bar 1e-6), max rel diff {rel.max():.3e} (bar "
          f"{bar:.3e}: 2e-3 or twice the {spread:.3e} between the farthest "
          f"two of three runs of the Trainer); launches {one}")
    for label, (traj, _, _) in results.items():
        print(f"[sharded-1x1]   {label} loss "
              f"{[round(float(x), 5) for x in traj]}")
    _check(spread <= 5e-2, "three runs of the Trainer stay within 5e-2")
    _check(bool(np.isfinite(loss).all()) and rel[0] <= 1e-6
           and rel.max() <= bar, "1x1 ShardedTrainer losses vs Trainer")
    _check(one[4] == one[5] > 0 and one[1] == one[3] == one[6] == 0
           and one == _with_prep(one[:7]),
           f"1x1: the rehearsal's settings train cached, a candidate gather "
           f"a pass and a scatter a backward: {one}")
    launches.update(dict(zip(LAUNCH_KEYS, one)))

    # (d): a dp = 2 x rays = 2 world.
    ranks, world_s = _timed(lambda: run_world(
        train_rank, 2, 2, "gloo", device=rank_dev,
        timeout_s=SHARDED_DEADLINE_S,
        args=(rank_dev, w_dir, scene_path, seed)))
    for label in ("tile", "exact"):
        runs = [r[label] for r in ranks]
        first = runs[0]
        same = all(r["digest"] == first["digest"] and r["loss"] == first["loss"]
                   and r["frames"] == first["frames"] for r in runs)
        ms = [statistics.median(r["ms"]) for r in runs]
        print(f"[sharded-2x2] {card}: 4 ranks share this one card (gloo, "
              f"dp=2 x rays=2): no scaling figure.  {label} order, "
              f"{len(first['loss'])} steps: rows of frames "
              f"{first['frames']}; loss {[round(x, 5) for x in first['loss']]};"
              f" median ms per step per rank {[round(x, 3) for x in ms]} "
              f"(host clock); all-reduced per step "
              f"{first['bytes'] / 2 ** 20:.1f} MiB per rank in "
              f"{statistics.mean(r['collective_ms'] for r in runs):.3f} ms "
              f"(mean over ranks, staged through pinned host memory); "
              f"{first['rebins']} rebins; parameters and Adam moments "
              f"{'bit-identical' if same else 'DIFFER'} on the 4 ranks; "
              f"launches per rank {[r['launches'] for r in runs]}")
        _check(same, f"2x2 {label}: every rank holds the same state")
        _check(all(np.isfinite(first["loss"])), f"2x2 {label}: losses finite")
        _check(all(len(set(row)) == 2 for row in first["frames"]),
               f"2x2 {label}: distinct frames in each step's dp rows")
        n = 2 * len(first["loss"])       # two passes a step
        # The rehearsal's fast_math: tile order trains cached, exact order
        # uncached with the fast sums.
        want = _with_prep((0, 0, 0, 0, n, n, 0) if label == "tile"
                          else (0, 0, n, 0, 0, 0, n))
        _check(all(tuple(r["launches"]) == want for r in runs),
               f"2x2 {label}: launches per rank, want {want}")
        for r in runs:
            launches.update(dict(zip(LAUNCH_KEYS, r["launches"])))
    print(f"[sharded-2x2] {card}: world {world_s:.2f} s (4 processes: "
          f"start, load, {SHARDED_STEPS} + {SHARDED_EXACT_STEPS} steps)")
    out["launches"] = dict(launches)
    return out


ROUNDTRIP_FINETUNE = 10     # of the 200 configs/rehearsal/import_rt.yaml
# fine-tunes, from phase 14's iteration 25 in place of a 4,000-step run.


def import_phase(tmp: str, card: str, dev) -> dict:
    """Phase 17: the reference-checkpoint workflow on phase 14's
    checkpoint under `tmp`: `python -m
    lidar_rt_tpu_torch.scripts.import_roundtrip` (export to a reference
    `.pth`, the import command, `cli train --resume` for
    ROUNDTRIP_FINETUNE steps, `cli eval -t all -e`, each a child process
    on this card).  Holds the imported scene's render of an eval frame to
    the source checkpoint's, checks the children's launches and that
    every metric is finite; prints each stage's seconds and peak memory.
    Returns the tracer kernels' launches in the fine-tune and the eval."""
    from lidar_rt_tpu_torch.data import waymo
    from lidar_rt_tpu_torch.ops import tracer as tracer_lib
    from lidar_rt_tpu_torch.scene import compose
    from lidar_rt_tpu_torch.train import options
    from lidar_rt_tpu_torch.utils import checkpoint

    src = os.path.join(tmp, "output", "rehearsal", "exp", "scene_we1",
                       "models")
    out_dir = os.path.join(tmp, "import_rt")
    exp_cfg = os.path.join(tmp, "import_rt_exp.yaml")
    with open(exp_cfg, "w") as f:
        f.write(f"""# The round trip's experiment, on phase 13's segment.
parent_config: configs/rehearsal/import_rt.yaml
model_dir: "{tmp}/output"
source_dir: "{tmp}/waymo"
tracer:
  warmup_until: {CLI_WARMUP_UNTIL}
""")
    print(f"[import] reduction: configs/rehearsal/import_rt.yaml imports "
          f"phase 14's checkpoint (iteration {CLI_RESUMED}) in place of a "
          f"4,000-step one and fine-tunes {ROUNDTRIP_FINETUNE} steps in "
          f"place of 200, warmup_until {CLI_WARMUP_UNTIL} of 2000")
    log_path = os.path.join(tmp, "import_rt.log")
    cmd = [sys.executable, "-m", "lidar_rt_tpu_torch.scripts.import_roundtrip",
           "--src", src, "-dc", "configs/rehearsal/waymo.yaml", "-ec",
           exp_cfg, "--out", out_dir, "--finetune", str(ROUNDTRIP_FINETUNE)]
    with open(log_path, "w") as log:
        proc, wall = _timed(lambda: subprocess.run(
            cmd, stdout=log, stderr=subprocess.STDOUT))
    if proc.returncode != 0:
        with open(log_path) as log:
            print(log.read()[-6000:])
        _check(False, f"import_roundtrip exited {proc.returncode}")
    with open(os.path.join(out_dir, "import_rt.json")) as f:
        rec = json.load(f)
    fine, ev = rec["finetune"], rec["eval"]
    secs = ", ".join(f"{k} {v:.2f}" for k, v in fine["seconds"].items())

    def mib(x):
        return "not measured" if x is None else f"{x:.1f} MiB"

    print(f"[import] {card}: round trip {wall:.2f} s; export "
          f"{rec['export']['asset_sizes']} surfels per asset at iteration "
          f"{rec['export']['iteration']}; import {rec['import_s']:.2f} s, "
          f"fine-tune {rec['finetune_s']:.2f} s (iterations "
          f"{fine['iterations']}; stages: {secs}; peak allocated "
          f"{mib(fine['peak_mib'])}), eval {rec['eval_s']:.2f} s "
          f"({ev['num_frames']} frames, metric pass "
          f"{1e3 * ev['eval_seconds'] / ev['num_frames']:.1f} ms per frame, "
          f"peak allocated {mib(ev['peak_mib'])}); process wall times on "
          f"the host clock; the import's peak not measured")
    _check(rec["export"]["iteration"] == CLI_RESUMED
           and fine["iterations"] == [CLI_RESUMED + 1,
                                      CLI_RESUMED + ROUNDTRIP_FINETUNE],
           f"round trip from iteration {CLI_RESUMED}: {fine['iterations']}")
    f_n = tuple(fine["launches"][c] for c in LAUNCH_COUNTERS)
    e_n = tuple(ev["launches"][c] for c in LAUNCH_COUNTERS)
    print(f"[import] launches {LAUNCH_KEYS}: fine-tune {f_n}, eval {e_n}")
    passes = 2        # the rehearsal's one tail pass
    _check(f_n[4] == f_n[5] == passes * ROUNDTRIP_FINETUNE
           and f_n[1] == f_n[2] == f_n[3] == f_n[6] == 0 and f_n[0] > 0
           and f_n == _with_prep(f_n[:7]),
           "fine-tune: the cached pair per pass and step (the rehearsal's "
           "fast_math), its periodic eval uncached, a candidate gather a "
           "pass and a scatter a backward")
    _check(e_n[0] > 0 and e_n == _with_prep((e_n[0],) + (0,) * 6),
           "eval: uncached tile-order forwards and their gathers only")
    for group, row in rec["metrics_mean"].items():
        for k, v in row.items():
            ok = (v == "unavailable(no-weights)" if "lpips" in k
                  else np.isfinite(v))
            _check(bool(ok), f"import_rt.json metrics_mean {group}/{k} = {v}")

    # The imported scene renders an eval frame as the exported one does.
    opts = _waymo_options()
    frames, _ = waymo.load(os.path.join(tmp, "waymo"), opts, device=dev)
    cfg = options.trace_configs(opts)[0]
    f0 = frames.eval_frames[0]
    renders = []
    for path in (rec["export"]["src_ckpt"], rec["imported_ckpt"]):
        scene, _ = checkpoint.load_scene(path, dev)
        with torch.no_grad():
            bundle, _ = compose(scene, f0)
            renders.append(tracer_lib.render_frame(
                bundle, frames.grid, frames.width, frames.pose(f0),
                scene.background.active_sh_degree, cfg,
                bool(opts.opt.use_rayhit))["channels"])
        del scene, bundle
    err = (renders[1] - renders[0]).abs().max().item()
    print(f"[import] {card}: the imported scene renders eval frame {f0} "
          f"{'bit-identically to' if torch.equal(*renders) else 'beside'} "
          f"the source checkpoint: channels max abs err {err:.3e} (bar "
          f"{CHAN_ATOL}); mean metrics: depth RMSE "
          f"{rec['metrics_mean']['depth']['rmse']:.4f}, intensity PSNR "
          f"{rec['metrics_mean']['intensity']['psnr']:.4f}, raydrop F1 "
          f"{rec['metrics_mean']['raydrop']['f1']:.4f}")
    _check(err <= CHAN_ATOL, "imported scene's render vs the source's")
    return {"fine": dict(zip(LAUNCH_KEYS, f_n)),
            "eval": dict(zip(LAUNCH_KEYS, e_n))}


RUNNER_TESTING = 5         # phase 18: four held-out evals in 20 steps, so
# that the record's steady-state rate has stamps to span.
RUNNER_SPLIT = 10          # phase 18's split run: 10 + 10 steps


def runner_phase(tmp: str, card: str) -> dict:
    """Phase 18: the rehearsal runner (`python -m
    lidar_rt_tpu_torch.scripts.e2e_rehearsal train|eval {waymo|kitti}`,
    then `collect`, each a child process whose `cli` runs are its own
    children on this card) on phase 13's two datasets under `tmp`, at
    phase 14's reduced depth.  Checks that the record's keys are
    E2E_r05.json's (plus the card), that every metric, held-out PSNR and
    final loss is finite, and the children's launches; prints each stage's
    seconds.  Returns the tracer kernels' launches per command."""
    exp_cfg = os.path.join(tmp, "runner_exp.yaml")
    with open(exp_cfg, "w") as f:
        f.write(f"""# The rehearsal's experiment, its depth cut as phase 14's.
parent_config: "{os.path.abspath('configs/rehearsal/exp.yaml')}"
testing_iterations: {RUNNER_TESTING}
saving_iterations: [{CLI_ITERATIONS}]
opt:
  iterations: {CLI_ITERATIONS}
tracer:
  warmup_until: {CLI_WARMUP_UNTIL}
refine:
  epochs: {CLI_EPOCHS}
  batch_size: {CLI_BATCH}
""")
    out = os.path.join(tmp, "rehearsal")
    log_path = os.path.join(tmp, "runner.log")
    print(f"[runner] reduction: configs/rehearsal/exp.yaml with "
          f"{CLI_ITERATIONS} iterations of 4000, held-out PSNR every "
          f"{RUNNER_TESTING} of 1000, warmup_until {CLI_WARMUP_UNTIL} of "
          f"2000, refine {CLI_EPOCHS} epochs of 40 in batches of "
          f"{CLI_BATCH}; phase 13's Waymo segment and KITTI-360 sequence "
          f"at their full shapes")
    secs = {}
    for cmd in (("train", "waymo"), ("eval", "waymo"), ("train", "kitti"),
                ("eval", "kitti"), ("collect",)):
        with open(log_path, "a") as log:
            proc, secs[" ".join(cmd)] = _timed(lambda: subprocess.run(
                [sys.executable, "-m",
                 "lidar_rt_tpu_torch.scripts.e2e_rehearsal", *cmd, "--data",
                 tmp, "--out", out, "-ec", exp_cfg],
                stdout=log, stderr=subprocess.STDOUT))
        if proc.returncode != 0:
            with open(log_path) as log:
                print(log.read()[-6000:])
            _check(False, f"e2e_rehearsal {' '.join(cmd)} exited "
                   f"{proc.returncode}")
    with open(os.path.join(out, "e2e_torch.json")) as f:
        rec = json.load(f)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "E2E_r05.json")) as f:
        ref = json.load(f)
    _check(set(rec) == set(ref) | {"card"} and rec["card"] == card
           and set(rec["results"]) == set(ref["results"]),
           f"record keys {sorted(rec)}, datasets {sorted(rec['results'])}")
    launches = {}
    for key, scene_id in (("waymo", "we1"), ("kitti360", "ke1")):
        got, want = rec["results"][key], ref["results"][key]
        _check(set(got) == set(want), f"{key} record keys {sorted(got)}, "
               f"want {sorted(want)}")
        _check({g: set(r) for g, r in got["metrics_mean"].items()}
               == {g: set(r) for g, r in want["metrics_mean"].items()},
               f"{key} metric names")
        for group, row in got["metrics_mean"].items():
            for k, v in row.items():
                ok = (v == "unavailable(no-weights)" if "lpips" in k
                      else np.isfinite(v))
                _check(bool(ok), f"{key} metrics_mean {group}/{k} = {v}")
        hist = got["eval_history"]
        _check([e["iteration"] for e in hist]
               == list(range(RUNNER_TESTING, CLI_ITERATIONS + 1,
                             RUNNER_TESTING))
               and all(set(e) == set(want["eval_history"][0])
                       and np.isfinite(e["eval_psnr"]) for e in hist)
               and np.isfinite(got["final_loss"])
               and got["iterations_recorded"] == CLI_ITERATIONS
               and got["steady_state_it_per_s"] > 0,
               f"{key}: eval history {hist}, final loss "
               f"{got['final_loss']}")
        mdir = os.path.join(out, "exp", f"scene_{scene_id}")
        with open(os.path.join(mdir, "logs", "log.json")) as f:
            t_n = json.load(f)["launches"]
        with open(os.path.join(mdir, "metrics", "results_all.json")) as f:
            e_n = json.load(f)["launches"]
        t_n = dict(zip(LAUNCH_KEYS, (t_n[c] for c in LAUNCH_COUNTERS)))
        e_n = dict(zip(LAUNCH_KEYS, (e_n[c] for c in LAUNCH_COUNTERS)))
        _check(t_n["fwd_c"] == t_n["bwd_c"] == 2 * CLI_ITERATIONS
               and t_n["fwd"] > 0 and t_n["bwd"] == t_n["fwd_x"]
               == t_n["bwd_x"] == t_n["bwd_xf"] == 0
               and tuple(t_n.values()) == _with_prep(
                   tuple(t_n.values())[:7]),
               f"runner train {key}: the cached pair per pass and step "
               f"(one tail pass), evals uncached, a candidate gather a "
               f"pass and a scatter a backward: {t_n}")
        _check(e_n["fwd"] > 0 and tuple(e_n.values())
               == _with_prep((e_n["fwd"],) + (0,) * 6),
               f"runner eval {key}: uncached tile-order forwards and their "
               f"gathers: {e_n}")
        launches[key] = (t_n, e_n)
        mean = got["metrics_mean"]
        print(f"[runner] {card}: {key}: held-out PSNR "
              f"{[round(e['eval_psnr'], 3) for e in hist]}, alive "
              f"{[e['alive'] for e in hist]}, final loss "
              f"{got['final_loss']:.5f}, {got['steady_state_it_per_s']} it/s "
              f"(host clock); depth PSNR {mean['depth']['psnr']:.4f}, "
              f"MedAE {mean['depth']['medae']:.4f}, intensity PSNR "
              f"{mean['intensity']['psnr']:.4f}, raydrop F1 "
              f"{mean['raydrop']['f1']:.4f}, Chamfer "
              f"{mean['points']['chamfer_dist']:.4f}, F-score "
              f"{mean['points']['fscore']:.4f}; launches {LAUNCH_KEYS}: "
              f"train {tuple(t_n.values())}, eval {tuple(e_n.values())}")
    split = split_run(tmp, exp_cfg, log_path, card)
    secs["train kitti --split"] = split.pop("seconds")
    print(f"[runner] {card}: stage seconds (child processes, host clock): "
          + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
          + "; the record's keys are E2E_r05.json's and the card's")
    launches["kitti360_split"] = (split["launches"], None)
    return {
        "fwd_paths": {f"runner_{stage}_{key}": n[i]["fwd"]
                      for key, n in launches.items()
                      for i, stage in enumerate(("train", "eval"))
                      if n[i] is not None},
        "fwd_c_paths": {f"runner_train_{key}": n[0]["fwd_c"]
                        for key, n in launches.items()},
        "bwd_c_paths": {f"runner_train_{key}": n[0]["bwd_c"]
                        for key, n in launches.items()},
        "prep_g_paths": {f"runner_{stage}_{key}": n[i]["prep_g"]
                         for key, n in launches.items()
                         for i, stage in enumerate(("train", "eval"))
                         if n[i] is not None},
        "prep_s_paths": {f"runner_train_{key}": n[0]["prep_s"]
                         for key, n in launches.items()}}


def split_run(tmp: str, exp_cfg: str, log_path: str, card: str) -> dict:
    """Phase 18's split run: `e2e_rehearsal train kitti --split
    RUNNER_SPLIT` on phase 18's reduced config, densifying every 5 steps
    from the start, under its own --out.  Checks that log.json is one
    contiguous run (history 1-20, held-out evals every RUNNER_TESTING,
    one densify event every 5 steps), that only the last chunk refined
    and that each chunk ran the cached pair per pass and step.  Returns
    the command's seconds and the train's launches."""
    split_cfg = os.path.join(tmp, "runner_split_exp.yaml")
    with open(split_cfg, "w") as f:
        f.write(f"""# Phase 18's config, densifying every 5 steps.
parent_config: "{exp_cfg}"
opt:
  densify_from_iter: 0
  densification_interval: 5
""")
    out = os.path.join(tmp, "rehearsal_split")
    with open(log_path, "a") as log:
        proc, secs = _timed(lambda: subprocess.run(
            [sys.executable, "-m",
             "lidar_rt_tpu_torch.scripts.e2e_rehearsal", "train", "kitti",
             "--data", tmp, "--out", out, "-ec", split_cfg, "--split",
             str(RUNNER_SPLIT)], stdout=log, stderr=subprocess.STDOUT))
    if proc.returncode != 0:
        with open(log_path) as log:
            print(log.read()[-6000:])
        _check(False, f"e2e_rehearsal train kitti --split exited "
               f"{proc.returncode}")
    mdir = os.path.join(out, "exp", "scene_ke1")
    with open(os.path.join(mdir, "logs", "log.json")) as f:
        log = json.load(f)
    with open(os.path.join(mdir, "logs", "chunks.json")) as f:
        chunks = json.load(f)
    its = [h["iteration"] for h in log["history"]]
    evals = [e["iteration"] for e in log["eval_history"]]
    dens = [e["iteration"] for e in log["densify"]]
    every = list(range(RUNNER_TESTING, CLI_ITERATIONS + 1, RUNNER_TESTING))
    print(f"[runner] {card}: split run, train kitti --split {RUNNER_SPLIT}:"
          f" chunks {[(c['from'], c['to']) for c in chunks]}, seconds "
          f"{[round(c['command_s'], 2) for c in chunks]} (host clock); "
          f"history {its[0]}-{its[-1]} ({len(its)} entries), held-out "
          f"evals at {evals} (PSNR "
          f"{[round(e['eval_psnr'], 3) for e in log['eval_history']]}), "
          f"densify events at {dens} (alive "
          f"{[e['alive'] for e in log['densify']]}), refined in chunk "
          f"{['refine_epochs' in c['seconds'] for c in chunks]}, "
          f"U-Net loss {[round(x, 5) for x in log['refine_loss']]}")
    _check(its == list(range(1, CLI_ITERATIONS + 1)) and evals == every
           and sorted(set(dens)) == every
           and all(np.isfinite(h["loss"]) for h in log["history"]),
           f"split run: one contiguous log: history {its}, evals {evals}, "
           f"densify {dens}")
    _check([(c["from"], c["to"]) for c in chunks]
           == [(0, RUNNER_SPLIT), (RUNNER_SPLIT, CLI_ITERATIONS)]
           and ["refine_epochs" in c["seconds"] for c in chunks]
           == [False, True] and len(log["refine_loss"]) == CLI_EPOCHS
           and os.path.exists(os.path.join(mdir, "models", "unet.npz")),
           f"split run: the U-Net refined once, by the last chunk: "
           f"{chunks}")
    n = [dict(zip(LAUNCH_KEYS, (c["launches"][k] for k in LAUNCH_COUNTERS)))
         for c in chunks]
    _check(all(c["fwd_c"] == c["bwd_c"] == 2 * RUNNER_SPLIT for c in n),
           f"split run: the cached pair per pass and step in each chunk: "
           f"{n}")
    fork_run(tmp, out, mdir, log_path, card)
    return {"seconds": secs,
            "launches": {k: sum(c[k] for c in n) for k in LAUNCH_KEYS}}


RUNNER_FORK_TO = CLI_ITERATIONS + 5      # phase 18's fork: 5 steps
# A child process: `cli train` (its arguments) with the Trainer's opacity
# resets and each densify's use_size recorded, printed as the last line.
FORK_CHILD = """
import json, sys
from lidar_rt_tpu_torch import cli
from lidar_rt_tpu_torch.train import loop
seen = {"resets": [], "use_size": []}
reset, kwargs = loop.Trainer._reset_opacity, loop.Trainer._densify_kwargs
def _reset(self):
    seen["resets"].append(self.iteration)
    reset(self)
def _kwargs(self, asset, use_size):
    seen["use_size"].append([self.iteration, use_size])
    return kwargs(self, asset, use_size)
loop.Trainer._reset_opacity, loop.Trainer._densify_kwargs = _reset, _kwargs
cli.main(["train", *sys.argv[1:]])
print(json.dumps(seen))
"""


def fork_run(tmp: str, out: str, mdir: str, log_path: str, card: str
             ) -> None:
    """Phase 18's fork: the split run's checkpoint at CLI_ITERATIONS
    resumed (`cli train -m`, its own model directory, no refine) to
    RUNNER_FORK_TO under its config with `opacity_reset_interval` at the
    resume point, as `configs/rehearsal/full_noreset8k.yaml` forks
    full.yaml at 8,000.  Checks that the resumed run takes the new
    schedule: no opacity reset (none at the interval it resumed at, none
    after), its densify event at 25 with the size and box prunes on
    (`use_size`, off at 5-20 under the parent's interval of 1,000), a
    contiguous history from the resume on and finite losses."""
    fork_cfg = os.path.join(tmp, "runner_fork_exp.yaml")
    with open(fork_cfg, "w") as f:
        f.write(f"""# Phase 18's split run forked at {CLI_ITERATIONS}.
parent_config: "{os.path.join(out, 'kitti_exp.yaml')}"
task_name: rehearsal_fork
opt:
  opacity_reset_interval: {CLI_ITERATIONS}
refine:
  use_refine: false
""")
    from lidar_rt_tpu_torch.scripts.e2e_rehearsal import chunk_checkpoint

    ckpt = chunk_checkpoint(os.path.join(mdir, "models"), CLI_ITERATIONS)
    with open(log_path, "a") as log:
        proc, secs = _timed(lambda: subprocess.run(
            [sys.executable, "-c", FORK_CHILD, "-dc",
             "configs/rehearsal/kitti.yaml", "-ec", fork_cfg, "-m", ckpt,
             "--iterations", str(RUNNER_FORK_TO)], stdout=subprocess.PIPE,
            stderr=log, text=True))
    if proc.returncode != 0:
        with open(log_path) as log:
            print(log.read()[-6000:])
        _check(False, f"the fork of the split run exited {proc.returncode}")
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(os.path.join(tmp, "rehearsal_fork", "exp", "scene_ke1",
                           "logs", "log.json")) as f:
        log = json.load(f)
    its = [h["iteration"] for h in log["history"]]
    print(f"[runner] {card}: fork of the split run at {CLI_ITERATIONS} "
          f"with opacity_reset_interval {CLI_ITERATIONS} (of 1000), to "
          f"{RUNNER_FORK_TO}: {secs:.2f} s (host clock); resets at "
          f"{seen['resets']}, densify (iteration, use_size) "
          f"{seen['use_size']}, history {its[0]}-{its[-1]}, loss "
          f"{[round(h['loss'], 5) for h in log['history']]}")
    _check(seen["resets"] == []
           and {tuple(u) for u in seen["use_size"]}
           == {(RUNNER_FORK_TO, True)} and len(seen["use_size"]) >= 2
           and its == list(range(CLI_ITERATIONS + 1, RUNNER_FORK_TO + 1))
           and all(np.isfinite(h["loss"]) for h in log["history"]),
           f"fork of the split run: the resumed run takes the new "
           f"schedule: {seen}, history {its}")


# Phase 20: the user tools at a cut depth.
TOOLS_QUALITY = ("50", "32x512", "0",
                 "8x128 K=256 rebin10,16x32 K=128 rebin10 tail1")
TOOLS_NAN = ("8", "256", "128", "20")
TOOLS_SEEDS, TOOLS_EPOCHS = ("0", "1"), "2"


def hold_tile_pair(inputs, what: str, card: str, dev, gen, tag: str
                   ) -> tuple[dict, torch.Tensor]:
    """The tile-order kernels, uncached and cached, against their twins on
    one render's tile inputs: the forward's channels and accum, the
    backward's gradients for an upstream gradient drawn from `gen` (none on
    raw T, which the training loss never reads), then the cached pair
    (`check_cached_pair`, its decode held to the float32 replay too), at
    PERF.md section 2's bars; prints
    `[tag-kernel]` and `[tag-cache]` lines.  Returns the largest errors
    ({fwd, bwd, fwd_c, bwd_c}) and the forward's channels."""
    from lidar_rt_tpu_torch.ops import cuda_tracer, kernels

    with torch.no_grad():
        chans, acc = kernels.tracer_forward(*inputs)
        chans_p, acc_p = cuda_tracer.forward_tiles_reference(*inputs)
        g = torch.randn(chans.shape, generator=gen, device=dev)
        g[:, 9:] = 0.0     # raw T: never read by the training loss
        grads = kernels.tracer_backward(*inputs, chans, g)
        grads_p = cuda_tracer.backward_tiles_reference(*inputs, chans, g)
        torch.cuda.synchronize()
    err = (chans - chans_p).abs().max().item()
    acc_err, acc_ok = _accum_err(acc, acc_p)
    g_err = _grad_errors(grads, grads_p, TWIN_GRADS)
    print(f"[{tag}-kernel] {what}: T={inputs.dirs.shape[0]} "
          f"R={inputs.dirs.shape[1]}, "
          f"{inputs.cnt.float().mean().item():.1f} candidates/"
          f"tile, min carried T {inputs.t0.min().item():.4f}; "
          f"forward channels max abs err {err:.3e} (bar "
          f"{CHAN_ATOL}), accum {acc_err:.3e}; backward "
          f"{_fmt_grads(g_err)} ({card})", flush=True)
    _check(err <= CHAN_ATOL and acc_ok, f"{what}: forward vs twin")
    _check_grads(g_err, f"{what}: backward vs twin")
    pair = check_cached_pair(
        inputs, chans, acc, g, what,
        lambda line: print(f"[{tag}-cache] {line}", flush=True))
    return {"fwd": err,
            "bwd": max((a - b).abs().max().item()
                       for a, b in zip(grads, grads_p)),
            "fwd_c": pair["fwd_err"], "bwd_c": pair["bwd_err"]}, chans


def tool_shapes(card: str, dev, gen) -> dict:
    """Phase 20's kernel checks: the tile-order kernels, uncached and
    cached, against their twins at the tools' own shapes, which no other
    phase gives them: quality_check's 16x32 K=128 tail1 config at
    TOOLS_QUALITY's 32 x 512 (R=512, both passes of the tail chain, the
    second carrying the first's transmittance) and nan_forensics' 8x256
    K=128 on its 64 x 2650 scene (R=2048), each on one training frame of
    the tool's synthetic scene as the tool assembles it.  Returns the
    largest errors per tool and kernel (fwd, bwd, fwd_c, bwd_c)."""
    import random

    from lidar_rt_tpu_torch.core import transforms
    from lidar_rt_tpu_torch.data import build, synthetic
    from lidar_rt_tpu_torch.ops import cuda_tracer
    from lidar_rt_tpu_torch.ops import tracer as tracer_lib
    from lidar_rt_tpu_torch.ops.binning import TileConfig
    from lidar_rt_tpu_torch.scene import compose
    from lidar_rt_tpu_torch.scripts import quality_check
    from lidar_rt_tpu_torch.train import options

    qc = next(c for c in quality_check.CONFIGS
              if c[0] == "16x32 K=128 rebin10 tail1")
    h_q, w_q = (int(v) for v in TOOLS_QUALITY[1].split("x"))
    th, tw, k_n = (int(v) for v in TOOLS_NAN[:3])
    cases = (("quality_check", qc[1], qc[4], h_q, w_q),
             ("nan_forensics", TileConfig(tile_h=th, tile_w=tw,
                                          max_per_tile=k_n, binner="hier"),
              0, 64, 2650))
    out = {}
    host_rngs = random.getstate(), np.random.get_state()
    for tool, tile, tail, h, w in cases:
        # The tools' scene: their host generators and the assembly's
        # explicit one seeded with 0.
        random.seed(0)
        np.random.seed(0)
        frames, track = synthetic.generate(num_frames=4, height=h, width=w,
                                           device=dev)
        scene = build.assemble_scene(
            frames, [track], options.experiment_options(),
            torch.Generator(device=dev).manual_seed(0),
            capacity_headroom=2.0)
        f0 = frames.train_frames[0]
        s2w = frames.pose(f0)
        errs = dict.fromkeys(("fwd", "bwd", "fwd_c", "bwd_c"), 0.0)
        with torch.no_grad():
            bundle, _ = compose(scene, f0)
            chain = tracer_lib.bin_tail_chain(
                bundle, frames.grid, w, transforms.invert_se3(s2w), tile,
                tail)
        carry = None
        for p, asg in enumerate(chain):
            what = (f"{tool}'s scene, frame {f0}, {tile.tile_h}x"
                    f"{tile.tile_w} K={tile.max_per_tile} pass {p} of "
                    f"{len(chain)}")
            with torch.no_grad():
                inputs, _ = cuda_tracer.tile_inputs(
                    bundle, frames.grid, w, s2w,
                    scene.background.active_sh_degree, tile, asg,
                    init_trans=carry)
            pair_errs, chans = hold_tile_pair(inputs, what, card, dev, gen,
                                              "tools")
            for key, v in pair_errs.items():
                errs[key] = max(errs[key], v)
            carry = cuda_tracer.from_tiles(chans.transpose(1, 2), tile, h,
                                           w)[..., 9]
            del inputs, chans
        out[tool] = errs
        del scene, frames, bundle, chain, carry
    random.setstate(host_rngs[0])
    np.random.set_state(host_rngs[1])
    return out


# Phase 20's truncation reading: two chunks of TRACE_CHUNK steps on phase
# 13's KITTI-360 sequence, the warm-up budget (K=512) in the first.
TRACE_CHUNK = 10


def _trainer_digest(trainer) -> str:
    """Digest of what a trainer's next steps read: the scene's leaves and
    alive masks, the Adam state, the densify statistics, the bin cache
    and its ages, the densify generator, the host and torch generators,
    the frame stack and the iteration."""
    import random

    st = trainer.state
    parts = []
    for asset, opt, stats in (
            (st.scene.background, st.opt_bg, st.stats_bg),
            (st.scene.actors, st.opt_actors, st.stats_actors)):
        if asset is None:
            continue
        parts += [*asset.params().values(), asset.alive, *stats]
        for s in opt.adam.state.values():
            parts += [v for v in s.values() if torch.is_tensor(v)]
    parts += [st.bins.index, st.bins.valid, st.generator.get_state(),
              torch.get_rng_state(), torch.cuda.get_rng_state()]
    host = np.random.get_state()
    return _digest(parts) + hashlib.sha256(repr((
        st.bins.age, st.bins.rebins, [o.steps for o in (st.opt_bg,
                                                        st.opt_actors)
                                      if o is not None],
        trainer._frame_stack, trainer.iteration, random.getstate(),
        host[0], host[1].tobytes(), host[2:])).encode()).hexdigest()


def _history_bits(history) -> list:
    """A trainer's history with every float as its bits (without the
    wall-clock `elapsed`)."""
    return [{k: (v.hex() if isinstance(v, float) else v)
             for k, v in h.items() if k != "elapsed"} for h in history]


def trace_check(tmp: str, card: str, dev) -> dict:
    """Phase 20's truncation reading on phase 13's KITTI-360 sequence, the
    rehearsal's experiment cut to two chunks of TRACE_CHUNK steps (K=512
    in the first, K=256 with its tail pass in the second): `python -m
    lidar_rt_tpu_torch.scripts.truncation_trace`'s `main` in this process
    (the kernels are built), each chunk's per-pass truncation checked for
    shape and order; then three trainers from one assembled scene, one
    read by `chain_truncation` after each chunk and two not.  Every read
    must leave the trainer's whole state and every generator bit-identical
    (`_trainer_digest`), and the read trainer's history and final state
    must equal an unread one's bit for bit wherever the card trains
    bit-reproducibly (the two unread trainers agree); the loss gaps of
    both pairs are printed.  Returns the command's launches and seconds."""
    import random

    from lidar_rt_tpu_torch.scripts import truncation_trace as tt
    from lidar_rt_tpu_torch.train import loop

    exp_cfg = os.path.join(tmp, "trace_exp.yaml")
    with open(exp_cfg, "w") as f:
        f.write(f"""# The rehearsal's experiment cut to two chunks.
parent_config: "{os.path.abspath('configs/rehearsal/exp.yaml')}"
source_dir: "{os.path.join(tmp, 'kitti360')}"
testing_iterations: {TRACE_CHUNK}
tracer:
  warmup_until: {TRACE_CHUNK}
""")
    dc = os.path.abspath("configs/rehearsal/kitti.yaml")
    total = 2 * TRACE_CHUNK
    host_rngs = random.getstate(), np.random.get_state()
    with open(os.path.join(tmp, "tools.log"), "a") as log, \
            contextlib.redirect_stdout(log):
        rec, cmd_s = _timed(lambda: tt.main(
            ["-dc", dc, "-ec", exp_cfg, "--iterations", str(total)]))
    rows = rec["chunks"]
    _check([r["iteration"] for r in rows] == [TRACE_CHUNK, total]
           and [r["chain"][0]["K"] for r in rows] == [512, 256]
           and rec["card"] == card, f"truncation_trace chunks {rows}")
    for r in rows:
        ch = r["chain"]
        _check(len(ch) == 2 and np.isfinite([r["eval_psnr"], r["loss"]]).all()
               and all(0 <= p["tiles"] <= p["tiles_binned"]
                       and 0 <= p["max"] <= p["truncated"] for p in ch)
               and ch[1]["truncated"] <= ch[0]["truncated"]
               and ch[1]["tiles"] <= ch[0]["tiles"],
               f"truncation_trace chunk {r}")
        print(f"[tools] {card}: truncation_trace KITTI-360 at iteration "
              f"{r['iteration']} (K={ch[0]['K']}): held-out PSNR "
              f"{r['eval_psnr']:.3f}, loss {r['loss']:.4f}, alive "
              f"{r['alive']}, per pass (truncated, tiles of "
              f"{ch[0]['tiles_binned']}, max) " + ", ".join(
                  f"{p['truncated']}/{p['tiles']}/{p['max']}" for p in ch)
              + f"; read {r['read_s']:.3f} s")
    n = {k: rec["launches"][c] for k, c in zip(LAUNCH_KEYS, LAUNCH_COUNTERS)}
    _check(n["fwd_c"] == n["bwd_c"] == 2 * total and n["fwd"] > 0,
           f"truncation_trace trains cached (2 passes a step) and renders "
           f"uncached: {n}")

    t0 = time.perf_counter()
    first, args = tt.build_trainer(dc, exp_cfg, dev)
    trainers = [first] + [
        loop.Trainer(first.state.scene, first.frames, args,
                     first.trace_cfg, warmup_cfg=first.step_cfg,
                     warmup_until=first.warmup_until) for _ in range(2)]
    runs, reads = [], 0
    for i, trainer in enumerate(trainers):
        # Each trainer seeds the host generators when it is made; the
        # steps draw from them, so each run starts from those seeds.
        random.seed(int(args.get("seed", 1)))
        np.random.seed(int(args.get("seed", 1)))
        while trainer.iteration < total:
            trainer.run(iterations=TRACE_CHUNK, log_every=100)
            if i == 0:
                before = _trainer_digest(trainer)
                tt.chain_truncation(trainer, trainer.frames.train_frames)
                torch.cuda.synchronize()
                _check(_trainer_digest(trainer) == before,
                       f"chain_truncation changed the trainer's state at "
                       f"iteration {trainer.iteration}")
                reads += 1
        runs.append((_history_bits(trainer.history),
                     [h["loss"] for h in trainer.history],
                     _state_digest(trainer)))
    del first, trainers
    random.setstate(host_rngs[0])
    np.random.set_state(host_rngs[1])
    same = runs[0][0] == runs[1][0] and runs[0][2] == runs[1][2]
    reproducible = runs[1][0] == runs[2][0] and runs[1][2] == runs[2][2]
    gap = max(abs(a - b) for a, b in zip(runs[0][1], runs[1][1]))
    floor = max(abs(a - b) for a, b in zip(runs[2][1], runs[1][1]))
    print(f"[tools] {card}: chain_truncation read {reads} times, the "
          f"state and generators bit-identical after each; read vs unread "
          f"trainer over {total} steps: history and final state "
          f"{'bit-identical' if same else 'DIFFER'} (largest loss gap "
          f"{gap:.3e}); two unread trainers "
          f"{'bit-identical' if reproducible else 'DIFFER'} (largest loss "
          f"gap {floor:.3e}); truncation_trace {cmd_s:.2f} s, the three "
          f"trainers {time.perf_counter() - t0:.2f} s")
    # The kernels' float atomics sum in no fixed order, so a card need not
    # train bit-reproducibly; where it does, the read must change nothing.
    _check(same or not reproducible,
           "the read trainer's history and state equal an unread one's")
    return {"launches": n, "seconds": cmd_s}


def tools_phase(tmp: str, card: str, dev, gen) -> dict:
    """Phase 20: the tile-order kernels at the tools' shapes
    (`tool_shapes`), then `python -m
    lidar_rt_tpu_torch.scripts.quality_check` on two configs,
    `...nan_forensics` and `...refine_spread` on phase 14's checkpoint (2
    seeds of 2 epochs, the test frames), each a child process on this
    card, then `trace_check` (`...truncation_trace`); checks each one's
    results and launches, prints its lines and seconds.  Returns the
    tracer kernels' launches per tool and the errors at the tools'
    shapes."""
    shape_errs = tool_shapes(card, dev, gen)
    runs = {
        "quality_check": list(TOOLS_QUALITY),
        "nan_forensics": list(TOOLS_NAN),
        "refine_spread": ["-dc", "configs/rehearsal/waymo.yaml", "-ec",
                          os.path.join(tmp, "cli_exp.yaml"), "--seeds",
                          *TOOLS_SEEDS, "--epochs", TOOLS_EPOCHS, "-t",
                          "test"]}
    out, secs = {}, {}
    log_path = os.path.join(tmp, "tools.log")
    for tool, argv in runs.items():
        path = os.path.join(tmp, f"{tool}.json")
        with open(log_path, "a") as log:
            proc, secs[tool] = _timed(lambda: subprocess.run(
                [sys.executable, "-m", f"lidar_rt_tpu_torch.scripts.{tool}",
                 *argv, "--json", path], stdout=log,
                stderr=subprocess.STDOUT))
        if proc.returncode != 0:
            with open(log_path) as log:
                print(log.read()[-6000:])
            _check(False, f"{tool} exited {proc.returncode}")
        with open(path) as f:
            out[tool] = json.load(f)
    n = {}
    qc = out["quality_check"]
    _check([r["name"] for r in qc] == TOOLS_QUALITY[3].split(",")
           and all(r["engine"] == "cuda" and np.isfinite(r["losses"]).all()
                   and 0 <= r["metrics"]["hit_acc"] <= 1 for r in qc),
           f"quality_check: {qc}")
    n["quality_check"] = {k: sum(r["launches"][c] for r in qc)
                          for k, c in zip(LAUNCH_KEYS, LAUNCH_COUNTERS)}
    for r in qc:
        print(f"[tools] {card}: quality_check {TOOLS_QUALITY[1]}, "
              f"{TOOLS_QUALITY[0]} iterations: {r['name']}: "
              f"{r['it_per_s']:.1f} it/s, alive {r['alive']}, engine "
              f"{r['engine']}, " + ", ".join(
                  f"{k} {v:.4f}" for k, v in r["metrics"].items()))
    nf = out["nan_forensics"]
    _check(nf["report"] is None and nf["engine"] == "cuda",
           f"nan_forensics: {nf}")
    n["nan_forensics"] = {k: nf["launches"][c]
                          for k, c in zip(LAUNCH_KEYS, LAUNCH_COUNTERS)}
    print(f"[tools] {card}: nan_forensics {' '.join(TOOLS_NAN)}: no "
          f"non-finite gradient in {TOOLS_NAN[3]} steps, engine "
          f"{nf['engine']}")
    rs = out["refine_spread"]
    for line in rs["seeds"]:
        # The point metrics are nan where a frame's U-Net drops every ray
        # (an empty cloud), as `cli eval`'s are; the image metrics not.
        _check(all(0 <= a[m] <= 1 for a in line["accuracy"].values()
                   for m in ("eval", "train"))
               and all(np.isfinite(v) for k, v in line["mean"].items()
                       if not k.startswith("points/")),
               f"refine_spread seed {line['seed']}: {line}")
        print(f"[tools] {card}: refine_spread seed {line['seed']} "
              f"({line['epochs']} epochs): accuracy eval/train "
              + ", ".join(f"frame {f} {a['eval']:.4f}/{a['train']:.4f}"
                          for f, a in line["accuracy"].items())
              + "; test frames " + ", ".join(
                  f"{k} {v:.4f}" for k, v in line["mean"].items()))
    _check(rs["spread"]["card"] == card, f"refine_spread card "
           f"{rs['spread']['card']}")
    n["refine_spread"] = {k: rs["spread"]["launches"][c]
                          for k, c in zip(LAUNCH_KEYS, LAUNCH_COUNTERS)}
    _check(all(n[t]["fwd_c"] > 0 and n[t]["fwd_c"] == n[t]["bwd_c"]
               for t in ("quality_check", "nan_forensics"))
           and n["quality_check"]["fwd"] > 0
           and n["refine_spread"]["fwd"] > 0
           and n["refine_spread"]["fwd_c"] == 0,
           f"the tools train cached and render uncached: {n}")
    trace = trace_check(tmp, card, dev)
    secs["truncation_trace"] = trace["seconds"]
    n["truncation_trace"] = trace["launches"]
    print(f"[tools] {card}: seconds (child processes, host clock): "
          + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
          + f"; launches {LAUNCH_KEYS}: " + ", ".join(
              f"{t} {tuple(c.values())}" for t, c in n.items()))
    return {
        "fwd_paths": {t: n[t]["fwd"] for t in ("quality_check",
                                               "refine_spread",
                                               "truncation_trace")},
        "fwd_c_paths": {t: n[t]["fwd_c"] for t in ("quality_check",
                                                   "nan_forensics",
                                                   "truncation_trace")},
        "bwd_c_paths": {t: n[t]["bwd_c"] for t in ("quality_check",
                                                   "nan_forensics",
                                                   "truncation_trace")},
        "prep_g_paths": {t: n[t]["prep_g"] for t in n},
        "prep_s_paths": {t: n[t]["prep_s"] for t in ("quality_check",
                                                     "nan_forensics",
                                                     "truncation_trace")},
        "errs": shape_errs}


def probe_phase(card: str, seed: int, ptxas: dict[str, str]) -> list:
    """Phase 19: the two probe kernels.  Drives each probe's main path,
    `kernel_microbench.run` over every level and `bf16_microbench.run`
    over its four modes, with their launch counts from 0; then holds each
    level and mode to its plain version on the same inputs (bars:
    `kernel_microbench.error`, `bf16_microbench.error`) and times the
    plain version.  Returns the kernel table's entries (name, source,
    replaces, {path: launches}, max abs err, ms, plain ms, (bound ms,
    bound by))."""
    from lidar_rt_tpu_torch.scripts import bf16_microbench as gate
    from lidar_rt_tpu_torch.scripts import kernel_microbench as abl

    dev = torch.device("cuda", 0)
    abl.reset_launches()
    gate.reset_launches()
    abl_run = abl.run(abl.LEVELS, seed)
    gate_run = gate.run(seed)
    abl_n, gate_n = dict(abl.launches), dict(gate.launches)
    print(f"[probe] launches on the probes' main paths: ablation {abl_n}, "
          f"gate body {gate_n}")
    def regs_line(kernel: str, report: str) -> str:
        # probe_ablation_kernel<level>; probe_gate_kernel<bf16,exp>.
        args = kernel[kernel.index("<") + 1:-1].split(",")
        if kernel.startswith("probe_ablation"):
            name = abl.LEVELS[int(args[0])]
            r = abl_run[name]
        else:
            name = gate.mode_name("bf16" if args[0] == "true" else "f32",
                                  args[1] == "true")
            r = gate_run[name]
        return (f"{name}: {report}, {r['ms']:.4f} ms, "
                f"{r['bound_ms'] / r['ms']:.0%} of its bound")

    print(f"[probe] ptxas (registers and spills a thread, so whether each "
          f"level's intermediates stay in registers) and each level's and "
          f"mode's share of its bound: "
          + "; ".join(regs_line(k, v) for k, v in sorted(ptxas.items())
                      if k.startswith("probe_")))
    entries = []
    inputs = abl.make_inputs(seed, device=dev)
    for level in abl.LEVELS:
        with torch.no_grad():
            got = abl.ablation(level, inputs)
            want = abl.ablation_reference(level, inputs)
            err, ratio = abl.error(got, want)
            plain_ms = _event_ms(lambda: abl.ablation_reference(level,
                                                                inputs), 2)
        r = abl_run[level]
        print(f"[probe] ablation {level}: kernel vs plain max abs err "
              f"{err:.3e} ({ratio:.3f} of the bar {abl.ATOL} x max(1, "
              f"max|plain|), max|plain| "
              f"{want.abs().max().item():.3e}); {r['ms']:.4f} ms, "
              f"{r['gpairs_s']:.2f} G pairs/s, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), plain {plain_ms:.3f} ms; {card}")
        _check(bool(torch.isfinite(got).all()) and ratio <= 1.0,
               f"ablation probe {level} vs its plain version: {err}")
        del got, want
        entries.append((
            f"probe_ablation_{level}",
            "lidar_rt_tpu_torch/csrc/kernel_microbench.cu",
            "scripts/kernel_microbench.py:152 (_rowloop_kernel, in kernel "
            ":32; pl.pallas_call :210)" if level == "rowloop" else
            "scripts/kernel_microbench.py:32 (kernel; pl.pallas_call :210)",
            {"probe": abl_n[level]}, err, r["ms"], plain_ms,
            (r["bound_ms"], r["bound_by"])))
    del inputs
    for dtype, with_exp in gate.MODES:
        name = gate.mode_name(dtype, with_exp)
        a, b = gate.make_inputs(dtype, seed, device=dev)
        got = gate.probe(a, b, with_exp)
        want = gate.probe_reference(a, b, with_exp)
        err, ratio = gate.error(got, want)
        plain_ms = _event_ms(lambda: gate.probe_reference(a, b, with_exp), 2)
        r = gate_run[name]
        bar = (f"{gate.BF16_ULPS} bfloat16 ulps of each value"
               if dtype == "bf16" else
               f"{abl.ATOL} x max(1, max|plain|)")
        print(f"[probe] gate body {name}: kernel vs plain max abs err "
              f"{err:.3e} ({ratio:.3f} of the bar, {bar}); {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{plain_ms:.3f} ms; {card}")
        _check(bool(torch.isfinite(got.float()).all()) and ratio <= 1.0,
               f"gate probe {name} vs its plain version: {err}")
        entries.append((
            f"probe_gate_{name}",
            "lidar_rt_tpu_torch/csrc/bf16_microbench.cu",
            "scripts/bf16_microbench.py:39 (_kernel; pl.pallas_call :70)",
            {"probe": gate_n[name]}, err, r["ms"], plain_ms,
            (r["bound_ms"], r["bound_by"])))
    return entries


# Phase 21: the design probes on the street scene.
DESIGN_PROBES = ("survivor_stats", "overcount_probe", "subtile_demand",
                 "occlusion_stats", "selection_probe", "profile_binner",
                 "sweep_perf", "compact_probe")


def design_shapes(card: str, dev, seed: int) -> dict:
    """Phase 21's kernel checks: the tile-order kernels, uncached and
    cached, against their twins (`hold_tile_pair`) at the two shapes that
    `scripts/sweep_perf.py` adds and no other phase gives them, 4x128 and
    8x64 at K=128 (512 rays a tile; at 8x64 each warp holds half a tile
    row), on one render of the street scene (131,072 surfels at 64 x
    2650, the probes' pose), with upstream gradients drawn on all nine
    rows from a generator seeded here with `seed`, so that the cached
    decode's distance from the float32 replay is a state the seed alone
    fixes and is held to the cache bar, as phase 16 holds it.  (Drawn
    from a generator the earlier phases had advanced, it read 3.4e-3 to
    2.2e-2 of d_plane's max from one draw to the next, PERF.md section 6;
    on the CPU the reference's own cached backward strays from its replay
    as far as the port's twin does at these shapes,
    tests/test_torch_cache_shapes.py.)  Returns the largest errors per
    shape and kernel."""
    from lidar_rt_tpu_torch.ops import cuda_tracer
    from lidar_rt_tpu_torch.scripts import street, sweep_perf

    gen = torch.Generator(device=dev).manual_seed(seed)
    bundle = street.street_scene_bundle(street.N_SURFELS, 0, dev)
    grid, s2w = street.sensor(street.H, dev)
    out = {}
    for th, tw, k, _ in sweep_perf.CONFIGS[1:]:
        tile = sweep_perf.trace_config(th, tw, k, False).tile
        with torch.no_grad():
            inputs, _ = cuda_tracer.tile_inputs(bundle, grid, street.W, s2w,
                                                3, tile)
        what = f"street scene, {th}x{tw} K={k}"
        out[f"sweep_{th}x{tw}_k{k}"] = hold_tile_pair(
            inputs, what, card, dev, gen, "design")[0]
        del inputs
    return out


def macro_level(card: str, dev, binner: dict) -> None:
    """Phase 21's hier macro-column level: `profile_binner`'s m1024 row
    (1,024-column sectors, K_a = 4 x 2,048) beside plain hier's at 8x128
    K=256, with its macro truncation; then `profile_binner.exact_macro`:
    at the smallest macro_factor (or the soup thinned) whose sectors
    truncate nothing, its index, valid and truncated must equal plain
    hier's."""
    from lidar_rt_tpu_torch.scripts import profile_binner, street

    plain = binner["hier  8x128 K256 cf8"]
    macro = binner["hier  8x128 K256 cf8 m1024"]
    m = macro["macro_trunc"]
    _check(m is not None and macro["ms"] > 0,
           "profile_binner's m1024 row runs the macro level")
    print(f"[design] {card}: hier 8x128 K=256 with macro_cols 1024 "
          f"(K_a = 8,192) {macro['ms']:.3f} ms against plain hier's "
          f"{plain['ms']:.3f} ms (CUDA events, {profile_binner.ITERS} "
          f"calls); macro truncation: {int((m > 0).sum())} of {m.size} "
          f"sectors, {int(m.sum())} surfels past K_a; truncated tiles "
          f"{int((macro['truncated'] > 0).sum())} (plain "
          f"{int((plain['truncated'] > 0).sum())}), overflow "
          f"{int(macro['truncated'].sum())} (plain "
          f"{int(plain['truncated'].sum())})", flush=True)
    grid, s2w = street.sensor(street.H, dev)
    ex = profile_binner.exact_macro(
        street.street_scene_bundle(street.N_SURFELS, 0, dev), grid,
        street.W, s2w, dev)
    print(f"[design] {card}: the macro level without macro truncation: "
          f"macro_factor {ex['factor']} (K_a = {ex['factor'] * 2048:,}) on "
          f"the street soup (thinned {ex['thinned']}x), "
          f"{ex['surfels']:,} surfels: index, valid and truncated "
          f"{'equal' if ex['equal'] else 'NOT equal'} to plain hier's; "
          f"{ex['ms']:.3f} ms against {ex['plain_ms']:.3f} ms", flush=True)
    _check(ex["equal"], "the macro level's lists are plain hier's where no "
           "macro sector truncates")


def design_phase(card: str, dev, seed: int) -> dict:
    """Phase 21: the kernels at sweep_perf's new shapes (`design_shapes`),
    then the eight design probes of `lidar_rt_tpu_torch/scripts/` in this
    process at the bench's full shape (64 x 2650, 131,072 surfels), each
    through its command's `main` on this card, printing its lines:
    `sweep_perf` in both modes and `compact_probe` (whose dense step is the
    flagship tile-order pair) with the tracer kernels' counts set to 0
    just before each and read just after.  The JAX checkpoints' export
    (`export_jax_ckpt.py`) needs jax, which this machine lacks: it is held
    to the JAX package on the CPU only (`tests/test_torch_jax_ckpt.py`).
    Returns the launches per path and the errors per shape."""
    import importlib

    from lidar_rt_tpu_torch.ops import kernels

    errs = design_shapes(card, dev, seed)
    launches, secs, results = {}, {}, {}
    counted = {"sweep_perf": ["--device", "cuda"],
               "sweep_perf_fast": ["--device", "cuda", "--fast"],
               "compact_probe": ["--device", "cuda"]}
    for name in DESIGN_PROBES:
        mod = importlib.import_module(f"lidar_rt_tpu_torch.scripts.{name}")
        for path, argv in ([(p, a) for p, a in counted.items()
                            if p.startswith(name)]
                           or [(name, ["--device", "cuda"])]):
            print(f"[design] {path}: python -m lidar_rt_tpu_torch.scripts."
                  f"{name} {' '.join(argv)}", flush=True)
            torch.cuda.synchronize()
            kernels.reset_launches()
            results[path], secs[path] = _timed(lambda: mod.main(argv))
            torch.cuda.synchronize()
            launches[path] = dict(zip(LAUNCH_KEYS, _launch_counts()))
    oc = results["overcount_probe"]
    _check(all(c["gate"] > 0 and c["gate_not_int"] <= 1e-3 * c["gate"]
               for c in oc.values()),
           f"overcount_probe: gate passes inside the footprint box: {oc}")
    _check(all(c["truncated"] == 0 for key, c in oc.items()
               if key.endswith("topk")),
           f"overcount_probe: its topk rows list every candidate: {oc}")
    _check(all(np.isfinite(r[k]) and r[k] > 0
               for rows in (results["sweep_perf"], results["sweep_perf_fast"])
               for r in rows for k in ("fwd_ms", "fwd_bwd_ms", "bin_ms")),
           "sweep_perf times")
    n = launches
    _check(n["sweep_perf"]["fwd"] > 0 and n["sweep_perf"]["bwd"] > 0
           and n["sweep_perf"]["fwd_c"] == 0
           and n["sweep_perf_fast"]["fwd_c"] > 0
           and n["sweep_perf_fast"]["fwd_c"] == n["sweep_perf_fast"]["bwd_c"]
           and n["sweep_perf_fast"]["bwd"] == 0
           and n["compact_probe"]["fwd"] > 0
           and n["compact_probe"]["bwd"] > 0
           and all(sum(n[p].values()) == 0 for p in DESIGN_PROBES
                   if p not in ("sweep_perf", "compact_probe"))
           and all(tuple(n[p].values()) == _with_prep(
               tuple(n[p].values())[:7])
               for p in ("sweep_perf", "sweep_perf_fast")),
           f"the probes' kernel launches (the sweep's renders each with a "
           f"candidate gather, and a scatter with a gradient): {n}")
    macro_level(card, dev, results["profile_binner"])
    print(f"[design] {card}: seconds (host clock): " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()) + f"; launches "
          f"{LAUNCH_KEYS}: " + ", ".join(
              f"{p} {tuple(c.values())}" for p, c in n.items()
              if sum(c.values())), flush=True)
    return {
        "fwd_paths": {p: n[p]["fwd"] for p in counted},
        "bwd_paths": {p: n[p]["bwd"] for p in ("sweep_perf",
                                                "compact_probe")},
        "fwd_c_paths": {"sweep_perf_fast": n["sweep_perf_fast"]["fwd_c"]},
        "bwd_c_paths": {"sweep_perf_fast": n["sweep_perf_fast"]["bwd_c"]},
        "prep_g_paths": {p: n[p]["prep_g"] for p in ("sweep_perf",
                                                      "sweep_perf_fast")},
        "prep_s_paths": {p: n[p]["prep_s"] for p in ("sweep_perf",
                                                      "sweep_perf_fast")},
        "errs": errs}


# Phase 22: the profilers' coupled steps per timing (the commands take
# their modules' ITERS, 20 or 30), and the exact-order bench's.
BENCH_PHASE_ITERS = 5
BENCH_EXACT_ITERS = 2
BENCH_TOOLS = ("profile_stages", "profile_amortized", "stage_bench",
               "prep_bench", "intercept_probe", "grid_overhead_probe")


def _tool_launches(before: dict, captures) -> dict[str, int]:
    """The tracer kernels' launches on the card since `before` (a
    `kernels.launch_counts()`), by LAUNCH_KEYS: the wrappers' counts, in
    which the launches of each capture (a `captured` dict of `captures`)
    are counted once, at capture, less those, plus GRAPH_REPLAYS
    replays of each capture."""
    from lidar_rt_tpu_torch.ops import kernels
    from lidar_rt_tpu_torch.scripts import street

    n = kernels.launches_since(before)
    return {key: n[c] + (street.GRAPH_REPLAYS - 1)
            * sum(cap[c] for cap in captures)
            for key, c in zip(LAUNCH_KEYS, LAUNCH_COUNTERS)}


def _finite(x) -> bool:
    """Every tensor in x (a tensor or nested tuples of them) is finite."""
    if isinstance(x, torch.Tensor):
        return bool(torch.isfinite(x.float()).all())
    return all(_finite(v) for v in x)


def _tool_rows(name: str, r):
    """The timed rows of a stage profiler's result."""
    if name in ("profile_amortized", "intercept_probe"):
        return list(r["rows"].values())
    return list(r.values()) if isinstance(r, dict) else r


def bench_phase(card: str, dev) -> dict:
    """Phase 22: the port's bench (`lidar_rt_tpu_torch.bench`) and its six
    stage profilers in this process on the street scene (64 x 2650,
    131,072 surfels).  The bench's 20 coupled steps (the card's training
    mode, tile order, re-binned at 0 and 10) are timed from a CUDA graph
    and eagerly: the opacity gradient a replay carries out of its last step
    is held to the eager run's at the gradient bars (the kernels' float
    atomics rule out bits), and the graph holds one cached forward and one
    cached backward a step.  A capture in exact order (fast sums) must
    hold as well.  Then the tile-order forward against its twin at the
    tile shapes only `grid_overhead_probe` gives it (16x128, 32x128, 8x256
    at K=256), and each profiler at BENCH_PHASE_ITERS steps a timing:
    every time and every stage's value finite; `intercept_probe`'s
    every-count-zero forward composites nothing (channel rows 0-7 and
    10-15 and accum zero, rows 8-9 the initial transmittance, exactly)
    and its backward gives zero gradients.  Launches per path count each
    capture's launches once a replay.  Returns the launches per path and
    the forward's errors per shape."""
    import importlib

    from lidar_rt_tpu_torch import bench
    from lidar_rt_tpu_torch.ops import cuda_tracer, kernels
    from lidar_rt_tpu_torch.ops.binning import TileConfig
    from lidar_rt_tpu_torch.scripts import grid_overhead_probe, street

    t_phase = time.perf_counter()
    bundle = street.street_scene_bundle(street.N_SURFELS, 0, dev)
    grid, s2w = street.sensor(street.H, dev)
    width = street.W
    kn = bench.knobs({})       # the flagship, whatever the environment says
    paths = {}

    before = kernels.launch_counts()
    cfg = bench.trace_config(kn)
    r = bench.run(bundle, grid, width, s2w, cfg, dev, profile=True)
    torch.cuda.synchronize()
    paths["bench"] = _tool_launches(before, [r["captured"]])
    print(f"[bench] {card}: python -m lidar_rt_tpu_torch.bench: "
          + bench.describe(cfg, bench.ITERS), flush=True)
    for line in bench.lines(r, dev):
        print(f"[bench] {card}: {line}", flush=True)
    print(f"[bench] {card}: {json.dumps(bench.result(r, dev))}", flush=True)
    errs = _grad_errors([r["graph_carry"].grad], [r["eager_carry"].grad],
                        ["d_opacity"])
    print(f"[bench] {card}: the opacity gradient a replay carries out of "
          f"its last step against the eager run's: {_fmt_grads(errs)}; "
          f"losses {r['graph_carry'].loss.item():.6e} (graph), "
          f"{r['eager_carry'].loss.item():.6e} (eager)", flush=True)
    _check_grads(errs, "bench: the replayed opacity gradient vs eager")
    cap = r["captured"]
    _check(cap["forward_cache_launches"] == cap["backward_cache_launches"]
           == cap["prep_gather_launches"] == cap["prep_scatter_launches"]
           == bench.ITERS and sum(cap.values()) == 4 * bench.ITERS,
           f"bench: the capture holds one cached forward and backward a "
           f"step, and one candidate gather and scatter: {cap}")
    _check(all(np.isfinite(r[k]) and r[k] > 0
               for k in ("graph_ms", "eager_ms", "mray_graph")),
           f"bench times: {r}")

    before = kernels.launch_counts()
    cfg_x = bench.trace_config(kn._replace(exact=True))
    r_x = bench.run(bundle, grid, width, s2w, cfg_x, dev,
                    iters=BENCH_EXACT_ITERS, warmup=1)
    torch.cuda.synchronize()
    paths["bench_exact"] = _tool_launches(before, [r_x["captured"]])
    errs_x = _grad_errors([r_x["graph_carry"].grad],
                          [r_x["eager_carry"].grad], ["d_opacity"])
    print(f"[bench] {card}: BENCH_EXACT=1, {BENCH_EXACT_ITERS} steps: "
          f"graph {r_x['graph_ms']:.3f} ms, eager {r_x['eager_ms']:.3f} ms "
          f"a step; capture {r_x['captured']}; replayed gradient vs eager "
          f"{_fmt_grads(errs_x)}", flush=True)
    _check_grads(errs_x, "bench exact: the replayed opacity gradient")
    _check(r_x["captured"]["forward_exact_launches"]
           == r_x["captured"]["backward_exact_fast_launches"]
           == BENCH_EXACT_ITERS, f"bench exact capture: {r_x['captured']}")

    errs = {}
    with torch.no_grad():
        for th, tw, k, _label in grid_overhead_probe.ROWS:
            if (th, tw) == (8, 128):
                continue    # phases 3, 20 and 21 hold 8x128's
            tile = TileConfig(tile_h=th, tile_w=tw, max_per_tile=k,
                              binner="hier")
            inputs, _ = cuda_tracer.tile_inputs(bundle, grid, width, s2w, 3,
                                                tile)
            chans, acc = kernels.tracer_forward(*inputs)
            chans_p, acc_p = cuda_tracer.forward_tiles_reference(*inputs)
            torch.cuda.synchronize()
            err = (chans - chans_p).abs().max().item()
            acc_err, acc_ok = _accum_err(acc, acc_p)
            print(f"[bench-kernel] {card}: street scene, {th}x{tw} K={k}: "
                  f"T={inputs.dirs.shape[0]} R={inputs.dirs.shape[1]}, "
                  f"forward channels max abs err {err:.3e} (bar "
                  f"{CHAN_ATOL}), accum {acc_err:.3e}", flush=True)
            _check(err <= CHAN_ATOL and acc_ok,
                   f"grid_overhead_probe's {th}x{tw}: forward vs twin")
            errs[f"grid_{th}x{tw}_k{k}"] = err
            del inputs, chans, chans_p

    secs = {}
    for name in BENCH_TOOLS:
        mod = importlib.import_module(f"lidar_rt_tpu_torch.scripts.{name}")
        before = kernels.launch_counts()
        t = time.perf_counter()
        out = mod.profile(bundle, grid, width, s2w, dev,
                          iters=BENCH_PHASE_ITERS)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        rows = _tool_rows(name, out)
        paths[name] = _tool_launches(before,
                                     [row["captured"] for row in rows])
        text = (mod.lines(out, grid.height, width, dev)
                if name in ("profile_stages", "profile_amortized")
                else mod.lines(out, dev))
        for line in text:
            print(f"[bench] {card}: {name}: {line}", flush=True)
        _check(all(np.isfinite(row[k]) and row[k] > 0 for row in rows
                   for k in ("graph_ms", "eager_ms")),
               f"{name}: every stage's times finite")
        # Stage 1's ranges are +inf past a column's overlapping surfels.
        values = [row["value"] for row in rows]
        if name == "prep_bench":
            i = list(out).index("bin stage1 (topKc)")
            values[i] = values[i][1]
        _check(all(_finite(v) for v in values),
               f"{name}: every stage's value finite")
        if name == "intercept_probe":
            chans, acc = out["rows"]["fwd_cnt0"]["value"]
            t0 = out["inputs"].t0
            g0 = out["rows"]["fwd+bwd_cnt0"]["value"]
            zero_ok = (bool((chans[:, :8] == 0).all())
                       and bool((chans[:, 10:] == 0).all())
                       and torch.equal(chans[:, 8], t0)
                       and torch.equal(chans[:, 9], t0)
                       and bool((acc == 0).all()) and bool((g0 == 0).all()))
            print(f"[bench] {card}: intercept_probe: every count zero: "
                  f"channels and accum {'as' if zero_ok else 'NOT as'} "
                  f"nothing composited, opacity gradient "
                  f"{g0.abs().max().item():.3e}", flush=True)
            _check(zero_ok, "intercept_probe: the every-count-zero forward "
                   "composites nothing")
    n = paths
    _check(n["bench"]["fwd_c"] > 0 and n["bench"]["bwd_c"] > 0
           and n["bench"]["fwd"] == n["bench"]["bwd"] == 0
           and n["bench_exact"]["fwd_x"] > 0 and n["bench_exact"]["bwd_xf"] > 0
           and all(n[p]["fwd"] > 0 for p in BENCH_TOOLS
                   if p != "prep_bench")
           and all(n[p]["bwd"] > 0 for p in ("profile_stages",
                                              "profile_amortized",
                                              "intercept_probe"))
           and sum(n["prep_bench"].values()) == n["prep_bench"]["prep_g"]
           > 0,
           f"phase 22's kernel launches (prep_bench's the candidate "
           f"gather alone): {n}")
    print(f"[bench] {card}: seconds (host clock): " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()) + f"; phase "
          f"{time.perf_counter() - t_phase:.2f}; launches {LAUNCH_KEYS} "
          f"(a capture's once a replay): " + ", ".join(
              f"{p} {tuple(c.values())}" for p, c in n.items()), flush=True)
    keyed = {key: {p: c[key] for p, c in n.items() if c[key] > 0}
             for key in LAUNCH_KEYS}
    return {"paths": keyed, "errs": errs}


EXACT_FAST_STEPS = 5       # exact-order training steps with the fast sums


def cache_phase(card: str, dev, f_inputs, g_fixed, t_inputs, g_train,
                x_inputs, x_chans, g_exact, make_trainer, serve,
                replay_step_ms: float, ptxas: dict[str, str]) -> dict:
    """Phase 16: the tracer's training modes (the reference's fast_math
    and cache_fwd) at the flagship shape, on phase 8's training render
    before its first step (`f_inputs`, upstream `g_fixed`: a state the
    seed alone fixes) and after its 20 steps (`t_inputs`, upstream
    `g_train`: a state that differs run to run, atomics and Adam's eps),
    and phase 9's exact-order case.
    (a, b) `check_cached_pair` on both renders, its decode against the
    float32 replay held to the bars on `f_inputs` and reported on
    `t_inputs`: (a) the forward writing its cache
    into a NaN-filled buffer against the uncached forward (channels to the
    bit) and its twin's encoding (`cache_check`); (b) the decoding
    backward with the fast sums against its twin (decoding the twin's
    cache) and the float32 replay, at the cache bars (FAST_COS,
    FAST_REL), and (c) the same forward's cache in a NaN-filled buffer and
    in one filled with a live pair, as phases 13 and 15 do on the
    assembled Waymo scene at both budgets and on a band; (d) the exact
    order's sums at one TF32 product against its twin and the 3xTF32
    sums; (e) CUDA-event times of each mode beside the other, and the
    ptxas report (`ptxas`, by device kernel) of the cached pair and the
    replayed kernels; (f)
    `Trainer` replayed in float32, in the cached mode and in exact order
    with the fast sums, and a serving render's peak memory in the cached
    configuration.
    `make_trainer(cfg)` builds phase 8's trainer; `serve(cfg)` renders
    phase 4's scan."""
    from lidar_rt_tpu_torch.ops import cuda_tracer, kernels, tracer

    t, r = t_inputs.dirs.shape[:2]
    k = t_inputs.axes.shape[-1]
    shape = f"T={t} R={r} K={k}"
    out = {}

    # (a), (b), (c)
    with torch.no_grad():
        f_chans, f_accum = kernels.tracer_forward(*f_inputs)
    fixed = check_cached_pair(
        f_inputs, f_chans, f_accum, g_fixed,
        "phase 8's training render before its first step",
        lambda line: print(f"[cache] {line}", flush=True))
    del f_chans, f_accum, fixed["cache"], fixed["twin_cache"]
    with torch.no_grad():
        chans, accum = kernels.tracer_forward(*t_inputs)
    pair = check_cached_pair(
        t_inputs, chans, accum, g_train, "phase 8's training inputs",
        lambda line: print(f"[cache] {line}", flush=True), replay_bar=False)
    out["fwd_c_err"] = max(fixed["fwd_err"], pair["fwd_err"])
    out["bwd_c_err"] = max(fixed["bwd_err"], pair["bwd_err"])
    cache, p_cache = pair["cache"], pair["twin_cache"]
    worst = {label: max(r["replay_errs"].items(), key=lambda kv: kv[1][1])
             for label, r in (("before", fixed), ("after", pair))}
    print(f"[cache] decode vs the float32 replay, worst field: before the "
          f"first step (bar) {worst['before'][0]} {worst['before'][1][1]:.3e}"
          f" x max (cosine {worst['before'][1][0]:.6f}); after 20 steps (no "
          f"bar) {worst['after'][0]} {worst['after'][1][1]:.3e} x max "
          f"(cosine {worst['after'][1][0]:.6f}); bar {FAST_REL} x max, "
          f"cosine >= {FAST_COS}")
    del pair, fixed

    # (d)
    with torch.no_grad():
        fast_x = kernels.tracer_backward(*x_inputs, x_chans, g_exact,
                                         exact=True, fast=True)
        full_x = kernels.tracer_backward(*x_inputs, x_chans, g_exact,
                                         exact=True)
        twin_x = cuda_tracer.backward_tiles_reference(*x_inputs, x_chans,
                                                      g_exact, exact=True)
        torch.cuda.synchronize()
    for what, ref in (("its twin", twin_x), ("the 3xTF32 sums", full_x)):
        errs = _grad_errors(fast_x, ref, TWIN_GRADS)
        print(f"[cache] exact order, fast sums, T={x_inputs.dirs.shape[0]} "
              f"K={x_inputs.axes.shape[-1]}, vs {what}: {_fmt_grads(errs)}")
        _check(all(cos >= FAST_COS and rel <= FAST_REL
                   for cos, rel in errs.values()),
               f"exact fast sums vs {what}: {errs}")
    out["bwd_xf_err"] = max((a - b).abs().max().item()
                            for a, b in zip(fast_x, twin_x))
    del fast_x, full_x, twin_x

    # (e)
    with torch.no_grad():
        buf = torch.zeros(kernels.cache_shape(t, k, r), dtype=torch.bfloat16,
                          device=dev)
        ms = {
            "forward": _event_ms(lambda: kernels.tracer_forward(*t_inputs),
                                 20),
            "forward_cache": _event_ms(lambda: kernels.tracer_forward(
                *t_inputs, cache=True, cache_out=buf), 20),
            "backward": _event_ms(lambda: kernels.tracer_backward(
                *t_inputs, chans, g_train), 20),
            "backward_fast": _event_ms(lambda: kernels.tracer_backward(
                *t_inputs, chans, g_train, fast=True), 20),
            "backward_cache": _event_ms(lambda: kernels.tracer_backward(
                *t_inputs, chans, g_train, cache=cache, fast=True), 20),
            "backward_cache_3xtf32": _event_ms(
                lambda: kernels.tracer_backward(*t_inputs, chans, g_train,
                                                cache=cache), 20),
            "exact_backward": _event_ms(lambda: kernels.tracer_backward(
                *x_inputs, x_chans, g_exact, exact=True), 10),
            "exact_backward_fast": _event_ms(
                lambda: kernels.tracer_backward(*x_inputs, x_chans, g_exact,
                                                exact=True, fast=True), 10),
            "forward_cache_twin": _event_ms(
                lambda: cuda_tracer.forward_tiles_reference(*t_inputs,
                                                            cache=True), 3),
            "backward_cache_twin": _event_ms(
                lambda: cuda_tracer.backward_tiles_reference(
                    *t_inputs, chans, g_train, cache=p_cache), 3)}
        del buf
    out["ms"] = ms
    print(f"[cache-times] {card}: {shape} (phase 8's training render) and "
          f"the exact case of phase 9, CUDA events: "
          + ", ".join(f"{key} {v:.3f} ms" for key, v in ms.items()))
    print(f"[cache-times] cached forward {ms['forward_cache']:.3f} ms = "
          f"{ms['forward_cache'] / ms['forward']:.3f} x the uncached "
          f"forward's; cached backward {ms['backward_cache']:.3f} ms = "
          f"{ms['backward_cache'] / ms['backward_fast']:.3f} x the replayed "
          f"fast backward's; ptxas: " + "; ".join(
              f"{kernel}: {ptxas[kernel]}" for kernel in (
                  "tracer_forward_kernel<false>",
                  "tracer_forward_kernel<true>",
                  "tracer_backward_kernel<0,true>",
                  "tracer_backward_cache_kernel<true>")))
    del cache, p_cache, chans, accum

    # (f) The replayed float32 trainer beside the cached one, from the same
    # state of this phase, for a like-for-like peak and step time.
    cached_cfg = tracer.TraceConfig(fast_math=True, cache_fwd=True)
    out["launches"], out["step_ms"], out["peak_mib"] = {}, {}, {}
    for label, cfg, steps, want in (
            ("replayed", tracer.TraceConfig(), TRAIN_STEPS,
             (TRAIN_STEPS, TRAIN_STEPS, 0, 0, 0, 0, 0)),
            ("cached", cached_cfg, TRAIN_STEPS,
             (0, 0, 0, 0, TRAIN_STEPS, TRAIN_STEPS, 0)),
            ("exact-fast", tracer.TraceConfig(exact_order=True,
                                              fast_math=True),
             EXACT_FAST_STEPS,
             (0, 0, EXACT_FAST_STEPS, 0, 0, 0, EXACT_FAST_STEPS))):
        trainer = make_trainer(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        history = trainer.run(steps, log_every=steps)
        torch.cuda.synchronize()
        got_n = _launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        loss = [h["loss"] for h in history]
        step_ms = []
        for _ in range(0 if label == "exact-fast" else 10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        times = (f"step median {statistics.median(step_ms):.3f} ms (min "
                 f"{min(step_ms):.3f}, max {max(step_ms):.3f}, 10 steps, "
                 f"host clock; phase 8's replayed steps "
                 f"{replay_step_ms:.3f} ms); " if step_ms else "")
        print(f"[cache-train] {card}: {label}, {steps} steps at {H}x{W}: "
              f"launches {dict(zip(LAUNCH_KEYS, got_n))}; {times}peak "
              f"allocated {peak:.1f} MiB; loss {[round(x, 5) for x in loss]}")
        want = _with_prep(want)
        _check(got_n == want, f"{label} training launches {got_n}, want "
               f"{want}")
        _check(all(np.isfinite(loss)), f"{label}: losses finite")
        out["launches"][label] = got_n
        out["peak_mib"][label] = peak
        if step_ms:
            out["step_ms"][label] = statistics.median(step_ms)
            _check(statistics.mean(loss[-5:]) < statistics.mean(loss[:5]),
                   f"{label} training: the loss falls over the run")
        del trainer
    peaks = {}
    for label, cfg in (("default", tracer.TraceConfig()),
                       ("cached", cached_cfg)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        serve(cfg)
        torch.cuda.synchronize()
        peaks[label] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        _check(kernels.forward_cache_launches == 0
               and kernels.forward_launches == 1,
               f"a {label} serving render launches one uncached forward")
    print(f"[cache-serve] {card}: render_scan peak allocated "
          f"{peaks['default']:.1f} MiB in the default configuration, "
          f"{peaks['cached']:.1f} MiB in the cached one (no cache without "
          f"a gradient)")
    _check(peaks["cached"] <= peaks["default"],
           "a serving render's peak memory does not grow with the cache")
    return out


def sensor(dev):
    """The flagship scan's sensor: its grid, the pose of frame 0 (2 m up)
    and the N_FRAMES poses 1 m apart along x."""
    from lidar_rt_tpu_torch.core import rays as rays_lib

    grid = rays_lib.SensorGrid.from_bounds(H, (-0.31, 0.04), pixel_offset=0.5,
                                           device=dev)
    s2w = torch.eye(4, device=dev)
    s2w[2, 3] = 2.0
    poses = s2w.repeat(N_FRAMES, 1, 1)
    poses[:, 0, 3] = torch.arange(N_FRAMES, device=dev, dtype=torch.float32)
    return grid, s2w, poses


def ground_truth(scene, grid, poses):
    """The scene's renders at the poses as recorded frames (phase 8)."""
    from lidar_rt_tpu_torch import sim
    from lidar_rt_tpu_torch.data.frames import LiDARFrames

    with torch.no_grad():
        gt = [sim.render_scan(scene, grid, W, poses[f], f)
              for f in range(N_FRAMES)]
    depth = torch.stack([o["depth"] * (o["channels"][..., 4] > 0.5)
                         for o in gt])
    return LiDARFrames(grid, W, poses.clone(), depth,
                       torch.stack([o["intensity"] for o in gt]))


TIMES_ROUNDS, TIMES_LAUNCHES = 5, 20
GRAPH_TIMED = ("candidate_gather", "candidate_scatter")
PREP_OUTS = ("axes", "plane", "inv_scale", "opac", "sign", "sh")
PREP_GRADS = ("d_means", "d_rotations", "d_scales", "d_opacities", "d_sh")


def _candidate_fns(bundle, origin, assignment, grads, gen) -> dict:
    """The candidate kernels at one render's candidates, for `--times`:
    the gather, and the scatter of the tracer backward's gradients
    `grads`; their plain versions; and, as `library_ms`, what PyTorch ran
    in their place: the gather's advanced indexing of the five fields
    (`indexing`), and autograd's backward of it (`index_put_`), one
    `index_put_(accumulate=True)` per field of per-slot gradients into
    zeroed (N, .) gradients."""
    from lidar_rt_tpu_torch.ops import cuda_tracer, kernels

    prep = (*bundle, origin, assignment.index, assignment.valid)
    args = (bundle, origin, assignment.index, assignment.valid)
    idx = assignment.index.clamp(0, bundle.means.shape[0] - 1)
    per_slot = [torch.randn((*idx.shape, *x.shape[1:]), generator=gen,
                            device=x.device) for x in bundle]

    def index_put():
        for x, g in zip(bundle, per_slot):
            torch.zeros_like(x).index_put_((idx,), g, accumulate=True)

    def indexing():
        for x in bundle:
            x[idx]

    return {
        "candidate_gather": lambda: kernels.candidate_gather(*prep),
        "candidate_scatter": lambda: kernels.candidate_scatter(
            *prep[:4], *prep[5:], *grads),
        "candidate_gather_plain":
            lambda: cuda_tracer.prepare_tile_inputs_reference(*args),
        "candidate_scatter_plain":
            lambda: cuda_tracer.candidate_scatter_reference(*args, *grads),
        "indexing": indexing, "index_put_": index_put}


# The card tests' bars on the candidate kernels (tests/
# test_torch_candidate_prep.py): the gather's axes within GATHER_AXES_ATOL
# and its plane offsets within GATHER_PLANE_REL of their largest magnitude
# of the plain gather's, its copies, reciprocals and folds to the bit; the
# scatter's gradients within SCATTER_REL of each field's largest magnitude
# of the plain scatter's in float64.
GATHER_AXES_ATOL, GATHER_PLANE_REL, SCATTER_REL = 1e-6, 2e-6, 1e-4


def candidate_check(card: str, dev, bundle, origin, assignment, inputs,
                    chans, g_chans, degree: int, gen) -> dict:
    """The candidate gather and scatter at one render's candidates
    `assignment` (phase 8's training render, whose tile inputs, channels
    and channel gradients are `inputs`, `chans`, `g_chans`): the gather
    against `prepare_tile_inputs_reference` and the scatter of the tracer
    backward's gradients against `candidate_scatter_reference` in
    float64, at the card tests' bars; each timed from a CUDA graph of
    TIMES_LAUNCHES launches, beside its bound by bytes
    (`candidate_bound`), its plain version (CUDA events) and PyTorch's
    indexing or `index_put_` (`_candidate_fns`).  Returns {name: (max
    abs err, ms, plain ms, library ms, bound ms)}."""
    from lidar_rt_tpu_torch.core import sh as sh_lib
    from lidar_rt_tpu_torch.ops import cuda_tracer, kernels
    from lidar_rt_tpu_torch.ops.composite import SurfelBundle
    from lidar_rt_tpu_torch.scripts import street

    index, valid = assignment.index, assignment.valid
    kept = sh_lib.kept_coeffs(degree)
    with torch.no_grad():
        grads = kernels.tracer_backward(*inputs, chans, g_chans)
        got = kernels.candidate_gather(*bundle, origin, index, valid, kept)
        want = cuda_tracer.prepare_tile_inputs_reference(
            bundle, origin, index, valid, degree)
        d = kernels.candidate_scatter(*bundle[:4], origin, index, valid,
                                      *grads, kept)
        ref = cuda_tracer.candidate_scatter_reference(
            SurfelBundle(*(x.double() for x in bundle)), origin.double(),
            index, valid, *(x.double() for x in grads), degree)[:5]
        torch.cuda.synchronize()
    # Sign and the opacity fold flip where the plane offset is within
    # rounding of 0: held where it is clear of it.
    scale = want[1].abs().amax()
    clear = want[1][:, 0].abs() > 1e-5 * scale                # (T, K)
    g_err = {name: (a - b).abs().amax().item() for name, a, b in zip(
        PREP_OUTS, got, want) if name not in ("opac", "sign")}
    for i, name in ((3, "opac"), (4, "sign")):
        g_err[name] = ((got[i] - want[i]).abs() * clear).amax().item()
    g_ok = (g_err["axes"] <= GATHER_AXES_ATOL
            and g_err["plane"] <= GATHER_PLANE_REL * scale.item()
            and g_err["inv_scale"] == g_err["sh"] == g_err["opac"]
            == g_err["sign"] == 0.0)
    s_err = {name: ((a.double() - b).abs().amax().item(),
                    SCATTER_REL * b.abs().amax().item())
             for name, a, b in zip(PREP_GRADS, d, ref)}
    fns = _candidate_fns(bundle, origin, assignment, grads, gen)
    ms = {name: street.graph_ms(lambda _i, fn=fns[name]: fn(),
                                TIMES_LAUNCHES, dev).ms
          for name in GRAPH_TIMED}
    plain = {name: _event_ms(fns[name + "_plain"], 3) for name in ms}
    library = {"candidate_gather": _event_ms(fns["indexing"], 5),
               "candidate_scatter": _event_ms(fns["index_put_"], 5)}
    bound_ms = candidate_bound(index, valid, bundle.means.shape[0])
    print(f"[candidate] {card}: phase 8's training render, T x K = "
          f"{tuple(index.shape)}, N = {bundle.means.shape[0]}, SH degree "
          f"{degree}: gather vs plain max abs err " + ", ".join(
              f"{k} {v:.3e}" for k, v in g_err.items())
          + f" (bars: axes {GATHER_AXES_ATOL}, plane {GATHER_PLANE_REL} x "
          f"{scale.item():.3e}, the rest 0; sign and opac where the plane "
          f"is clear of 0); scatter vs plain (float64) max abs err "
          + ", ".join(f"{k} {e:.3e} (bar {b:.3e})"
                      for k, (e, b) in s_err.items()), flush=True)
    print(f"[candidate] {card}: " + "; ".join(
        f"{name} {ms[name]:.4f} ms (CUDA graph of {TIMES_LAUNCHES}), bound "
        f"{bound_ms[name]:.4f} ms (bytes), plain {plain[name]:.4f} ms, "
        f"library {library[name]:.4f} ms" for name in ms)
          + " (library: the gather's five indexings; the scatter's "
          "index_put_ into zeroed gradients)", flush=True)
    _check(g_ok, f"candidate gather vs its plain version: {g_err}")
    _check(all(e <= b for e, b in s_err.values()),
           f"candidate scatter vs its plain version: {s_err}")
    errs = {"candidate_gather": max(g_err.values()),
            "candidate_scatter": max(e for e, _ in s_err.values())}
    return {name: (errs[name], ms[name], plain[name], library[name],
                   bound_ms[name]) for name in ms}


def kernel_times(seed: int, save: str | None, against: str | None) -> None:
    """`--times`: the kernels of the tree this script lies in, built and
    timed without the checks, so that a copy of the script run from a
    checkout of another commit times that commit's kernels the same way:
    run both in one call, in turns.  Prints the ptxas report and occupancy,
    then CUDA-event ms of every kernel mode, TIMES_ROUNDS rounds of
    TIMES_LAUNCHES launches each, all modes in turn within a round (median,
    min and max over the rounds): the tile-order modes at phase 8's
    training inputs (the trainer's tile inputs at pose 0 after 30 steps),
    the exact ones at phase 3's serving inputs; then the candidate gather
    and scatter at the training render's candidates beside their bound,
    their plain versions and `index_put_` (`_candidate_fns`).  The
    kernels' outputs on the serving inputs (deterministic; each backward
    and the scatter run twice, for the atomics' spread) go to `save`; with
    `against`, a file that another tree saved, they are held to it: the
    channels and the gather's outputs to the bit, accum and every gradient
    within 4 x the larger spread of two runs or 1e-5 of the field's
    largest magnitude; the candidate kernels' outputs, which a tree
    without them did not save, are then named and skipped, and any other
    key missing fails."""
    from lidar_rt_tpu_torch.core import rays as rays_lib
    from lidar_rt_tpu_torch.ops import cuda_tracer, kernels, tracer
    from lidar_rt_tpu_torch.scene import compose, scene_from_numpy
    from lidar_rt_tpu_torch.scripts import street
    from lidar_rt_tpu_torch.train import loop, options

    card = _card()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = kernels.build()
    for name, lib in libs.items():
        for kernel, report in ptxas_report(
                lib.with_suffix(".log").read_text()):
            print(f"[times-build] {name} ptxas: {kernel}: {report}")
    k = tracer.TraceConfig().tile.max_per_tile
    print(f"[times-build] K={k}, resident blocks per SM x threads per "
          "block: " + ", ".join(f"{kernel} {b} x {n}" for kernel, (b, n)
                                in kernels.occupancy(k).items()))
    scene = scene_from_numpy(scene_arrays(seed), dev)
    grid, s2w, poses = sensor(dev)
    cfg = tracer.TraceConfig()
    trainer = loop.Trainer(
        scene_from_numpy(perturbed(scene_arrays(seed), seed + 2), dev),
        ground_truth(scene, grid, poses), options.experiment_options(
            seed=seed), cfg)
    trainer.run(TRAIN_STEPS + 10, log_every=TRAIN_STEPS + 10)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        s_bundle, _ = compose(scene, 0)
        serve, s_assign = cuda_tracer.tile_inputs(
            s_bundle, grid, W, s2w, scene.background.active_sh_degree,
            cfg.tile)
        bundle, _ = compose(trainer.state.scene, 0)
        train, t_assign = cuda_tracer.tile_inputs(
            bundle, grid, W, poses[0],
            trainer.state.scene.background.active_sh_degree, cfg.tile)
        del trainer
        chans, accum = kernels.tracer_forward(*serve)
        x_chans, x_accum = kernels.tracer_forward(*serve, exact=True)
        t_chans, _ = kernels.tracer_forward(*train)
        g_serve, g_exact, g_train = (
            torch.randn(c.shape, generator=gen, device=dev)
            for c in (chans, x_chans, t_chans))
        for g in (g_serve, g_exact, g_train):
            g[:, 9:] = 0.0       # raw T: never read by the training loss
        buf = torch.zeros(kernels.cache_shape(train.dirs.shape[0], k,
                                              train.dirs.shape[1]),
                          dtype=torch.bfloat16, device=dev)
        _, _, cache = kernels.tracer_forward(*train, cache=True,
                                             cache_out=buf)
        fns = {
            "forward": lambda: kernels.tracer_forward(*train),
            "forward_cache": lambda: kernels.tracer_forward(
                *train, cache=True, cache_out=buf),
            "backward": lambda: kernels.tracer_backward(*train, t_chans,
                                                        g_train),
            "backward_fast": lambda: kernels.tracer_backward(
                *train, t_chans, g_train, fast=True),
            "backward_cache": lambda: kernels.tracer_backward(
                *train, t_chans, g_train, cache=cache, fast=True),
            "backward_cache_3xtf32": lambda: kernels.tracer_backward(
                *train, t_chans, g_train, cache=cache),
            "forward_serving": lambda: kernels.tracer_forward(*serve),
            "exact_forward": lambda: kernels.tracer_forward(*serve,
                                                            exact=True),
            "exact_backward": lambda: kernels.tracer_backward(
                *serve, x_chans, g_exact, exact=True),
            "exact_backward_fast": lambda: kernels.tracer_backward(
                *serve, x_chans, g_exact, exact=True, fast=True)}
        fns.update(_candidate_fns(bundle, rays_lib.range_rays(
            grid, W, poses[0])[0], t_assign, kernels.tracer_backward(
                *train, t_chans, g_train), gen))
        for name in GRAPH_TIMED:
            fns[name + "_eager"] = fns[name]
        ms = {name: [] for name in fns}
        for _ in range(TIMES_ROUNDS):
            for name, fn in fns.items():
                ms[name].append(street.graph_ms(
                    lambda _i, fn=fn: fn(), TIMES_LAUNCHES, dev).ms
                    if name in GRAPH_TIMED else _event_ms(fn, TIMES_LAUNCHES))
    print(f"[times] {card}: CUDA events, {TIMES_ROUNDS} rounds of "
          f"{TIMES_LAUNCHES} launches ({', '.join(GRAPH_TIMED)} from a CUDA "
          "graph of them, whose eager launches the host paces), median "
          "(min-max): " + ", ".join(
              f"{name} {statistics.median(v):.4f} ({min(v):.4f}-"
              f"{max(v):.4f}) ms" for name, v in ms.items()), flush=True)
    med = {name: statistics.median(v) for name, v in ms.items()}
    b_ms = candidate_bound(t_assign.index, t_assign.valid,
                           bundle.means.shape[0])
    print(f"[times-prep] {card}: phase 8's training render, T x K = "
          f"{tuple(t_assign.index.shape)}, N = {bundle.means.shape[0]}: "
          + "; ".join(f"{name} {med[name]:.4f} ms (eager "
                      f"{med[name + '_eager']:.4f}), bound {b_ms[name]:.4f} "
                      f"ms (bytes), plain {med[name + '_plain']:.4f} ms"
                      for name in b_ms)
          + f"; library_ms (index_put_, autograd's backward of the five "
          f"gathers) {med['index_put_']:.4f} ms", flush=True)
    with torch.no_grad():
        outs = {"chans": chans, "accum": accum, "exact_chans": x_chans,
                "exact_accum": x_accum}
        for label, kw in (("replay", {}), ("replay_fast", {"fast": True}),
                          ("exact", {"exact": True}),
                          ("exact_fast", {"exact": True, "fast": True})):
            c, g = (x_chans, g_exact) if kw.get("exact") else (chans,
                                                                g_serve)
            runs = [kernels.tracer_backward(*serve, c, g, **kw)
                    for _ in range(2)]
            for name, *fields in zip(TWIN_GRADS, *runs):
                outs[f"{label} {name}"] = fields
        prep = (*s_bundle, rays_lib.range_rays(grid, W, s2w)[0],
                s_assign.index, s_assign.valid)
        for name, x in zip(PREP_OUTS, kernels.candidate_gather(*prep)):
            outs[f"prep {name}"] = x
        d_serve = kernels.tracer_backward(*serve, chans, g_serve)
        runs = [kernels.candidate_scatter(*prep[:4], *prep[5:], *d_serve)
                for _ in range(2)]
        for name, *fields in zip(PREP_GRADS, *runs):
            outs[f"prep {name}"] = fields
        torch.cuda.synchronize()
    if save:
        torch.save(outs, save)
    if not against:
        return
    other = torch.load(against, map_location=dev)
    # A tree without the candidate kernels saved no `prep *` outputs.
    missing = [key for key in outs if key not in other]
    for key in missing:
        print(f"[times-against] {key}: not in {against}")
    _check(all(key.startswith("prep ") for key in missing),
           f"{against} holds every output but the candidate kernels': "
           f"{missing} missing")
    exact = ["chans", "exact_chans"] + [f"prep {name}" for name in PREP_OUTS]
    for key in [key for key in exact if key in other]:
        same = torch.equal(outs[key], other[key])
        print(f"[times-against] {key}: {'bit-identical' if same else 'DIFFER'}")
        _check(same, f"{key} against {against}")
    for key in [key for key in outs if key not in exact and key in other]:
        mine = outs[key] if isinstance(outs[key], list) else [outs[key]] * 2
        theirs = (other[key] if isinstance(other[key], list)
                  else [other[key]] * 2)
        spread = max((mine[0] - mine[1]).abs().max().item(),
                      (theirs[0] - theirs[1]).abs().max().item())
        diff = (mine[0] - theirs[0]).abs().max().item()
        bar = max(4.0 * spread, 1e-5 * theirs[0].abs().max().item())
        print(f"[times-against] {key}: max abs diff {diff:.3e}, spread of "
              f"two runs {spread:.3e} (bar {bar:.3e})")
        _check(diff <= bar, f"{key} against {against}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--times", action="store_true",
                        help="only build and time this tree's kernels "
                        "(kernel_times)")
    parser.add_argument("--save", help="with --times: save the kernels' "
                        "outputs on the serving inputs to this file")
    parser.add_argument("--against", help="with --times: hold them to "
                        "another tree's saved outputs")
    args = parser.parse_args()
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.times:
        kernel_times(args.seed, args.save, args.against)
        return

    from lidar_rt_tpu_torch import sim
    from lidar_rt_tpu_torch.ops import cuda_tracer, geometry, kernels, tracer
    from lidar_rt_tpu_torch.scene import compose, scene_from_numpy

    card = _card()
    print(card, flush=True)
    dev = torch.device("cuda", 0)

    # 1. Build.
    t = time.perf_counter()
    libs = kernels.build()
    build_s = time.perf_counter() - t
    print(f"[build] {build_s:.2f} s -> "
          + ", ".join(p.name for p in libs.values()))
    ptxas = {}
    for name, lib in libs.items():
        for kernel, report in ptxas_report(
                lib.with_suffix(".log").read_text()):
            print(f"[build] {name} ptxas: {kernel}: {report}")
            ptxas[kernel] = report
    k_flagship = tracer.TraceConfig().tile.max_per_tile
    print(f"[occupancy] K={k_flagship}, resident blocks per SM x threads "
          "per block: " + ", ".join(
              f"{kernel} {blocks} x {threads}" for kernel, (blocks, threads)
              in kernels.occupancy(k_flagship).items()))

    # 2. Scene.
    t = time.perf_counter()
    scene = scene_from_numpy(scene_arrays(args.seed), dev)
    torch.cuda.synchronize()
    print(f"[scene] {scene.background.capacity} background + "
          f"{scene.num_actors}x{scene.actors.capacity} actor surfels, "
          f"{scene.num_frames} frames, {time.perf_counter() - t:.2f} s")
    grid, s2w, poses = sensor(dev)
    cfg = tracer.TraceConfig()
    degree = scene.background.active_sh_degree

    # 3. Kernel against its plain twin on one render's tile inputs.
    with torch.no_grad():
        bundle, _ = compose(scene, 0)
        inputs, assignment = cuda_tracer.tile_inputs(
            bundle, grid, W, s2w, degree, cfg.tile)
        chans_k, accum_k = kernels.tracer_forward(*inputs)
        chans_p, accum_p = cuda_tracer.forward_tiles_reference(*inputs)
        torch.cuda.synchronize()
    t_total, rays_per_tile = inputs.dirs.shape[:2]
    k = inputs.axes.shape[-1]
    row_err = (chans_k - chans_p).abs().amax(dim=(0, 2))
    kern_err = row_err.max().item()
    kacc_err, kacc_ok = _accum_err(accum_k, accum_p)
    print(f"[kernel] T={t_total} R={rays_per_tile} K={k}: "
          f"{inputs.cnt.float().mean().item():.1f} candidates/tile, "
          f"{int((assignment.truncated > 0).sum())} tiles truncated; "
          f"channels max abs err {kern_err:.3e} (bar {CHAN_ATOL}; rows "
          f"0-8 {row_err[:9].max().item():.3e}, raw-T row 9 "
          f"{row_err[9].item():.3e}), "
          f"accum max abs err {kacc_err:.3e} "
          f"(bar {ACCUM_ATOL} + {ACCUM_RTOL}|ref|)")
    _check(bool(torch.isfinite(chans_k).all()), "kernel channels finite")
    _check(kern_err <= CHAN_ATOL, "kernel channels vs plain twin")
    _check(kacc_ok, "kernel accum vs plain twin")

    # 4. The slice: serve requests through the port's entry points.
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    scan = sim.render_scan(scene, grid, W, s2w, 0)
    seq = sim.resimulate(scene, grid, W, poses)
    torch.cuda.synchronize()
    launches = kernels.forward_launches
    serve_bwd = kernels.backward_launches
    prep_n = {"serve": _prep_launches("serve")}
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    renders = 1 + N_FRAMES
    print(f"[slice] render_scan + resimulate({N_FRAMES}): {renders} renders, "
          f"{launches} forward and {serve_bwd} backward kernel launches")
    _check(launches == renders, f"{launches} launches for {renders} renders")
    _check(serve_bwd == 0, f"{serve_bwd} backward launches while serving")
    for key in ("depth", "intensity", "raydrop"):
        _check(tuple(scan[key].shape) == (H, W), f"render_scan {key} shape")
        _check(tuple(seq[key].shape) == (N_FRAMES, H, W),
               f"resimulate {key} shape")
        _check(bool(torch.isfinite(scan[key]).all()
                    and torch.isfinite(seq[key]).all()), f"{key} finite")
    hit = (scan["channels"][..., 4] > 0.5).float().mean().item()
    _check(hit > 0.25, f"share of rays with accumulated weight > 0.5: "
           f"{hit:.3f}")
    _check(bool((seq["depth"][0] - seq["depth"][-1]).abs().max() > 0.1),
           "moving the sensor changes the scan")
    plain = sim.render_scan(scene, grid, W, s2w, 0,
                            tracer.TraceConfig(engine="torch"))
    torch.cuda.synchronize()
    slice_err = (scan["channels"] - plain["channels"]).abs().max().item()
    sacc_err, sacc_ok = _accum_err(scan["accum_weights"],
                                   plain["accum_weights"])
    print(f"[slice] rays with accum > 0.5: {hit:.3f}, median depth "
          f"{scan['depth'].median().item():.2f} m; vs plain torch engine: "
          f"channels max abs err {slice_err:.3e}, accum {sacc_err:.3e}")
    _check(slice_err <= CHAN_ATOL, "render vs plain torch engine channels")
    _check(sacc_ok, "render vs plain torch engine accum")

    # 5. Times, each beside the card.
    render_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sim.render_scan(scene, grid, W, s2w, 0)
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t) * 1e3)
    plain_render_ms = _event_ms(lambda: sim.render_scan(
        scene, grid, W, s2w, 0, tracer.TraceConfig(engine="torch")), 3)
    with torch.no_grad():
        kernel_ms = _event_ms(lambda: kernels.tracer_forward(*inputs), 20)
        plain_ms = _event_ms(
            lambda: cuda_tracer.forward_tiles_reference(*inputs), 5)
        compose_ms = _event_ms(lambda: compose(scene, 0), 10)
        bin_ms = _event_ms(lambda: cuda_tracer.bin_bundle(
            bundle, grid, W, s2w, cfg.tile), 10)
        prep_ms = _event_ms(lambda: cuda_tracer.tile_inputs(
            bundle, grid, W, s2w, degree, cfg.tile, assignment), 10)
    med = statistics.median(render_ms)
    print(f"[times] {card}: render_scan median {med:.3f} ms "
          f"(min {min(render_ms):.3f}, max {max(render_ms):.3f}, 10 runs, "
          f"host clock); plain torch engine render {plain_render_ms:.3f} ms")
    print(f"[times] {card}: forward kernel {kernel_ms:.3f} ms vs plain twin "
          f"{plain_ms:.3f} ms (CUDA events); stages: compose "
          f"{compose_ms:.3f} ms, bin {bin_ms:.3f} ms, tile inputs "
          f"{prep_ms:.3f} ms")
    print(f"[memory] {card}: peak allocated {peak_mib:.1f} MiB over "
          f"render_scan + resimulate({N_FRAMES})")
    prof = _device_profile(lambda: sim.render_scan(scene, grid, W, s2w, 0), 5)
    if prof is None:
        print(f"[profile] {card}: the trace holds no device events; device "
              "busy time not measured")
    else:
        busy, idle, top, launches_per_render = prof
        print(f"[profile] {card}: render_scan device busy {busy:.3f} ms, "
              f"idle share of the device span {idle:.3f} (upper bound), "
              f"{launches_per_render} device kernels per render")
        for name, ms in top:
            print(f"[profile]   {ms:8.3f} ms  {name[:100]}")

    # 6. Backward kernel against its plain twin, same tile inputs.
    names = ("d_axes", "d_plane", "d_inv_scale", "d_opac", "d_sh")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    g_chans = torch.randn(chans_k.shape, generator=gen, device=dev)
    g_chans[:, 9:] = 0.0     # raw T: never read by the training loss
    with torch.no_grad():
        grads_k = kernels.tracer_backward(*inputs, chans_k, g_chans)
        grads_p = cuda_tracer.backward_tiles_reference(*inputs, chans_k,
                                                       g_chans)
        torch.cuda.synchronize()
    bwd_err = _grad_errors(grads_k, grads_p, names)
    bwd_abs = max((a - b).abs().max().item()
                  for a, b in zip(grads_k, grads_p))
    print(f"[backward] T={t_total} R={rays_per_tile} K={k}: kernel vs "
          f"twin {_fmt_grads(bwd_err)} (bars: cosine > {GRAD_COS}, err <= "
          f"{GRAD_REL} x max|twin|); max abs err {bwd_abs:.3e}")
    for x in grads_k:
        _check(bool(torch.isfinite(x).all()), "backward kernel finite")
    _check_grads(bwd_err, "backward kernel vs twin")
    # The raw-T row's terms: an upstream gradient on row 9, on the same
    # tiles at 1/20 of the opacity, where no ray reaches T_MIN and so the
    # kernel's partial raw T equals the twin's full product.
    faint = inputs._replace(opac=inputs.opac * 0.05)
    with torch.no_grad():
        chans_f, _ = cuda_tracer.forward_tiles_reference(*faint)
        g_faint = torch.randn(chans_k.shape, generator=gen, device=dev)
        g_faint[:, 10:] = 0.0
        grads_fk = kernels.tracer_backward(*faint, chans_f, g_faint)
        grads_fp = cuda_tracer.backward_tiles_reference(*faint, chans_f,
                                                        g_faint)
        torch.cuda.synchronize()
    min_raw_t = chans_f[:, 9].min().item()
    _check(min_raw_t >= geometry.T_MIN,
           f"no ray reaches T_MIN at 1/20 opacity (min raw T {min_raw_t})")
    faint_err = _grad_errors(grads_fk, grads_fp, names)
    bwd_abs = max(bwd_abs, *((a - b).abs().max().item()
                             for a, b in zip(grads_fk, grads_fp)))
    print(f"[backward] 1/20 opacity, upstream on raw T (min raw T "
          f"{min_raw_t:.3f}): kernel vs twin {_fmt_grads(faint_err)}")
    _check_grads(faint_err, "backward kernel vs twin, raw T")
    del faint, chans_f, g_faint, grads_fk, grads_fp

    # 7. Render gradients: kernel path against torch autograd through the
    # plain engine.
    heads = {key: torch.randn((H, W), generator=gen, device=dev)
             for key in ("depth", "intensity", "raydrop")}
    rgrad_err = render_grads(scene, grid, s2w, degree, heads, exact=False)
    print(f"[render-grad] kernel path vs torch engine: "
          f"{_fmt_grads(rgrad_err)}")
    _check_grads(rgrad_err, "render gradients")

    # 8. Training at full width.
    from lidar_rt_tpu_torch.train import loop, options

    frames = ground_truth(scene, grid, poses)
    opts = options.experiment_options(seed=args.seed)
    trainer = loop.Trainer(
        scene_from_numpy(perturbed(scene_arrays(args.seed), args.seed + 2),
                         dev), frames, opts, tracer.TraceConfig())
    # The training render's tile inputs before the first step, and an
    # upstream gradient from the seed: a state the seed alone fixes, where
    # phase 16 holds the cached pair to the float32 replay.
    with torch.no_grad():
        bundle, _ = compose(trainer.state.scene, 0)
        f_inputs, _ = cuda_tracer.tile_inputs(
            bundle, grid, W, poses[0], trainer.state.scene.background
            .active_sh_degree, cfg.tile)
    g_fixed = torch.randn(
        (f_inputs.dirs.shape[0], 16, f_inputs.dirs.shape[1]), device=dev,
        generator=torch.Generator(device=dev).manual_seed(args.seed + 3))
    g_fixed[:, 9:] = 0.0     # raw T: never read by the training loss
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t = time.perf_counter()
    history = trainer.run(TRAIN_STEPS, log_every=TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    train_fwd = kernels.forward_launches
    train_bwd = kernels.backward_launches
    prep_n["train"] = _prep_launches("train")
    train_peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    loss = [h["loss"] for h in history]
    seen = [h["frame"] for h in history]
    rebins = trainer.state.bins.rebins
    want_rebins = expected_rebins(seen, N_FRAMES, trainer.rebin_every)
    print(f"[train] {TRAIN_STEPS} steps at {H}x{W}, "
          f"{trainer.state.scene.background.capacity} + "
          f"{trainer.state.scene.num_actors}x"
          f"{trainer.state.scene.actors.capacity} surfels, rebin every "
          f"{trainer.rebin_every}: {train_fwd} forward and {train_bwd} "
          f"backward kernel launches, {rebins} rebins (expected "
          f"{want_rebins} for frames {seen}); loss first 5 mean "
          f"{statistics.mean(loss[:5]):.5f}, last 5 mean "
          f"{statistics.mean(loss[-5:]):.5f}; {train_s:.2f} s in all")
    print(f"[train] loss per step: {[round(x, 5) for x in loss]}")
    _check(train_fwd == TRAIN_STEPS and train_bwd == TRAIN_STEPS,
           f"{train_fwd} forward / {train_bwd} backward launches for "
           f"{TRAIN_STEPS} steps")
    _check(all(np.isfinite(loss)), "training losses finite")
    for part in ("background", "actors"):
        for name, v in getattr(trainer.state.scene, part).params().items():
            _check(bool(torch.isfinite(v).all()), f"{part}.{name} finite")
    _check(statistics.mean(loss[-5:]) < statistics.mean(loss[:5]),
           "the loss falls over the run")
    _check(rebins == want_rebins and rebins >= 2,
           f"{rebins} rebins, expected {want_rebins}")

    # Times of the training path, each beside the card.
    step_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    with torch.no_grad():
        bundle, _ = compose(trainer.state.scene, 0)
        t_inputs, t_assign = cuda_tracer.tile_inputs(
            bundle, grid, W, poses[0], trainer.state.scene.background
            .active_sh_degree, cfg.tile)
        t_chans, _ = kernels.tracer_forward(*t_inputs)
        g_train = torch.randn(t_chans.shape, generator=gen, device=dev)
        g_train[:, 9:] = 0.0
        fwd_ms = _event_ms(lambda: kernels.tracer_forward(*t_inputs), 20)
        fwd_plain_ms = _event_ms(
            lambda: cuda_tracer.forward_tiles_reference(*t_inputs), 5)
        bwd_ms = _event_ms(lambda: kernels.tracer_backward(
            *t_inputs, t_chans, g_train), 20)
        bwd_plain_ms = _event_ms(lambda: cuda_tracer.backward_tiles_reference(
            *t_inputs, t_chans, g_train), 3)
    # Stages of a step at the training shapes (CUDA events; they include
    # any host gaps): render forward + backward through both kernels with
    # the cached assignment, the Chamfer term forward + backward, and the
    # background's Adam step.
    from lidar_rt_tpu_torch.core import rays as rays_lib
    from lidar_rt_tpu_torch.ops.binning import TileAssignment
    from lidar_rt_tpu_torch.train import losses

    bins = trainer.state.bins
    cached = TileAssignment(bins.index[0, 0], bins.valid[0, 0],
                            torch.zeros_like(bins.index[0, 0, :, 0]))

    def render_backward():
        b, _ = compose(trainer.state.scene, 0)
        out = tracer.render_frame(
            b, grid, W, poses[0],
            trainer.state.scene.background.active_sh_degree, cfg,
            assignment=cached)
        (out["depth"].sum() + out["intensity"].sum()).backward()

    origin, dirs3 = rays_lib.range_rays(grid, W, poses[0])
    candidates = candidate_check(
        card, dev, bundle, origin, t_assign, t_inputs, t_chans, g_train,
        trainer.state.scene.background.active_sh_degree, gen)
    stride = max(1, H * W // opts.opt.cd_max_points)
    gt_pts = origin + dirs3.reshape(-1, 3)[::stride] \
        * frames.depth(0).reshape(-1)[::stride, None]
    cd_mask = frames.mask(0).reshape(-1)[::stride]
    pred_pts = (gt_pts + 0.01 * torch.randn(gt_pts.shape, generator=gen,
                                            device=dev)).requires_grad_()
    render_ms = _event_ms(render_backward, 5)
    cd_ms = _event_ms(lambda: losses.chamfer_loss(
        pred_pts, cd_mask, gt_pts, cd_mask).backward(), 5)
    adam_ms = _event_ms(trainer.state.opt_bg.step, 5)
    print(f"[train-times] {card}: stages: render forward + backward "
          f"{render_ms:.3f} ms, Chamfer ({int(cd_mask.sum())} points) "
          f"forward + backward {cd_ms:.3f} ms, background Adam step "
          f"{adam_ms:.3f} ms")
    replay_step_ms = statistics.median(step_ms)
    print(f"[train-times] {card}: training step median "
          f"{statistics.median(step_ms):.3f} ms (min {min(step_ms):.3f}, "
          f"max {max(step_ms):.3f}, 10 steps, host clock); forward kernel "
          f"{fwd_ms:.3f} ms vs twin {fwd_plain_ms:.3f} ms, backward kernel "
          f"{bwd_ms:.3f} ms vs twin {bwd_plain_ms:.3f} ms (CUDA events, "
          f"the training render's tile inputs)")
    print(f"[train-memory] {card}: peak allocated {train_peak_mib:.1f} MiB "
          f"over {TRAIN_STEPS} training steps")
    prof = _device_profile(trainer.step, 3)
    if prof is None:
        print(f"[train-profile] {card}: the trace holds no device events; "
              "device busy time not measured")
    else:
        busy, idle, top, launches_per_step = prof
        print(f"[train-profile] {card}: training step device busy "
              f"{busy:.3f} ms, idle share of the device span {idle:.3f} "
              f"(upper bound), {launches_per_step} device kernels per step")
        for name, ms in top:
            print(f"[train-profile]   {ms:8.3f} ms  {name[:100]}")

    # 9. Exact-order kernels against their plain twins: phase 3's tile
    # inputs (K=256) and the same render at K=128.
    with torch.no_grad():
        bundle, _ = compose(scene, 0)
        inputs_128, _ = cuda_tracer.tile_inputs(
            bundle, grid, W, s2w, degree,
            dataclasses.replace(cfg.tile, max_per_tile=128))
    exact_fwd_err = exact_bwd_err = 0.0
    for case in (inputs, inputs_128):
        shape = (f"T={case.dirs.shape[0]} R={case.dirs.shape[1]} "
                 f"K={case.axes.shape[-1]}")
        with torch.no_grad():
            ch_x, acc_x = kernels.tracer_forward(*case, exact=True)
            ch_p, acc_p = cuda_tracer.forward_tiles_reference(*case,
                                                              exact=True)
            ch_t, _ = kernels.tracer_forward(*case)
            torch.cuda.synchronize()
        err = (ch_x - ch_p).abs().max().item()
        acc_err, acc_ok = _accum_err(acc_x, acc_p)
        print(f"[exact] forward {shape}: channels max abs err {err:.3e} "
              f"(bar {CHAN_ATOL}), accum {acc_err:.3e} (bar {ACCUM_ATOL} + "
              f"{ACCUM_RTOL}|ref|); differs from tile order by up to "
              f"{(ch_x - ch_t).abs().max().item():.3e}")
        _check(bool(torch.isfinite(ch_x).all()), "exact channels finite")
        _check(err <= CHAN_ATOL, f"exact forward kernel vs twin, {shape}")
        _check(acc_ok, f"exact forward accum vs twin, {shape}")
        exact_fwd_err = max(exact_fwd_err, err)
        g_x = torch.randn(ch_x.shape, generator=gen, device=dev)
        g_x[:, 9:] = 0.0     # raw T: never read by the training loss
        faint = case._replace(opac=case.opac * 0.05)
        with torch.no_grad():
            got = kernels.tracer_backward(*case, ch_x, g_x, exact=True)
            want = cuda_tracer.backward_tiles_reference(*case, ch_x, g_x,
                                                        exact=True)
            ch_f, _ = cuda_tracer.forward_tiles_reference(*faint, exact=True)
            g_f = torch.randn(ch_x.shape, generator=gen, device=dev)
            g_f[:, 10:] = 0.0
            got_f = kernels.tracer_backward(*faint, ch_f, g_f, exact=True)
            want_f = cuda_tracer.backward_tiles_reference(*faint, ch_f, g_f,
                                                          exact=True)
            torch.cuda.synchronize()
        min_raw_t = ch_f[:, 9].min().item()
        _check(min_raw_t >= geometry.T_MIN,
               f"no ray reaches T_MIN at 1/20 opacity ({min_raw_t})")
        for what, a, b in (("opaque", got, want),
                           ("1/20 opacity, upstream on raw T", got_f,
                            want_f)):
            errs = _grad_errors(a, b, names)
            print(f"[exact] backward {shape}, {what}: {_fmt_grads(errs)}")
            for x in a:
                _check(bool(torch.isfinite(x).all()), "exact grads finite")
            _check_grads(errs, f"exact backward kernel vs twin, {shape}, "
                         f"{what}")
            exact_bwd_err = max(exact_bwd_err, *(
                (x - y).abs().max().item() for x, y in zip(a, b)))
        if case is inputs:
            g_exact = g_x
            chans_x = ch_x
        del ch_p, acc_p, ch_t, want, ch_f, got_f, want_f, faint
    del inputs_128
    with torch.no_grad():
        fx_ms = _event_ms(lambda: kernels.tracer_forward(*inputs, exact=True),
                          10)
        fx_plain_ms = _event_ms(lambda: cuda_tracer.forward_tiles_reference(
            *inputs, exact=True), 3)
        ft_ms = _event_ms(lambda: kernels.tracer_forward(*inputs), 10)
        bx_ms = _event_ms(lambda: kernels.tracer_backward(
            *inputs, chans_x, g_exact, exact=True), 10)
        bx_plain_ms = _event_ms(lambda: cuda_tracer.backward_tiles_reference(
            *inputs, chans_x, g_exact, exact=True), 3)
        bt_ms = _event_ms(lambda: kernels.tracer_backward(
            *inputs, chans_k, g_chans), 10)
    exact_work = tracer_work(inputs, exact=True)
    print(f"[exact-times] {card}: T={t_total} R={rays_per_tile} K={k}, "
          f"{exact_work['all_pairs']} pairs, {exact_work['hits']} hits "
          f"composited: forward "
          f"exact kernel {fx_ms:.3f} ms vs twin {fx_plain_ms:.3f} ms (tile "
          f"order {ft_ms:.3f} ms), backward exact kernel {bx_ms:.3f} ms vs "
          f"twin {bx_plain_ms:.3f} ms (tile order {bt_ms:.3f} ms); CUDA "
          f"events")

    # The forward kernels' cull: the (warp, candidate) steps their box test
    # skips, their times at the training and the serving inputs, and the
    # same bits from the same tiles with their rays permuted.
    fwd_times = {}
    works = {("serving", True): exact_work}
    for label, case in (("training", t_inputs), ("serving", inputs)):
        for exact in (False, True):
            if (label, exact) not in works:
                works[label, exact] = tracer_work(case, exact)
        st, sx = works[label, False], works[label, True]
        print(f"[cull] {label} inputs: {st['steps']} (tile, warp, candidate)"
              f" steps, {st['skipped']} skipped by the box test "
              f"({st['skipped'] / st['steps']:.3f}); tile order visits "
              f"{st['visited']} (those its warps reach and the test leaves),"
              f" {st['composited']} of them holding a composited pair, per "
              f"warp mean {st['warp_mean']:.1f}, max {st['warp_max']:.0f}, "
              f"per 128-ray block (its busiest warp) mean "
              f"{st['block_mean']:.1f}, max {st['block_max']:.0f}; exact "
              f"order lists {sx['visited']}, {sx['composited']} of them "
              f"holding a composited pair")
        for exact in (False, True):
            with torch.no_grad():
                fwd_times[label, exact] = _event_ms(
                    lambda: kernels.tracer_forward(*case, exact=exact), 20)
    print(f"[forward-times] {card}: tile order "
          f"{fwd_times['training', False]:.3f} ms at the training inputs, "
          f"{fwd_times['serving', False]:.3f} ms serving; exact order "
          f"{fwd_times['training', True]:.3f} ms training, "
          f"{fwd_times['serving', True]:.3f} ms serving (CUDA events, 20 "
          f"launches each)")
    permuted, order = permuted_rays(inputs, args.seed)
    for label, exact in (("tile order", False), ("exact order", True)):
        with torch.no_grad():
            ch, acc = kernels.tracer_forward(*inputs, exact=exact)
            ch_p, acc_p = kernels.tracer_forward(*permuted, exact=exact)
            torch.cuda.synchronize()
        unpermuted = torch.empty_like(ch_p)
        unpermuted[:, :, order] = ch_p
        same = torch.equal(ch, unpermuted)
        acc_rel = ((acc - acc_p).abs()
                   / acc.abs().clamp_min(1e-30)).max().item()
        print(f"[cull] {label}, rays permuted: channels "
              f"{'bit-identical' if same else 'DIFFER'}, accum max rel "
              f"diff {acc_rel:.3e} (bar 1e-05)")
        _check(same, f"{label} channels with the rays permuted")
        _check(bool(torch.allclose(acc_p, acc, rtol=1e-5, atol=0.0)),
               f"{label} accum with the rays permuted")
    del permuted, ch, acc, ch_p, acc_p, unpermuted

    # 10. Serving in the other modes, each against the torch engine in the
    # same mode, with each mode's launches counted.
    exact_cfg = tracer.TraceConfig(exact_order=True)
    kernels.reset_launches()
    scan_x = sim.render_scan(scene, grid, W, s2w, 0, exact_cfg)
    seq_x = sim.resimulate(scene, grid, W, poses, cfg=exact_cfg)
    torch.cuda.synchronize()
    serve_exact = kernels.forward_exact_launches
    prep_n["serve_exact"] = _prep_launches("serve_exact")
    _check((serve_exact, kernels.forward_launches, kernels.backward_launches,
            kernels.backward_exact_launches) == (renders, 0, 0, 0),
           f"{serve_exact} exact forward launches for {renders} renders, "
           f"{kernels.forward_launches} tile-order")
    for key in ("depth", "intensity", "raydrop"):
        _check(tuple(seq_x[key].shape) == (N_FRAMES, H, W)
               and bool(torch.isfinite(seq_x[key]).all()),
               f"exact resimulate {key}")
    plain_x = sim.render_scan(scene, grid, W, s2w, 0, tracer.TraceConfig(
        exact_order=True, engine="torch"))
    err_x = (scan_x["channels"] - plain_x["channels"]).abs().max().item()
    acc_err, acc_ok = _accum_err(scan_x["accum_weights"],
                                 plain_x["accum_weights"])
    print(f"[serve-exact] render_scan + resimulate({N_FRAMES}) in exact "
          f"order: {serve_exact} exact forward launches; vs torch engine: "
          f"channels max abs err {err_x:.3e}, accum {acc_err:.3e}; differs "
          f"from the tile-order scan by up to "
          f"{(scan_x['channels'] - scan['channels']).abs().max().item():.3e}")
    _check(err_x <= CHAN_ATOL, "exact render vs torch engine channels")
    _check(acc_ok, "exact render vs torch engine accum")

    kernels.reset_launches()
    with torch.no_grad():
        bundle, _ = compose(scene, 0)
        ret1, ret2 = tracer.render_multi_return(bundle, grid, W, s2w, degree)
        torch.cuda.synchronize()
        multi = kernels.forward_launches
        prep_n["serve_multi_return"] = _prep_launches("serve_multi_return")
        _check((multi, kernels.forward_exact_launches) == (2, 0),
               f"{multi} forward launches for two returns")
        torch_cfg = tracer.TraceConfig(engine="torch")
        ref1 = tracer.render_frame(bundle, grid, W, s2w, degree, torch_cfg)
        ref2 = tracer.trace(bundle, grid, W, s2w,
                            torch.tensor([0.0, 0.0, 1.0], device=dev),
                            degree, torch_cfg,
                            min_depth=ret1["depth"].clamp_min(0.0) + 1.0)
    err1 = (ret1["channels"] - ref1["channels"]).abs().max().item()
    err2 = (ret2["channels"] - ref2.channels).abs().max().item()
    second = (ret2["channels"][..., 4] > 0.5).float().mean().item()
    print(f"[serve-multi] render_multi_return: {multi} forward launches, "
          f"rays with a second return (accum > 0.5) {second:.3f}; vs torch "
          f"engine at the same min depth: return 1 channels {err1:.3e}, "
          f"return 2 {err2:.3e}")
    _check(err1 <= CHAN_ATOL and err2 <= CHAN_ATOL,
           "dual returns vs torch engine")
    _check(bool(torch.isfinite(ret2["channels"]).all()) and second > 0.0,
           "second return finite, some rays return twice")

    tail_cfg = tracer.TraceConfig(tail_passes=1)
    kernels.reset_launches()
    scan_t = sim.render_scan(scene, grid, W, s2w, 0, tail_cfg)
    torch.cuda.synchronize()
    serve_tail = kernels.forward_launches
    prep_n["serve_tail"] = _prep_launches("serve_tail")
    _check((serve_tail, kernels.forward_exact_launches) == (2, 0),
           f"{serve_tail} forward launches for a one-tail-pass scan")
    plain_t = sim.render_scan(scene, grid, W, s2w, 0, tracer.TraceConfig(
        tail_passes=1, engine="torch"))
    err_t = (scan_t["channels"] - plain_t["channels"]).abs().max().item()
    acc_err, acc_ok = _accum_err(scan_t["accum_weights"],
                                 plain_t["accum_weights"])
    gain = (scan_t["channels"][..., 4] - scan["channels"][..., 4]).max()
    print(f"[serve-tail] render_scan with one tail pass: {serve_tail} "
          f"forward launches; vs torch engine: channels max abs err "
          f"{err_t:.3e}, accum {acc_err:.3e}; the tail pass adds up to "
          f"{gain.item():.3e} accumulated weight to a ray")
    _check(err_t <= CHAN_ATOL, "tail render vs torch engine channels")
    _check(acc_ok, "tail render vs torch engine accum")
    mode_ms = {}
    for label, fn in (
            ("exact render_scan", lambda: sim.render_scan(
                scene, grid, W, s2w, 0, exact_cfg)),
            ("tail render_scan", lambda: sim.render_scan(
                scene, grid, W, s2w, 0, tail_cfg)),
            ("render_multi_return", lambda: tracer.render_multi_return(
                bundle, grid, W, s2w, degree))):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.no_grad():
                fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        mode_ms[label] = statistics.median(times)
    print(f"[serve-times] {card}: median of 5, host clock: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in mode_ms.items()))
    del scan_x, seq_x, plain_x, ret1, ret2, ref1, ref2, scan_t, plain_t

    # 11. Exact-order render gradients against torch autograd through the
    # plain engine.
    xgrad_err = render_grads(scene, grid, s2w, degree, heads, exact=True)
    print(f"[render-grad-exact] kernel path vs torch engine: "
          f"{_fmt_grads(xgrad_err)}")
    _check_grads(xgrad_err, "exact render gradients")

    # 12. Training in the other modes.
    del trainer, bins, cached
    mode_launches = {}
    for label, mode_cfg, want in (
            ("exact", exact_cfg, (0, 0, MODE_STEPS, MODE_STEPS)),
            ("tail", tail_cfg, (2 * MODE_STEPS, 2 * MODE_STEPS, 0, 0))):
        trainer = loop.Trainer(
            scene_from_numpy(perturbed(scene_arrays(args.seed),
                                       args.seed + 2), dev),
            frames, opts, mode_cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        step_ms = []
        for _ in range(MODE_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            trainer.run(1, log_every=1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        got = (kernels.forward_launches, kernels.backward_launches,
               kernels.forward_exact_launches,
               kernels.backward_exact_launches)
        mode_peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        mode_launches[label] = got
        prep_n[f"train_{label}"] = _prep_launches(f"train_{label}")
        loss = [h["loss"] for h in trainer.history]
        seen = [h["frame"] for h in trainer.history]
        rebins = trainer.state.bins.rebins
        want_rebins = expected_rebins(seen, N_FRAMES, trainer.rebin_every)
        print(f"[train-{label}] {card}: {MODE_STEPS} steps at {H}x{W}, "
              f"K={mode_cfg.tile.max_per_tile}: launches (forward, backward, "
              f"exact forward, exact backward) {got}, {rebins} rebins "
              f"(expected {want_rebins} for frames {seen}); loss "
              f"{[round(x, 5) for x in loss]}; step median "
              f"{statistics.median(step_ms):.3f} ms (min {min(step_ms):.3f},"
              f" max {max(step_ms):.3f}, host clock); peak allocated "
              f"{mode_peak_mib:.1f} MiB")
        _check(got == want, f"{label} training launches {got}, want {want}")
        _check(rebins == want_rebins, f"{label}: {rebins} rebins, expected "
               f"{want_rebins}")
        _check(all(np.isfinite(loss)), f"{label} training losses finite")
        for part in ("background", "actors"):
            for name, v in getattr(trainer.state.scene,
                                   part).params().items():
                _check(bool(torch.isfinite(v).all()),
                       f"{label}: {part}.{name} finite")
        half = MODE_STEPS // 2
        _check(statistics.mean(loss[-half:]) < statistics.mean(loss[:half]),
               f"{label}: the loss falls over the run")
        del trainer

    # 13. The data path: files on disk to an assembled, trained scene;
    # 14. the CLI on phase 13's Waymo segment, before it is removed.
    # 15. The scale-out path on the segment's assembled scene.
    # 17. The reference-checkpoint round trip from phase 14's checkpoint.
    with tempfile.TemporaryDirectory() as tmp:
        data = data_phase(args.seed, card, dev, gen, tmp)
        cli_runs = cli_phase(tmp, card, dev)
        sharded = sharded_phase(tmp, card, dev, args.seed)
        roundtrip = import_phase(tmp, card, dev)
        # 18. The rehearsal runner on both of phase 13's datasets.
        runner = runner_phase(tmp, card)
        # 20. The user tools; refine_spread on phase 14's checkpoint.
        tools = tools_phase(tmp, card, dev, gen)
    # 16. The training modes at the flagship shape.
    cached = cache_phase(
        card, dev, f_inputs, g_fixed, t_inputs, g_train, inputs, chans_x,
        g_exact,
        lambda cfg: loop.Trainer(scene_from_numpy(perturbed(
            scene_arrays(args.seed), args.seed + 2), dev), frames, opts,
            cfg),
        lambda cfg: sim.render_scan(scene, grid, W, s2w, 0, cfg),
        replay_step_ms, ptxas)
    # 19. The probe kernels.
    probes = probe_phase(card, args.seed, ptxas)
    # 21. The design probes on the street scene.
    design = design_phase(card, dev, args.seed)
    # 22. The bench and its six stage profilers.
    benched = bench_phase(card, dev)
    kern_err = max(kern_err, data["fwd_err"], sharded["fwd_err"])
    bwd_abs = max(bwd_abs, data["bwd_err"], sharded["bwd_err"])
    exact_fwd_err = max(exact_fwd_err, sharded["fwd_x_err"])
    exact_bwd_err = max(exact_bwd_err, sharded["bwd_x_err"])
    fwd_c_err = max(cached["fwd_c_err"], data["fwd_c_err"],
                    sharded["fwd_c_err"])
    bwd_c_err = max(cached["bwd_c_err"], data["bwd_c_err"],
                    sharded["bwd_c_err"])
    # Each tile-order kernel's largest error at the tools' shapes, by tool,
    # and at the sweep's shapes.
    tool_errs = {key: {t: e[key] for t, e in {**tools["errs"],
                                              **design["errs"]}.items()}
                 for key in ("fwd", "bwd", "fwd_c", "bwd_c")}
    tool_errs["fwd"].update(benched["errs"])
    kern_err = max(kern_err, *tool_errs["fwd"].values())
    bwd_abs = max(bwd_abs, *tool_errs["bwd"].values())
    fwd_c_err = max(fwd_c_err, *tool_errs["fwd_c"].values())
    bwd_c_err = max(bwd_c_err, *tool_errs["bwd_c"].values())
    errs_by_path = {"tracer_forward": tool_errs["fwd"],
                    "tracer_backward": tool_errs["bwd"],
                    "tracer_forward_cache": tool_errs["fwd_c"],
                    "tracer_backward_cache": tool_errs["bwd_c"]}
    bwd_xf_err = max(cached["bwd_xf_err"], sharded["bwd_xf_err"])
    shard_n = sharded["launches"]

    fwd_paths = {"serve": launches, "train": train_fwd,
                 "serve_multi_return": multi, "serve_tail": serve_tail,
                 "train_tail": mode_launches["tail"][0], **data["fwd_paths"],
                 **cli_runs["fwd_paths"], "sharded": shard_n["fwd"],
                 "import_rt_finetune": roundtrip["fine"]["fwd"],
                 "import_rt_eval": roundtrip["eval"]["fwd"],
                 **runner["fwd_paths"], **tools["fwd_paths"],
                 **design["fwd_paths"], **benched["paths"]["fwd"]}
    bwd_paths = {"train": train_bwd, "train_tail": mode_launches["tail"][1],
                 **data["bwd_paths"], "sharded": shard_n["bwd"],
                 **design["bwd_paths"], **benched["paths"]["bwd"]}
    fwd_x_paths = {"serve_exact": serve_exact,
                   "train_exact": mode_launches["exact"][2],
                   "sharded": shard_n["fwd_x"],
                   "train_exact_fast": cached["launches"]["exact-fast"][2],
                   **data["fwd_x_paths"], **benched["paths"]["fwd_x"]}
    bwd_x_paths = {"train_exact": mode_launches["exact"][3],
                   "sharded": shard_n["bwd_x"]}
    fwd_c_paths = {**data["fwd_c_paths"], **cli_runs["fwd_c_paths"],
                   "sharded": shard_n["fwd_c"],
                   "train_cached": cached["launches"]["cached"][4],
                   "import_rt_finetune": roundtrip["fine"]["fwd_c"],
                   **runner["fwd_c_paths"], **tools["fwd_c_paths"],
                   **design["fwd_c_paths"], **benched["paths"]["fwd_c"]}
    bwd_c_paths = {**data["bwd_c_paths"], **cli_runs["bwd_c_paths"],
                   "sharded": shard_n["bwd_c"],
                   "train_cached": cached["launches"]["cached"][5],
                   "import_rt_finetune": roundtrip["fine"]["bwd_c"],
                   **runner["bwd_c_paths"], **tools["bwd_c_paths"],
                   **design["bwd_c_paths"], **benched["paths"]["bwd_c"]}
    bwd_xf_paths = {"sharded": shard_n["bwd_xf"],
                    "train_exact_fast": cached["launches"]["exact-fast"][6],
                    **data["bwd_xf_paths"], **benched["paths"]["bwd_xf"]}
    # The candidate gather serves every render pass, its scatter every
    # pass with a gradient.
    prep_g_paths = {**{p: g for p, (g, _) in prep_n.items()},
                    "train_cached": cached["launches"]["cached"][7],
                    "train_exact_fast": cached["launches"]["exact-fast"][7],
                    **data["prep_g_paths"], **cli_runs["prep_g_paths"],
                    "sharded": shard_n["prep_g"],
                    "import_rt_finetune": roundtrip["fine"]["prep_g"],
                    "import_rt_eval": roundtrip["eval"]["prep_g"],
                    **runner["prep_g_paths"], **tools["prep_g_paths"],
                    **design["prep_g_paths"], **benched["paths"]["prep_g"]}
    prep_s_paths = {**{p: prep_n[p][1] for p in ("train", "train_tail",
                                                 "train_exact")},
                    "train_cached": cached["launches"]["cached"][8],
                    "train_exact_fast": cached["launches"]["exact-fast"][8],
                    **data["prep_s_paths"], **cli_runs["prep_s_paths"],
                    "sharded": shard_n["prep_s"],
                    "import_rt_finetune": roundtrip["fine"]["prep_s"],
                    **runner["prep_s_paths"], **tools["prep_s_paths"],
                    **design["prep_s_paths"], **benched["paths"]["prep_s"]}
    train_work = works["training", False]
    # (inputs, work, backward, cache, fast) of each kernel's bound.
    kernel_work = {
        "tracer_forward": (t_inputs, train_work, False, False, False),
        "tracer_backward": (t_inputs, train_work, True, False, False),
        "tracer_forward_exact": (inputs, exact_work, False, False, False),
        "tracer_backward_exact": (inputs, exact_work, True, False, False),
        "tracer_forward_cache": (t_inputs, train_work, False, True, False),
        "tracer_backward_cache": (t_inputs, train_work, True, True, True),
        "tracer_backward_exact_fast": (inputs, exact_work, True, False,
                                       True)}
    cms = cached["ms"]
    entries = [
        ("tracer_forward", "lidar_rt_tpu_torch/csrc/tracer_forward.cu",
         "lidar_rt_tpu/ops/pallas_tracer.py:120", fwd_paths, kern_err,
         fwd_ms, fwd_plain_ms),
        ("tracer_backward", "lidar_rt_tpu_torch/csrc/tracer_backward.cu",
         "lidar_rt_tpu/ops/pallas_backward.py:52", bwd_paths, bwd_abs,
         bwd_ms, bwd_plain_ms),
        ("tracer_forward_exact", "lidar_rt_tpu_torch/csrc/tracer_forward.cu",
         "lidar_rt_tpu/ops/pallas_sort.py:30 (in pallas_tracer.py:120)",
         fwd_x_paths, exact_fwd_err, fx_ms, fx_plain_ms),
        ("tracer_backward_exact",
         "lidar_rt_tpu_torch/csrc/tracer_backward.cu",
         "lidar_rt_tpu/ops/pallas_sort.py:30 (in pallas_backward.py:52)",
         bwd_x_paths, exact_bwd_err, bx_ms, bx_plain_ms),
        ("tracer_forward_cache", "lidar_rt_tpu_torch/csrc/tracer_forward.cu",
         "lidar_rt_tpu/ops/pallas_tracer.py:286 (cache_fwd, in "
         "pallas_tracer.py:120)", fwd_c_paths, fwd_c_err,
         cms["forward_cache"], cms["forward_cache_twin"]),
        ("tracer_backward_cache",
         "lidar_rt_tpu_torch/csrc/tracer_backward.cu",
         "lidar_rt_tpu/ops/pallas_backward.py:183 (cache_fwd, in "
         "pallas_backward.py:52)", bwd_c_paths, bwd_c_err,
         cms["backward_cache"], cms["backward_cache_twin"]),
        ("tracer_backward_exact_fast",
         "lidar_rt_tpu_torch/csrc/tracer_backward.cu",
         "lidar_rt_tpu/ops/pallas_backward.py:127 (fast_math, in "
         "pallas_backward.py:52)", bwd_xf_paths, bwd_xf_err,
         cms["exact_backward_fast"], bx_plain_ms),
    ]
    entries = [e + (bound(*kernel_work[e[0]][:3], True,
                          *kernel_work[e[0]][3:]),) for e in entries]
    for name, _src, _rep, paths, _err, ms, _plain, (b_ms, b_by) in entries:
        case, work, backward, cache, fast = kernel_work[name]
        print(f"[bound] {card}: {name} {ms:.3f} ms against a bound of "
              f"{b_ms:.4f} ms ({b_by}; {work['tests']} box tests, "
              f"{work['pairs']} pairs they leave, {work['hits']} hits "
              f"composited; with no box test, {work['all_pairs']} pairs: "
              f"{bound(case, work, backward, False, cache, fast)[0]:.4f} "
              f"ms); launches {paths}")
        _check(all(n > 0 for n in paths.values()),
               f"{name} launched on every path it serves: {paths}")
    for name, _src, _rep, paths, _err, ms, _plain, (b_ms, b_by) in probes:
        print(f"[bound] {card}: {name} {ms:.4f} ms against a bound of "
              f"{b_ms:.4f} ms ({b_by}); launches {paths}")
        _check(all(n > 0 for n in paths.values()),
               f"{name} launched on its probe's path: {paths}")
    library_ms = {name: c[3] for name, c in candidates.items()}
    prep = [(name, "lidar_rt_tpu_torch/csrc/candidate_prep.cu", replaces,
             paths, *candidates[name][:3], (candidates[name][4], "bytes"))
            for name, replaces, paths in (
                ("candidate_gather", "lidar_rt_tpu/ops/pallas_tracer.py:428 "
                 "(XLA's gather)", prep_g_paths),
                ("candidate_scatter", "lidar_rt_tpu/ops/pallas_tracer.py:428 "
                 "(XLA's transpose of the gather)", prep_s_paths))]
    for name, _src, _rep, paths, _err, ms, _plain, (b_ms, b_by) in prep:
        print(f"[bound] {card}: {name} {ms:.4f} ms against a bound of "
              f"{b_ms:.4f} ms ({b_by}); library {library_ms[name]:.4f} ms; "
              f"launches {paths}")
        _check(all(n > 0 for n in paths.values()),
               f"{name} launched on every path it serves: {paths}")
    entries += prep + probes
    print(f"[total] {card}: chip_smoke.py {time.perf_counter() - t_script:.1f}"
          f" s (host clock, the build included)", flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": sum(paths.values()),
        "launches_by_path": paths, "max_abs_err": err,
        "max_abs_err_by_path": errs_by_path.get(name, {}), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms.get(name),
    } for name, source, replaces, paths, err, ms, plain_ms, (b_ms, b_by)
        in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
