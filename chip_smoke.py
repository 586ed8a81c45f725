"""Chip smoke run of the PyTorch/CUDA port (`lidar_rt_tpu_torch`).

    python3 chip_smoke.py [--seed 0]

On one CUDA card it:
  1. builds the CUDA forward and backward tracer kernels from
     `lidar_rt_tpu_torch/csrc` (one nvcc each, started together);
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
     peak memory and a device profile of one step.

Every failed check raises.  Without a CUDA device it exits non-zero before
any phase.  The last two lines of standard output are the kernel table
{"kernels": [...]} and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import time

import numpy as np
import torch

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
TRAIN_STEPS = 20


def street_soup(n: int, seed: int) -> dict[str, np.ndarray]:
    """bench.py's street-like surfel soup (ground annulus + wall bands),
    drawn in the same order from the same generator: activated arrays."""
    rng = np.random.default_rng(seed)
    n_ground = n // 2
    n_wall = n - n_ground
    r = np.sqrt(rng.uniform(3.0 ** 2, 60.0 ** 2, n_ground))
    th = rng.uniform(-np.pi, np.pi, n_ground)
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       rng.normal(0, 0.05, n_ground)], 1)
    x = rng.uniform(-60, 60, n_wall)
    side = rng.choice([-1, 1], n_wall)
    y = side * rng.uniform(6, 25, n_wall)
    z = rng.uniform(0, 6, n_wall)
    means = np.concatenate([ground, np.stack([x, y, z], 1)]).astype(np.float32)
    quats = np.zeros((n, 4), np.float32)
    quats[:n_ground, 0] = 1.0
    quats[n_ground:, 0] = np.sqrt(0.5)
    quats[n_ground:, 1] = np.sqrt(0.5)
    quats += rng.normal(0, 0.1, (n, 4)).astype(np.float32)
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0, :] = rng.uniform(-0.5, 1.0, (n, 3))
    scales = rng.uniform(0.1, 0.35, (n, 2)).astype(np.float32)
    opacities = rng.uniform(0.3, 0.95, n).astype(np.float32)
    return {"means": means, "rotations": quats, "scales": scales,
            "opacities": opacities, "sh": sh}


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


def _device_profile(fn, iters: int):
    """Device time over `iters` calls of fn from a torch.profiler trace:
    (busy ms per call, idle share of the device span from the first
    kernel's start to the last one's end, top kernels as (name, ms per
    call), device kernels per call), or None when the trace holds no
    device events.  Only kernels, copies and memsets count: the device-side
    ranges of profiler annotations (such as `Optimizer.step#Adam.step`)
    cover kernels already counted.  Busy time is the union of their
    intervals.  The profiler slows the host's launches, so the idle share
    is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and "annotation" not in str(getattr(e, "activity_type", ""))]
    if not events:
        return None
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    by_name = collections.Counter()
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us()
    top = [(name, us / iters / 1e3) for name, us in by_name.most_common(6)]
    return busy / iters / 1e3, 1.0 - busy / span, top, len(events) // iters


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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from lidar_rt_tpu_torch import sim
    from lidar_rt_tpu_torch.core import rays as rays_lib
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
    for name, lib in libs.items():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name} ptxas: {line.strip()}")

    # 2. Scene.
    t = time.perf_counter()
    scene = scene_from_numpy(scene_arrays(args.seed), dev)
    torch.cuda.synchronize()
    print(f"[scene] {scene.background.capacity} background + "
          f"{scene.num_actors}x{scene.actors.capacity} actor surfels, "
          f"{scene.num_frames} frames, {time.perf_counter() - t:.2f} s")
    grid = rays_lib.SensorGrid.from_bounds(H, (-0.31, 0.04), pixel_offset=0.5,
                                           device=dev)
    s2w = torch.eye(4, device=dev)
    s2w[2, 3] = 2.0
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
    poses = s2w.repeat(N_FRAMES, 1, 1)
    poses[:, 0, 3] = torch.arange(N_FRAMES, device=dev, dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.forward_launches = 0
    kernels.backward_launches = 0
    scan = sim.render_scan(scene, grid, W, s2w, 0)
    seq = sim.resimulate(scene, grid, W, poses)
    torch.cuda.synchronize()
    launches = kernels.forward_launches
    serve_bwd = kernels.backward_launches
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
    fields = ("means", "rotations", "scales", "opacities", "sh")
    heads = {key: torch.randn((H, W), generator=gen, device=dev)
             for key in ("depth", "intensity", "raydrop")}
    render_grads = {}
    for engine in ("cuda", "torch"):
        with torch.no_grad():
            bundle, _ = compose(scene, 0)
        leaf = bundle._replace(**{f: getattr(bundle, f).clone()
                                  .requires_grad_() for f in fields})
        out = tracer.render_frame(leaf, grid, W, s2w, degree,
                                  tracer.TraceConfig(engine=engine))
        sum((out[key] * w).sum() for key, w in heads.items()).backward()
        render_grads[engine] = [getattr(leaf, f).grad for f in fields]
        del out, leaf
    torch.cuda.synchronize()
    rgrad_err = _grad_errors(render_grads["cuda"], render_grads["torch"],
                             fields)
    print(f"[render-grad] kernel path vs torch engine: "
          f"{_fmt_grads(rgrad_err)}")
    _check_grads(rgrad_err, "render gradients")
    del render_grads

    # 8. Training at full width.
    from lidar_rt_tpu_torch.data.frames import LiDARFrames
    from lidar_rt_tpu_torch.train import loop, options

    with torch.no_grad():
        gt = [sim.render_scan(scene, grid, W, poses[f], f)
              for f in range(N_FRAMES)]
    depth = torch.stack([o["depth"] * (o["channels"][..., 4] > 0.5)
                         for o in gt])
    frames = LiDARFrames(grid, W, poses.clone(), depth,
                         torch.stack([o["intensity"] for o in gt]))
    del gt
    opts = options.experiment_options(seed=args.seed)
    trainer = loop.Trainer(
        scene_from_numpy(perturbed(scene_arrays(args.seed), args.seed + 2),
                         dev), frames, opts, tracer.TraceConfig())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.forward_launches = 0
    kernels.backward_launches = 0
    t = time.perf_counter()
    history = trainer.run(TRAIN_STEPS, log_every=TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    train_fwd = kernels.forward_launches
    train_bwd = kernels.backward_launches
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
        t_inputs, _ = cuda_tracer.tile_inputs(
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
    cached = TileAssignment(bins.index[0], bins.valid[0],
                            torch.zeros_like(bins.index[0, :, 0]))

    def render_backward():
        b, _ = compose(trainer.state.scene, 0)
        out = tracer.render_frame(
            b, grid, W, poses[0],
            trainer.state.scene.background.active_sh_degree, cfg,
            assignment=cached)
        (out["depth"].sum() + out["intensity"].sum()).backward()

    origin, dirs3 = rays_lib.range_rays(grid, W, poses[0])
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

    print(json.dumps({"kernels": [{
        "name": "tracer_forward",
        "route": "cuda",
        "source": "lidar_rt_tpu_torch/csrc/tracer_forward.cu",
        "replaces": "lidar_rt_tpu/ops/pallas_tracer.py:120",
        "launches": train_fwd,
        "launches_by_path": {"serve": launches, "train": train_fwd},
        "max_abs_err": kern_err,
        "ms": fwd_ms,
        "plain_ms": fwd_plain_ms,
    }, {
        "name": "tracer_backward",
        "route": "cuda",
        "source": "lidar_rt_tpu_torch/csrc/tracer_backward.cu",
        "replaces": "lidar_rt_tpu/ops/pallas_backward.py:52",
        "launches": train_bwd,
        "launches_by_path": {"serve": serve_bwd, "train": train_bwd},
        "max_abs_err": bwd_abs,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
