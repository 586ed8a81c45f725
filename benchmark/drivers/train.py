"""The `train_late` traffic: `Trainer.step` (`train/loop.py`) driven as `cli
train` drives it, at a late point of the configuration's schedule.

Set-up builds one trainer from the configuration's scene (the surfel
maker's assets, padded to the assembly's capacities with dead slots) and
frames, sets its iteration and its optimizers' step counts to the
schedule point (learning rates, SH degree, no densification or opacity
reset past densify_until_iter, K=256 with the tail pass), and drives its
first `check_steps` steps through `Trainer.step`, recording what they
produced: each step's loss terms, the first step's render, the first
gradient as Adam holds it after one step (exp_avg / (1 - beta1)), and the
parameters after the checked steps.  The same trainer then warms up and
runs the window, its metrics fetched every `log_every` iterations; there
are no held-out evals and no checkpoints.  Once the window has closed and
the peak is read, the trainer's state (leaves, Adam's moments and step
counts, alive masks) is copied to the host and the same trainer takes
`late_steps` more steps, its frames binned afresh, recorded the same way.

Every record is kept on the host, and the benchmark's own copy of the
scene moves there once the program holds its own, so that the device's
peak is the program's.  `correct` holds the records to the plain
reference (`reference/train.py`), which trains its own copy of the same
inputs through the same frames, from the start and from the copied state.
"""

from __future__ import annotations

import math
import sys
import time
from types import SimpleNamespace

import torch

from benchmark import trace as trace_lib
from benchmark import work
from benchmark.drivers import common
from benchmark.reference import render as ref
from benchmark.reference import train as ref_train

Tensor = torch.Tensor
NUMBERS = ("render_rel", "loss_rel", "grad1_rel", "change_rel",
           "late_loss_rel", "late_change_med")
GROUP_FIELDS = {"xyz": "xyz", "f_dc": "f_dc", "f_rest": "f_rest",
                "opacity": "opacity_logit", "scaling": "log_scale",
                "rotation": "quat"}
DEAD = {"xyz": 0.0, "f_dc": 0.0, "f_rest": 0.0, "opacity": -30.0,
        "scaling": -10.0}
TERMS = ("loss", "depth", "intensity", "raydrop", "cd", "reg")


def host(x: Tensor) -> Tensor:
    """A copy of x on the host (a copy also where x is there already)."""
    return x.detach().to("cpu", copy=True)


def round_capacity(n: int, headroom: float, multiple: int = 1024) -> int:
    """The assembly's padded capacity (`data/build.py`)."""
    target = max(n, int(n * max(headroom, 1.0)))
    return max(multiple, -(-target // multiple) * multiple)


def padded(asset, capacity: int) -> tuple[dict, Tensor]:
    """An asset's raw leaves by optimizer group, padded to `capacity` with
    the assembly's dead slots, and its alive mask."""
    n = asset.xyz.shape[0]
    dev = asset.xyz.device
    out = {}
    for g, field in GROUP_FIELDS.items():
        x = getattr(asset, field)
        pad = torch.empty((capacity - n, *x.shape[1:]), device=dev)
        if g == "rotation":
            pad.zero_()
            pad[:, 0] = 1.0
        else:
            pad.fill_(DEAD[g])
        out[g] = torch.cat([x, pad])
    alive = torch.zeros(capacity, dtype=torch.bool, device=dev)
    alive[:n] = True
    return out, alive


class Scene:
    """The configuration's trainable inputs, in the benchmark's own
    tensors: padded leaves, alive masks, extents and the vehicles' boxes
    per frame."""

    def __init__(self, inputs: common.Inputs, cfg: dict):
        s, sc = inputs.surf, cfg["surfels"]
        model = cfg["schedule"]["model"]
        head = float(sc["capacity_headroom"])
        # Capacities are the assembly's, from the counts it started with.
        asm = sc["assembled"]
        pts = s.background.xyz
        self.device = pts.device
        self.bg, self.bg_alive = padded(
            s.background, round_capacity(int(asm["background"]), head))
        center = pts.double().mean(0).float()
        diam = 2.0 * torch.linalg.vector_norm(pts - center, dim=1)
        self.bg_extent = float(model["bkgd_extent_factor"]) * float(
            torch.quantile(diam.double(), 0.90))
        self.actors = None
        if s.actors:
            cap = round_capacity(int(asm["per_actor"]), head / 2.0)
            parts = [padded(a, cap) for a in s.actors]
            self.actors = {g: torch.stack([p[0][g] for p in parts])
                           for g in GROUP_FIELDS}
            self.actors_alive = torch.stack([p[1] for p in parts])
            self.actors_extent = max(
                math.sqrt(float((b.size ** 2).sum())) for b in s.boxes) \
                * float(model["object_extent_factor"])
            nf = inputs.frames.poses.shape[0]
            self.tracks = ref_train.Tracks(
                inputs.centers.transpose(0, 1).contiguous(),
                torch.stack(inputs.qbox)[:, None].expand(-1, nf, 4)
                .contiguous(),
                torch.stack([torch.as_tensor(b.size, dtype=torch.float32,
                                             device=pts.device)
                             for b in s.boxes]))

    def offload(self) -> None:
        """Move the padded leaves and masks to the host (the program holds
        its own copy on the device)."""
        self.bg = {g: host(x) for g, x in self.bg.items()}
        self.bg_alive = host(self.bg_alive)
        if self.actors is not None:
            self.actors = {g: host(x) for g, x in self.actors.items()}
            self.actors_alive = host(self.actors_alive)

    def leaves(self) -> dict:
        """The initial raw leaves by (asset, group)."""
        out = {("bg", g): x for g, x in self.bg.items()}
        if self.actors is not None:
            out.update({("actors", g): x for g, x in self.actors.items()})
        return out

    def reference_state(self, opt: dict, step0: int,
                        snap: dict | None = None) -> ref_train.State:
        """The reference's state on the device: the initial leaves, or
        the program's state copied at `snap` (leaves, alive masks, Adam's
        moments and step counts)."""
        dev = self.device

        def leaves(a, d):
            return {g: (snap["leaves"][(a, g)] if snap else x).detach()
                    .to(dev, copy=True).requires_grad_()
                    for g, x in d.items()}

        def alive(a, m):
            return (snap["alive"][a] if snap else m).to(dev)

        bg = ref_train.Asset(leaves("bg", self.bg), alive("bg", self.bg_alive),
                             self.bg_extent)
        actors = None if self.actors is None else ref_train.Asset(
            leaves("actors", self.actors), alive("actors", self.actors_alive),
            self.actors_extent)
        s = ref_train.State(bg, actors,
                            None if self.actors is None else self.tracks,
                            opt, snap["steps"] if snap else step0)
        if snap:
            for k, (m, v, t) in snap["moments"].items():
                s.m[k], s.v[k], s.t[k] = m.to(dev), v.to(dev), t
        return s


def port_scene(sc: Scene, degree: int):
    """The port's Scene of the same inputs."""
    from lidar_rt_tpu_torch.scene.asset import GaussianAsset
    from lidar_rt_tpu_torch.scene.scene import Scene as PortScene
    from lidar_rt_tpu_torch.scene.tracks import ActorTrack

    def asset(d, alive, extent):
        return GaussianAsset(
            **{f: d[g].clone() for g, f in GROUP_FIELDS.items()},
            alive=alive.clone(), active_sh_degree=degree,
            max_sh_degree=degree, extent=extent)

    bg = asset(sc.bg, sc.bg_alive, sc.bg_extent)
    if sc.actors is None:
        return PortScene(background=bg)
    t = sc.tracks
    m, nf = t.translations.shape[:2]
    track = ActorTrack(t.size.clone(), t.translations.clone(),
                       t.quats.clone(),
                       torch.ones((m, nf), dtype=torch.bool,
                                  device=t.size.device),
                       object_id="|".join(f"veh_{i}" for i in range(m)),
                       object_type="|".join(["vehicle"] * m))
    return PortScene(background=bg, actors=asset(
        sc.actors, sc.actors_alive, sc.actors_extent), tracks=track)


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from lidar_rt_tpu_torch.data.frames import LiDARFrames
        from lidar_rt_tpu_torch.ops import tracer as tracer_lib
        from lidar_rt_tpu_torch.train import loop
        self.cfg, self.traffic, self.device = cfg, traffic, device
        clock = common.Clock(device)
        self.inputs = common.Inputs(cfg, seed, device)
        clock.mark("inputs")
        self.scene = Scene(self.inputs, cfg)
        self.degree = int(cfg["surfels"]["sh_degree"])
        program_scene = port_scene(self.scene, self.degree)
        self.scene.offload()
        self.inputs.surf = None
        common.sync(device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        fr = self.inputs.frames
        nf = fr.poses.shape[0]
        frames = LiDARFrames(
            common.port_grid(self.inputs), self.inputs.raster.width,
            fr.poses, fr.range1, fr.intensity1, fr.range2, fr.intensity2,
            list(range(nf)), list(fr.train),
            [f for f in range(nf) if f not in fr.train])
        sched = cfg["schedule"]
        args = SimpleNamespace(seed=int(sched["seed"]),
                               opt=SimpleNamespace(**sched["opt"]),
                               model=SimpleNamespace(**sched["model"]))
        trace_cfg, _ = common.port_trace_config(cfg, device)
        self.trainer = loop.Trainer(program_scene, frames, args,
                                    trace_cfg=trace_cfg)
        del program_scene
        self.iteration0 = int(sched["iteration"])
        self.trainer.iteration = self.iteration0
        st = self.trainer.state
        for o in (st.opt_bg, st.opt_actors):
            if o is not None:
                o.steps = self.iteration0
        clock.mark("program")
        self.log_every = int(traffic["log_every"])
        self.failed = 0
        self.records = self._checked_steps(tracer_lib,
                                           int(traffic["check_steps"]))
        for _ in range(int(traffic["warmup_steps"])):
            self.step()
        common.sync(device)
        clock.mark("warm-up")
        clock.report()

    def _state_leaves(self) -> dict:
        st = self.trainer.state
        out = {("bg", g): st.opt_bg.params[g] for g in ref_train.GROUPS}
        if st.opt_actors is not None:
            out.update({("actors", g): st.opt_actors.params[g]
                        for g in ref_train.GROUPS})
        return out

    def _optimizer(self, asset: str):
        st = self.trainer.state
        return st.opt_bg if asset == "bg" else st.opt_actors

    def _checked_steps(self, tracer_lib, n: int) -> dict:
        """The first n steps through Trainer.step, recorded on the host:
        the frames, each step's loss terms, the first step's channels, the
        first gradient from Adam's first moment, the parameters after
        step n."""
        renders = []
        inner = tracer_lib.render_frame

        def recording(*a, **k):
            out = inner(*a, **k)
            if not renders:
                renders.append(host(out["channels"]))
            return out

        rec = {"frames": [], "terms": [], "grad1": {}, "after": {}}
        tracer_lib.render_frame = recording
        try:
            for i in range(n):
                metrics = self.step()
                rec["frames"].append(self.last_frame())
                rec["terms"].append({k: float(metrics[k]) for k in TERMS})
                if i == 0:
                    for (a, g), p in self._state_leaves().items():
                        mom = self._optimizer(a).moments(g)
                        # No moment: the optimizer holds no gradient.
                        rec["grad1"][(a, g)] = host(
                            mom[0] / (1.0 - ref_train.BETA1) if mom
                            else torch.zeros_like(p))
        finally:
            tracer_lib.render_frame = inner
        rec["channels"] = renders[0]
        rec["before"] = self.scene.leaves()
        rec["after"] = {k: host(p)
                        for k, p in self._state_leaves().items()}
        return rec

    def _snapshot(self) -> dict:
        """The trainer's state on the host: leaves, alive masks, Adam's
        moments and bias-correction counts, the schedule's step count."""
        st = self.trainer.state
        snap = {"leaves": {k: host(p)
                           for k, p in self._state_leaves().items()},
                "alive": {"bg": host(st.scene.background.alive)},
                "moments": {}, "steps": st.opt_bg.steps}
        if st.scene.actors is not None:
            snap["alive"]["actors"] = host(st.scene.actors.alive)
        for (a, g), p in self._state_leaves().items():
            o = self._optimizer(a)
            mom = o.moments(g)
            t = int(o.adam.state.get(p, {}).get("step", 0))
            snap["moments"][(a, g)] = (
                (host(mom[0]), host(mom[1])) if mom
                else (torch.zeros_like(snap["leaves"][(a, g)]),) * 2) + (t,)
        return snap

    def post_window(self) -> None:
        """After the window: the state copied to the host, then
        `late_steps` more steps of the same trainer, recorded.  Their
        frames are binned afresh, as the first steps' are, since the
        reference bins every step afresh: how old a cached assignment
        grows in the window (rebin_interval) is the configuration's
        approximation, and is not compared."""
        snap = self._snapshot()
        self.trainer._invalidate_bins()
        rec = {"frames": [], "terms": []}
        for _ in range(int(self.traffic["late_steps"])):
            metrics = self.step()
            rec["frames"].append(self.last_frame())
            rec["terms"].append({k: float(metrics[k]) for k in TERMS})
        rec["before"] = snap["leaves"]
        rec["after"] = {k: host(p)
                        for k, p in self._state_leaves().items()}
        self.late = {"snap": snap, "rec": rec}

    def step(self) -> dict:
        metrics = self.trainer.step()
        if self.trainer.iteration % self.log_every == 0:
            self.trainer._flush_metrics()
        return metrics

    def window(self, seconds: float) -> dict:
        common.sync(self.device)
        t0 = time.perf_counter()
        stamps = [t0]
        while True:
            self.step()
            stamps.append(time.perf_counter())
            if stamps[-1] - t0 >= seconds:
                break
        common.sync(self.device)
        dt = time.perf_counter() - t0
        common.report_steps(stamps)
        return {"attempted": len(stamps) - 1, "window_s": dt}

    def end_to_end(self, win: dict) -> dict:
        return {"train_step_ms": win["window_s"] / win["attempted"] * 1e3}

    def last_frame(self) -> int:
        """The frame the trainer's last step drew (its pending metrics, or
        its history once a log event has moved them there)."""
        t = self.trainer
        return t._pending_metrics[-1][1] if t._pending_metrics \
            else t.history[-1]["frame"]

    def traced(self):
        n = int(self.traffic["trace_steps"])
        self.traced_frames = []

        def run():
            for _ in range(n):
                with trace_lib.span("bench.step"):
                    self.step()
                self.traced_frames.append(self.last_frame())

        _, reading = trace_lib.profile(run)
        return {"attempted": n}, reading, {"reading": reading, "steps": n}

    def after_trace(self) -> dict:
        """The step's eager time over `trace_steps` more steps, and the
        least work of the traced steps: the reference's depth-order hits
        at each traced frame (from the inputs' state), Chamfer's pairs
        and Adam's parameters."""
        n = int(self.traffic["trace_steps"])
        e = common.eager_ms(lambda _i: self.step(), list(range(n)),
                            self.device)
        pk = work.peaks(torch.cuda.get_device_name(self.device))
        opt = self.cfg["schedule"]["opt"]
        s = self.scene.reference_state(opt, self.iteration0)
        fr = self.inputs.frames
        rays = self.inputs.raster.incl.shape[0] * self.inputs.raster.width
        stride = max(1, rays // int(opt["cd_max_points"]))
        params = sum(x.numel() for x in self._state_leaves().values())
        n_surf = sum(x.shape[0] for x in ref_train.compose(s, 0)[:1])
        least = ops = 0.0
        with torch.no_grad():
            for f in self.traced_frames:
                hits = ref.depth_order_hits(
                    ref_train.compose(s, f), self.inputs.raster,
                    fr.poses[f], ref.tiling(self.cfg["tracer"]))
                w = work.tracer(hits, rays, n_surf)
                pts = int((fr.range1[f].reshape(-1)[::stride] > 0).sum())
                least += work.tracer_least_seconds(w, pk)
                ops += work.ops_seconds(
                    w["fwd_f32"] + w["bwd_f32"] + work.chamfer_flops(pts, pts)
                    + work.adam_flops(params),
                    w["fwd_tf32"] + w["bwd_tf32"], pk)
        return {"eager_ms": e, "tracer_least_s": least, "ops_s": ops / n,
                "kernel_prefix": "tracer_"}

    def release(self) -> None:
        self.trainer = None
        common.sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict) -> dict:
        got = numbers(self.records, self.reference_records())
        late = self.late["rec"]
        got.update(late_numbers(late, reference_records(
            self.scene.reference_state(self.cfg["schedule"]["opt"], 0,
                                       self.late["snap"]),
            self.inputs, self.cfg, late["frames"], self.degree)))
        if any(got[k] > limits[k] for k in NUMBERS):
            self.failed = 1
        return {k: common.check_entry(got[k], limits[k]) for k in NUMBERS}

    def reference_records(self, dtype=torch.float32) -> dict:
        return reference_records(
            self.scene.reference_state(self.cfg["schedule"]["opt"],
                                       self.iteration0),
            self.inputs, self.cfg, self.records["frames"], self.degree,
            dtype)


def reference_records(s: ref_train.State, inputs: common.Inputs, cfg: dict,
                      frames: list[int], degree: int, dtype=torch.float32
                      ) -> dict:
    """The reference's records of the given steps from state `s`, which
    they advance."""
    opt = cfg["schedule"]["opt"]
    before = {(a, g): x.detach().clone() for a, asset in s.assets()
              for g, x in asset.leaves.items()}
    fr = inputs.frames
    rays = inputs.raster.incl.shape[0] * inputs.raster.width
    stride = max(1, rays // int(opt["cd_max_points"]))
    tiling = ref.tiling(cfg["tracer"])
    rec = {"terms": [], "grad1": {}}
    for i, f in enumerate(frames):
        gt = (fr.range1[f], fr.intensity1[f], fr.range1[f] != 0)
        out = ref_train.step(s, f, inputs.raster, fr.poses[f], tiling,
                             degree, gt, stride, dtype)
        rec["terms"].append(out.terms)
        if i == 0:
            rec["channels"] = out.channels
            rec["grad1"] = out.grads
    rec["change"] = {(a, g): (x.detach() - before[(a, g)])
                     for a, asset in s.assets()
                     for g, x in asset.leaves.items()}
    return rec


def _norm(x: Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def _loss_rel(prog: dict, refr: dict) -> float:
    """Each step's loss terms: the worst relative gap."""
    return max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-30)
               for p, r in zip(prog["terms"], refr["terms"]) for k in TERMS)


def _change_gaps(prog: dict, refr: dict, g_ref: dict, name: str) -> dict:
    """The parameters' change norm per leaf over the steps: each leaf's
    gap of norms against the larger of the leaf's and the median leaf's
    reference norm, leaving out leaves whose reference gradient (first
    step) is under a thousandth of the median leaf's.  The worst leaf and
    what was left out go to standard error."""
    med_g = sorted(g_ref.values())[len(g_ref) // 2]
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * med_g]
    c_ref = {k: _norm(refr["change"][k]) for k in moved}
    med_c = sorted(c_ref.values())[len(c_ref) // 2]
    gaps = {k: abs(_norm(prog["after"][k] - prog["before"][k]) - c_ref[k])
            / max(c_ref[k], med_c) for k in moved}
    worst = max(gaps, key=gaps.get)
    print(f"detail {name}: worst leaf {'.'.join(worst)} {gaps[worst]!r}, "
          f"reference change {c_ref[worst]!r}, median {med_c!r}; left out "
          f"{sorted('.'.join(k) for k in g_ref if k not in moved)}",
          file=sys.stderr)
    return gaps


def numbers(prog: dict, refr: dict) -> dict:
    """The compared numbers of the checked first steps: the first step's
    render (worst channel's relative L2 gap), each step's loss terms, the
    first gradient's norm per leaf (worst gap of norms against the larger
    of the leaf's and the median leaf's reference norm), the parameters'
    change per leaf after the steps."""
    out = {"render_rel": common.channel_rel(prog["channels"],
                                            refr["channels"])}
    out["loss_rel"] = _loss_rel(prog, refr)
    g_ref = {k: _norm(v) for k, v in refr["grad1"].items()}
    med_g = sorted(g_ref.values())[len(g_ref) // 2]
    out["grad1_rel"] = max(
        abs(_norm(prog["grad1"][k]) - g_ref[k]) / max(g_ref[k], med_g)
        for k in g_ref)
    out["change_rel"] = max(
        _change_gaps(prog, refr, g_ref, "change_rel").values())
    return out


def late_numbers(prog: dict, refr: dict) -> dict:
    """The compared numbers of the steps after the window: their loss
    terms, and the parameters' change over them as the median leaf's gap
    (the worst leaf's swings a hundredfold from seed to seed, and is
    carried by at most fifty of the leaf's elements, whose gradients
    differ between the two sides)."""
    g_ref = {k: _norm(v) for k, v in refr["grad1"].items()}
    gaps = sorted(_change_gaps(prog, refr, g_ref, "late_change").values())
    return {"late_loss_rel": _loss_rel(prog, refr),
            "late_change_med": gaps[len(gaps) // 2]}


def control(cfg: dict, traffic: dict, seed: int, device, steps: int = 3
            ) -> list[dict]:
    """The reference in bfloat16 put in the program's place, against the
    float32 reference, over the traffic's checked steps: the numbers the
    comparison has to fail."""
    inputs = common.Inputs(cfg, seed, device)
    scene = Scene(inputs, cfg)
    degree = int(cfg["surfels"]["sh_degree"])
    step0 = int(cfg["schedule"]["iteration"])
    opt = cfg["schedule"]["opt"]
    n, k = int(traffic["check_steps"]), int(traffic["late_steps"])
    frames = list(inputs.frames.train)
    first, later = frames[:n], frames[n:n + k]
    start = scene.reference_state(opt, step0)
    exact = reference_records(start, inputs, cfg, first, degree)
    # The late steps start from the float32 reference's state after the
    # first steps, as the program's start from its own.
    snap = snapshot(start)
    exact_late = reference_records(scene.reference_state(opt, 0, snap),
                                   inputs, cfg, later, degree)
    low = reference_records(scene.reference_state(opt, step0), inputs, cfg,
                            first, degree, torch.bfloat16)
    low["before"] = {k: host(x) for k, x in scene.leaves().items()}
    low["after"] = {k: low["before"][k] + host(v)
                    for k, v in low["change"].items()}
    low_late = reference_records(scene.reference_state(opt, 0, snap),
                                 inputs, cfg, later, degree, torch.bfloat16)
    low_late["before"] = snap["leaves"]
    low_late["after"] = {k: snap["leaves"][k] + v
                         for k, v in low_late["change"].items()}
    return [{**numbers(low, exact), **late_numbers(low_late, exact_late)}]


def snapshot(s: ref_train.State) -> dict:
    """A reference state as `Scene.reference_state` takes it back."""
    snap = {"leaves": {}, "alive": {}, "moments": {}, "steps": s.steps}
    for a, asset in s.assets():
        snap["alive"][a] = asset.alive
        for g, x in asset.leaves.items():
            snap["leaves"][(a, g)] = x.detach().clone()
            snap["moments"][(a, g)] = (s.m[(a, g)].clone(),
                                       s.v[(a, g)].clone(), s.t[(a, g)])
    return snap
