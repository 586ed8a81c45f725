"""Eval runner, the reference's eval.py (counterpart of
`lidar_rt_tpu.eval.runner`).

Renders train/test/all frames without autograd, optionally refines the
ray-drop with the U-Net, masks the predictions (by the predicted hit at
the 0.4 ray-drop threshold, or by the recorded mask, eval.py:178-184),
computes the metric suite and aggregates it to JSON (LiDARRTMeter.run,
eval.py:367-524).  On a dual-return dataset the second return's depth
metrics come from `render_multi_return`; they compare whole images (the
reference's `depth_metrics` is not masked), so their MedAE is 0.0 wherever
most pixels have no second return, as in the reference.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable

import numpy as np
import torch

from lidar_rt_tpu_torch.data.frames import LiDARFrames
from lidar_rt_tpu_torch.eval import metrics
from lidar_rt_tpu_torch.ops import kernels
from lidar_rt_tpu_torch.ops import tracer as tracer_lib
from lidar_rt_tpu_torch.scene.scene import Scene, compose
from lidar_rt_tpu_torch.utils import profiling
from lidar_rt_tpu_torch.utils.export import (colormap, write_apng, write_ply,
                                             write_png)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class EvalRunner:
    """eval_type: "train" | "test" | "all" (eval.py:381-392);
    raydrop_ratio: the 0.4 hit/drop threshold (eval.py:72);
    use_gt_mask: mask predictions with the recorded mask instead of the
    predicted one (eval.py:184); unet_apply(frame, render) -> refined
    ray-drop (H, W); lpips_fn: `eval.lpips.make_lpips_fn()`'s callable or
    None (then LPIPS is reported as unavailable)."""

    def __init__(self, scene: Scene, frames: LiDARFrames, args,
                 trace_cfg: tracer_lib.TraceConfig | None = None,
                 unet_apply: Callable | None = None,
                 raydrop_ratio: float = 0.4, use_gt_mask: bool = False,
                 max_depth: float = 80.0, lpips_fn=None):
        self.scene = scene
        self.frames = frames
        self.args = args
        self.cfg = trace_cfg or tracer_lib.TraceConfig()
        self.unet_apply = unet_apply
        self.raydrop_ratio = raydrop_ratio
        self.use_gt_mask = use_gt_mask
        self.max_depth = max_depth
        self.lpips_fn = lpips_fn

    def _frame_ids(self, eval_type: str) -> list[int]:
        if eval_type == "train":
            return list(self.frames.train_frames)
        if eval_type == "test":
            return list(self.frames.eval_frames)
        if eval_type == "all":
            return list(range(self.frames.num_frames))
        raise ValueError(f"invalid eval type {eval_type!r}")

    def render_frame(self, f: int) -> dict:
        with torch.no_grad():
            bundle, _ = compose(self.scene, f)
            out = tracer_lib.render_frame(
                bundle, self.frames.grid, self.frames.width,
                self.frames.pose(f), self.scene.background.active_sh_degree,
                self.cfg, bool(self.args.opt.use_rayhit))
        if self.unet_apply is not None:
            out = dict(out)
            out["raydrop"] = self.unet_apply(f, out)
        return out

    def record_render(self, f: int) -> dict:
        """One frame's masked prediction and ground truth (eval.py
        :100-264): images as numpy arrays, point clouds as tensors on the
        frames' device."""
        out = self.render_frame(f)
        gt_mask = self.frames.mask(f)
        gt_depth = self.frames.depth(f)
        pred_hit = out["raydrop"] < self.raydrop_ratio
        mask = gt_mask if self.use_gt_mask else pred_hit
        depth = out["depth"] * mask
        with torch.no_grad():
            gt_pts = self.frames.points_from_range(f, gt_depth)[gt_mask]
            pred_pts = self.frames.points_from_range(f, depth)[mask]
        return {
            "depth": _host(depth),
            "intensity": _host(out["intensity"].clamp(0, 1) * mask),
            "rayhit": _host(pred_hit), "raydrop": _host(out["raydrop"]),
            "gt_depth": _host(gt_depth),
            "gt_intensity": _host(self.frames.intensity(f).clamp(0, 1)),
            "gt_mask": _host(gt_mask), "gt_pts": gt_pts,
            "pred_pts": pred_pts,
        }

    def evaluate_frame(self, f: int) -> dict:
        r = self.record_render(f)
        out = {
            "depth": metrics.depth_metrics(r["gt_depth"], r["depth"],
                                           self.max_depth, self.lpips_fn),
            "intensity": metrics.intensity_metrics(
                r["gt_intensity"], r["intensity"], self.lpips_fn),
            "raydrop": metrics.raydrop_metrics(
                (~r["gt_mask"]).astype(np.float64),
                (~r["rayhit"]).astype(np.float64), self.raydrop_ratio),
            "points": metrics.points_metrics(r["gt_pts"], r["pred_pts"]),
        }
        if self.frames.range2 is not None \
                and bool(self.frames.range2[f].max() > 0):
            with torch.no_grad():
                bundle, _ = compose(self.scene, f)
                _, r2 = tracer_lib.render_multi_return(
                    bundle, self.frames.grid, self.frames.width,
                    self.frames.pose(f),
                    self.scene.background.active_sh_degree, self.cfg,
                    bool(self.args.opt.use_rayhit))
            gt2 = self.frames.depth(f, return_num=2)
            out["depth_return2"] = metrics.depth_metrics(
                _host(gt2), _host(r2["depth"] * (gt2 > 0)), self.max_depth)
        return out

    def save_frame_images(self, f: int, output_dir: str,
                          save_png: bool = True,
                          save_pcd: bool = True) -> None:
        """gt/pred depth, intensity, rayhit snapshot PNGs with the
        reference's masking/colormap treatment (eval.py:147-229,456-476);
        save_pcd adds the gt/pred PLY pair (eval.py:478-486)."""
        r = self.record_render(f)
        os.makedirs(output_dir, exist_ok=True)
        if save_png:
            gd = r["gt_depth"]
            rng_scale = max(float(gd.max() - gd.min()), 1e-6)

            def depth_vis(d, m):
                return colormap((d - gd.min()) / rng_scale) * m[..., None]

            def inten_vis(i, m):
                gi = r["gt_intensity"]
                s = max(float(gi.max() - gi.min()), 1e-6)
                return colormap((i - gi.min()) / s) * m[..., None]

            pred_mask = r["rayhit"] if not self.use_gt_mask else r["gt_mask"]
            rows = [
                np.concatenate([depth_vis(gd, r["gt_mask"]),
                                depth_vis(r["depth"], pred_mask)], axis=1),
                np.concatenate([inten_vis(r["gt_intensity"], r["gt_mask"]),
                                inten_vis(r["intensity"], pred_mask)],
                               axis=1),
                np.concatenate([np.repeat(r["gt_mask"][..., None], 3, -1),
                                np.repeat(r["rayhit"][..., None], 3, -1)],
                               axis=1).astype(np.float32),
            ]
            write_png(os.path.join(output_dir, f"frame_{f:04d}.png"),
                      np.concatenate(rows, axis=0))
        if save_pcd:
            write_ply(os.path.join(output_dir, f"gt_{f:04d}.ply"),
                      _host(r["gt_pts"]))
            write_ply(os.path.join(output_dir, f"pred_{f:04d}.ply"),
                      _host(r["pred_pts"]))

    def run(self, eval_type: str = "test", output_dir: str | None = None,
            save_images: bool = False, save_pcds: bool | None = None,
            save_metrics: bool = True) -> dict:
        """Aggregate means over frames -> results dict; optionally writes
        results_all.json (eval.py:488-520) and image/PLY artifacts.
        save_pcds defaults to save_images; the CLI's -e/-i/-p map to
        save_metrics/save_images/save_pcds (eval.py:549-556).
        `results["eval_seconds"]` is the metric pass's wall time,
        `results["launches"]` the tracer kernels' launches in the run and
        `results["peak_mib"]` the process's peak device memory (None off
        the card)."""
        if save_pcds is None:
            save_pcds = save_images
        launches = kernels.launch_counts()
        frame_ids = self._frame_ids(eval_type)
        per_frame = {}
        t0 = time.time()
        for i, f in enumerate(frame_ids):
            per_frame[f] = self.evaluate_frame(f)
            if i == 0 or (i + 1) % 10 == 0 or i + 1 == len(frame_ids):
                print(f"  eval frame {i + 1}/{len(frame_ids)} "
                      f"({time.time() - t0:.0f}s)", flush=True)
        eval_seconds = time.time() - t0
        if (save_images or save_pcds) and output_dir:
            for f in frame_ids:
                self.save_frame_images(f, os.path.join(output_dir, "images"),
                                       save_png=save_images,
                                       save_pcd=save_pcds)
            if save_images:
                # 5 fps depth animation (eval.py:522-524's video)
                vids = []
                for f in frame_ids:
                    r = self.record_render(f)
                    scale = max(float(r["gt_depth"].max()), 1e-6)
                    vids.append(colormap(r["depth"] / scale))
                write_apng(os.path.join(output_dir, "depth_anim.png"), vids,
                           fps=5)

        agg: dict[str, dict[str, float]] = {}
        groups = sorted({g for f in frame_ids for g in per_frame[f]})
        for group in groups:
            frames_with = [f for f in frame_ids if group in per_frame[f]]
            keys = per_frame[frames_with[0]][group].keys()
            agg[group] = {}
            for k in keys:
                vals = [per_frame[f][group][k] for f in frames_with]
                finite = [v for v in vals if np.isfinite(v)]
                if not finite and vals:
                    # An all-nan column is flagged, not averaged into a
                    # nan that looks like a complete table (the reference
                    # always reports LPIPS, eval.py:75).
                    print(f"WARNING: metric {group}/{k} is nan on every "
                          "frame" + (" — LPIPS weights not loaded? set "
                                     "$LIDAR_RT_LPIPS_WEIGHTS (see "
                                     "lidar_rt_tpu_torch/eval/lpips.py)"
                                     if "lpips" in k else ""))
                if finite:
                    agg[group][k] = float(np.mean(finite))
                elif "lpips" in k and self.lpips_fn is None:
                    # A marker the table reader cannot mistake for a
                    # score: no AlexNet LPIPS weights are available.
                    agg[group][k] = "unavailable(no-weights)"
                else:
                    agg[group][k] = float("nan")

        results = {"eval_type": eval_type, "num_frames": len(frame_ids),
                   "mean": agg,
                   "per_frame": {str(f): per_frame[f] for f in frame_ids},
                   "eval_seconds": eval_seconds,
                   "launches": kernels.launches_since(launches),
                   "peak_mib": profiling.peak_mib(
                       self.scene.background.xyz.device)}
        if output_dir and save_metrics:
            os.makedirs(output_dir, exist_ok=True)
            with open(os.path.join(output_dir, "results_all.json"), "w") as fp:
                json.dump(results, fp, indent=2)
        return results
