"""Whole runs of each traffic mix at a tiny size on the CPU (the port's
plain twins in place of its kernels), held to the plain reference: the
result's last line, `correct` true on the sound program, and `correct`
false with the timed path broken underneath, once for each fault the cell
can have."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import run

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def result(root: str, workload: str, capsys, seed: int = 2 ** 31 + 7
           ) -> dict:
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", "0.5", "--trace", "0"], device="cpu",
                  root=root)
    assert rc == 0
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    checks = [ln for ln in err.strip().splitlines()
              if ln.startswith("check ")]
    assert err.strip().splitlines()[-len(checks):] == checks
    assert len(checks) == len(last["checks"])
    return last


@pytest.mark.parametrize("workload", ["waymo.fwdbwd", "kitti360.train"])
def test_tiny_run_is_correct(tiny_root, capsys, workload):
    last = result(tiny_root, workload, capsys)
    assert list(last) == KEYS
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] >= 1
    assert {"setup_s", "peak_device_mib"} <= set(last["metrics"])
    assert all(c["value"] <= c["limit"] for c in last["checks"].values())


def _stale_pose(monkeypatch):
    from lidar_rt_tpu_torch.ops import tracer
    inner, first = tracer.trace, []

    def stale(bundle, grid, width, s2w, *a, **k):
        first.append(s2w)
        return inner(bundle, grid, width, first[0], *a, **k)

    monkeypatch.setattr(tracer, "trace", stale)


def _half_rays(monkeypatch):
    from lidar_rt_tpu_torch.ops import tracer
    inner = tracer.trace

    def half(*a, **k):
        out = inner(*a, **k)
        keep = torch.zeros_like(out.channels)
        keep[: out.channels.shape[0] // 2] = 2.0
        return out._replace(channels=out.channels * keep)

    monkeypatch.setattr(tracer, "trace", half)


def _altered_depth(monkeypatch):
    from lidar_rt_tpu_torch.ops import tracer
    inner = tracer.trace

    def altered(*a, **k):
        out = inner(*a, **k)
        scale = torch.ones_like(out.channels)
        scale[:8, :128, 3] = 1.01
        return out._replace(channels=out.channels * scale)

    monkeypatch.setattr(tracer, "trace", altered)


def _unchanged_state(monkeypatch):
    from lidar_rt_tpu_torch.train import optim
    monkeypatch.setattr(optim.AssetOptimizer, "step", lambda self: None)


def _half_batch(monkeypatch):
    from lidar_rt_tpu_torch.train import losses
    inner = losses.render_losses

    def half(depth, intensity, drop, gt_depth, gt_int, gt_mask, *a, **k):
        kept = gt_mask.clone()
        kept[gt_mask.shape[0] // 2:] = False
        return inner(depth, intensity, drop, gt_depth, gt_int, kept, *a,
                     **k)

    monkeypatch.setattr(losses, "render_losses", half)


def _altered_render(monkeypatch):
    from lidar_rt_tpu_torch.ops import tracer
    inner = tracer.render_frame

    def altered(*a, **k):
        out = inner(*a, **k)
        scale = torch.ones_like(out["channels"])
        scale[..., 3] = 1.01
        return {**out, "depth": out["depth"] * 1.01,
                "channels": out["channels"] * scale}

    monkeypatch.setattr(tracer, "render_frame", altered)


def _late_altered_render(monkeypatch):
    """The render's depth altered by a tenth only from the window on
    (after the checked and warm-up steps), as a path that changes after
    warm-up would be."""
    from lidar_rt_tpu_torch.ops import tracer
    inner, calls = tracer.render_frame, []

    def late(*a, **k):
        out = inner(*a, **k)
        calls.append(1)
        if len(calls) <= 8:                 # check_steps + warmup_steps
            return out
        scale = torch.ones_like(out["channels"])
        scale[..., 3] = 1.1
        return {**out, "depth": out["depth"] * 1.1,
                "channels": out["channels"] * scale}

    monkeypatch.setattr(tracer, "render_frame", late)


FAULTS = {
    "waymo.fwdbwd": [_stale_pose, _half_rays, _altered_depth],
    "kitti360.train": [_unchanged_state, _half_batch, _altered_render,
                       _late_altered_render],
}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w, fs in FAULTS.items() for f in fs],
    ids=lambda x: getattr(x, "__name__", x))
def test_broken_timed_path_is_not_correct(tiny_root, capsys, monkeypatch,
                                          workload, fault):
    fault(monkeypatch)
    last = result(tiny_root, workload, capsys)
    assert last["correct"] is False and last["failed"] >= 1


@pytest.mark.parametrize("workload", ["waymo.fwdbwd", "kitti360.train"])
def test_control_fails_the_limits(tiny_root, workload):
    """The reference in bfloat16 in the program's place fails at least one
    of the cell's committed limits."""
    from benchmark import control
    out = control.main(["--workload", workload, "--seeds", "5", "--steps",
                        "1"], device="cpu", root=tiny_root)
    assert any(out["fails_every_limit"].values())


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "waymo.fwdbwd", "--seed", "1", "--seconds",
                   "1"])
    assert rc == run.EXIT_NO_CARD
    assert capsys.readouterr().out == ""
