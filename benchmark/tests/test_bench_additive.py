"""A later change adds a cell, a configuration, a traffic mix or a metric
by adding files and manifest entries: dropped into a temporary copy, each
is found by its name and runs, with no file of the harness edited."""

from __future__ import annotations

import json
import os
import shutil

from benchmark import run


def test_dropped_files_are_found_by_name(tiny_root, capsys):
    bench = os.path.join(tiny_root, "benchmark")
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(bench) for p in fs
              if p.endswith(".py")}
    shutil.copy(os.path.join(bench, "configs", "kitti360_hdl64.json"),
                os.path.join(bench, "configs", "kitti_copy.json"))
    with open(os.path.join(bench, "configs", "kitti_copy.json")) as f:
        conf = json.load(f)
    conf["name"] = "kitti_copy"
    with open(os.path.join(bench, "configs", "kitti_copy.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(bench, "traffic", "fwdbwd.json")) as f:
        traffic = json.load(f)
    traffic["rebin_every"] = 5
    with open(os.path.join(bench, "traffic", "fwdbwd_rebin5.json"), "w") as f:
        json.dump(traffic, f)
    shutil.copy(os.path.join(bench, "limits", "waymo.fwdbwd.json"),
                os.path.join(bench, "limits", "kitti_copy.fwdbwd5.json"))
    with open(os.path.join(bench, "metrics", "steps_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx['steps'])\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        m = json.load(f)
    m["configs"].append({"name": "kitti_copy", "source": "https://x.org",
                         "file": "benchmark/configs/kitti_copy.json",
                         "reduced": [], "why": "a copy"})
    m["workloads"].append({"name": "kitti_copy.fwdbwd5",
                           "config": "kitti_copy",
                           "traffic": "fwdbwd_rebin5", "chips": 1,
                           "why": "a dropped cell"})
    m["end_to_end"][0]["workloads"].append("kitti_copy.fwdbwd5")
    m["per_layer"].append({"name": "steps_seen", "unit": "steps",
                           "better": "higher", "source": "device_trace",
                           "layer": "whole step",
                           "moves": "fwdbwd_mrays_per_s",
                           "workloads": ["kitti_copy.fwdbwd5"]})
    with open(path, "w") as f:
        json.dump(m, f)

    files = run.cell_files(run.manifest(tiny_root), "kitti_copy.fwdbwd5",
                           tiny_root)
    assert files["config"]["name"] == "kitti_copy"
    assert files["traffic"]["rebin_every"] == 5
    reader = run.load_module(os.path.join(bench, "metrics", "steps_seen.py"),
                             "steps_seen")
    assert reader.read({"steps": 3}) == 3.0
    assert run.main(["--workload", "kitti_copy.fwdbwd5", "--seed", "9",
                     "--seconds", "0.3"], device="cpu", root=tiny_root) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["correct"] is True
    assert "fwdbwd_mrays_per_s" in last["metrics"]
    after = {p: open(os.path.join(dp, p), "rb").read()
             for dp, _, fs in os.walk(bench) for p in fs
             if p.endswith(".py") and p != "steps_seen.py"}
    assert after == before
