"""BENCHMARK.json against the benchmark's contract: names, units and the
characters allowed, keys, and every file a name leads to."""

from __future__ import annotations

import json
import os
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(m["command"]) <= 32 and all(line(w) for w in m["command"])
    assert m["command"][1].startswith(m["paths"][0] + "/")
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024


def test_names_units_and_lines():
    m = manifest()
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for x in m[key]:
            assert NAME.match(x["name"]), x["name"]
            names.append((key, x["name"]))
    assert len(names) == len(set(names))
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for c in m["configs"]:
        assert set(c) == CONFIG_KEYS and line(c["why"]) and line(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == CELL_KEYS and line(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for x in m["per_layer"]:
        assert line(x["layer"])


def test_metric_keys_bounds_and_cells():
    m = manifest()
    cells = {w["name"] for w in m["workloads"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == E2E_KEYS
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
        assert set(x.get("workloads", cells)) <= cells

    def reports(metric, cell):
        return cell in metric.get("workloads", cells)

    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == LAYER_KEYS
        assert x["moves"] in e2e
        for cell in x.get("workloads", cells):
            assert cell in cells and reports(e2e[x["moves"]], cell)
    for cell in cells:
        own = [x for x in m["end_to_end"] if reports(x, cell)]
        assert "setup_s" in {x["name"] for x in own} and len(own) >= 2
        assert any(reports(x, cell) for x in m["per_layer"])


def test_every_name_leads_to_its_file():
    m = manifest()
    bench = os.path.join(ROOT, "benchmark")
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    files = [c["file"] for c in m["configs"]]
    assert len(files) == len(set(files))
    for c in m["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in m["workloads"]:
        with open(os.path.join(bench, "traffic", f"{w['traffic']}.json")) as f:
            traffic = json.load(f)
        assert os.path.isfile(os.path.join(bench, "drivers",
                                           f"{traffic['driver']}.py"))
        assert os.path.isfile(os.path.join(bench, "limits",
                                           f"{w['name']}.json"))
    for x in m["per_layer"]:
        assert os.path.isfile(os.path.join(bench, "metrics",
                                           f"{x['name']}.py"))
