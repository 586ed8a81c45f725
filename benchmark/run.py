"""One run of one cell of the benchmark of `lidar_rt_tpu_torch` on an H100.

    python3 benchmark/run.py --workload waymo.fwdbwd --seed 7 \
        --seconds 10 --trace 0

Everything is found by name from `BENCHMARK.json` at the root: the cell's
configuration file (`configs/<name>.json`), its traffic file
(`traffic/<traffic>.json`, whose `driver` names the module under
`drivers/` that runs it), its limits (`limits/<cell>.json`) and each
per-layer metric's reader (`metrics/<metric>.py`).  A run

  1. makes the configuration's scene and frames on the card from --seed,
     builds the program's objects and warms up every shape the traffic
     uses (set-up, `setup_s`, counted from the start of this process);
  2. with --trace 0 runs the traffic for --seconds and reports the cell's
     end-to-end metrics; with --trace 1 traces a fixed number of steps
     under torch.profiler and reports its per-layer metrics;
  3. reads the device's peak memory, lets the driver take what it checks
     after the window (`post_window`), frees the program's state, and holds
     what the timed path produced to the plain reference under
     `reference/` (`correct`), printing every number compared beside its
     limit as the last lines of standard error and under `checks`, the
     last key of the result;
  4. prints the result as the last line of standard output.

It exits non-zero without a result when no card is present, when the
process has loaded JAX or the JAX package, or when anything fails.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# Top-level module names no process of the benchmark may load, compared
# whole: the port's own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "lidar_rt_tpu")
EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module by its file's path (metric readers are named by metric,
    which holds dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(m: dict, workload: str, root: str = ROOT) -> dict:
    """The cell's manifest entry and every file it names, loaded."""
    cells = {w["name"]: w for w in m["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in m["configs"]}[cell["config"]]
    bench = os.path.join(root, "benchmark")
    traffic = load_json(bench, "traffic", f"{cell['traffic']}.json")
    return {"cell": cell,
            "config": load_json(root, conf["file"]),
            "traffic": traffic,
            "limits": load_json(bench, "limits", f"{workload}.json"),
            "driver": load_module(
                os.path.join(bench, "drivers", f"{traffic['driver']}.py"),
                f"benchmark_driver_{traffic['driver']}")}


def metrics_of(m: dict, key: str, workload: str) -> list[dict]:
    """The manifest's metrics of one kind that this cell reports."""
    return [x for x in m[key]
            if "workloads" not in x or workload in x["workloads"]]


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def card_name(device) -> str:
    import torch
    return torch.cuda.get_device_name(device)


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, root: str = ROOT) -> int:
    """One run.  `device` None means the card, which must be present;
    tests pass "cpu" to drive the rest of a run without one."""
    a = parse(argv)
    sys.path.insert(0, root)
    import torch

    from benchmark import trace as trace_lib
    m = manifest(root)
    files = cell_files(m, a.workload, root)
    chips = int(files["cell"]["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"benchmark: the cell needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return EXIT_NO_CARD
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        print(f"card: {power_limit()}", file=sys.stderr, flush=True)

    run = files["driver"].Run(files["config"], files["traffic"], a.seed,
                              device)
    setup_s = time.perf_counter() - T_PROCESS
    metrics = {}
    breakdown = None
    if a.trace == 0:
        win = run.window(a.seconds)
        values = run.end_to_end(win)
        values["setup_s"] = setup_s
    else:
        win, reading, ctx = run.traced()
        breakdown = trace_lib.breakdown(reading)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    post_window = getattr(run, "post_window", None)
    if post_window is not None:
        post_window()
    if a.trace == 0:
        values["peak_device_mib"] = peak / 2 ** 20
        for x in metrics_of(m, "end_to_end", a.workload):
            metrics[x["name"]] = {"value": values[x["name"]],
                                  "unit": x["unit"]}
    else:
        ctx.update(run.after_trace())
        for x in metrics_of(m, "per_layer", a.workload):
            reader = load_module(
                os.path.join(root, "benchmark", "metrics", f"{x['name']}.py"),
                "benchmark_metric_" + x["name"].replace(".", "_"))
            v = reader.read(ctx)
            if v is not None:
                metrics[x["name"]] = {"value": v, "unit": x["unit"]}
    run.release()
    t_check = time.perf_counter()
    checks = run.check(files["limits"])
    print(f"timing: setup_s {setup_s:.3f}, check_s "
          f"{time.perf_counter() - t_check:.3f}", file=sys.stderr)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: this process loaded {', '.join(bad)}",
              file=sys.stderr)
        return EXIT_FORBIDDEN
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": card_name(device) if on_card else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if a.trace == 1:
        dev["busy_s"] = reading.busy_s
        dev["window_s"] = reading.window_s
    result = {"correct": correct, "attempted": int(win["attempted"]),
              "failed": int(run.failed), "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
