"""The program's spans in one cell's traced window, on the card.

    python3 benchmark/port_spans.py --workload kitti360.train --seed 7

Sets the cell up as `run.py` does, runs its traffic's traced window
(`drivers/<driver>.py` `traced`: the same steps and `bench.*` spans as a
`--trace 1` run) under `port_trace.keeping_port`, and prints, per traced step, each port span's
device self ms, host self ms, synchronising calls and the device's idle
ms in gaps that began inside it; the share of `lrt.step`'s device and
idle time that no child span holds; the longest idle gaps named by the
innermost span of either kind; the window's ms per step; and, for a
trainer, the frames binned per step.  The last line of standard output
is all of it as JSON.  Nothing is checked against the reference, and no
metric of `BENCHMARK.json` is reported.  It exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 benchmark/port_spans.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    return p.parse_args(argv)


def summary(port, reading, steps: int) -> dict:
    """Per-step numbers of a PortReading, by span, and the step's cover."""
    from benchmark import port_trace
    names = sorted(set(port.device_s) | set(port.host_s) | set(port.syncs)
                   | set(port.idle_s))
    per = {n: {"device_ms": port.device_s.get(n, 0.0) / steps * 1e3,
               "host_self_ms": port.host_s.get(n, 0.0) / steps * 1e3,
               "syncs": port.syncs.get(n, 0) / steps,
               "idle_ms": port.idle_s.get(n, 0.0) / steps * 1e3}
           for n in names}
    step_dev = port.root_device_s.get("lrt.step", 0.0)
    step_idle = port.root_idle_s.get("lrt.step", 0.0)
    ctx = {"port": port, "steps": steps}
    return {
        "spans": per,
        "step_device_ms": step_dev / steps * 1e3,
        "step_idle_ms": step_idle / steps * 1e3,
        "step_self_device_share": (port.device_s.get("lrt.step", 0.0)
                                   / step_dev if step_dev else None),
        "step_self_idle_share": (port.idle_s.get("lrt.step", 0.0)
                                 / step_idle if step_idle else None),
        "port_syncs": port_trace.port_syncs(ctx),
        "gaps_ms": [[n, s * 1e3] for n, s in port.gaps],
        "window_ms": reading.window_s / steps * 1e3,
        "busy_ms": reading.busy_s / steps * 1e3,
        "harness_span_ms": {k: v / steps * 1e3
                            for k, v in reading.span_device_s.items()},
    }


def main(argv=None) -> int:
    a = parse(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import port_trace, run
    if not torch.cuda.is_available():
        print("port_spans: needs a CUDA device", file=sys.stderr)
        return run.EXIT_NO_CARD
    device = torch.device("cuda", 0)
    files = run.cell_files(run.manifest(ROOT), a.workload, ROOT)
    card = run.power_limit()
    print(f"card: {card}", file=sys.stderr, flush=True)
    r = files["driver"].Run(files["config"], files["traffic"], a.seed,
                            device)
    trainer = getattr(r, "trainer", None)
    rebins0 = trainer.state.bins.rebins if trainer is not None else None
    with port_trace.keeping_port() as kept:
        win, reading, _ = r.traced()
    steps = int(win["attempted"])
    out = {"workload": a.workload, "seed": a.seed, "steps": steps,
           "card": card,
           **summary(kept["port"], reading, steps)}
    if trainer is not None:
        out["rebins_per_step"] = (trainer.state.bins.rebins - rebins0) / steps
    for n, v in sorted(out["spans"].items(), key=lambda kv: -kv[1][
            "device_ms"]):
        print(f"{n:20s} device {v['device_ms']:9.3f} ms  host self "
              f"{v['host_self_ms']:9.3f} ms  syncs {v['syncs']:7.2f}  idle "
              f"{v['idle_ms']:9.3f} ms", file=sys.stderr)
    print(json.dumps(out), flush=True)
    r.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
