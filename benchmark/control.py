"""The control of a cell's comparison: the plain reference put in the
program's place and computed one precision lower than the configuration
states (bfloat16 for its float32), read by the same numbers as a run's
check, on the card at the cell's own size.  It has to come out as not
correct; its smallest reading over the seeds is the upper reading of each
limit.  The benchmark's runs do not run it.

    python3 benchmark/control.py --workload waymo.fwdbwd --seeds 11 12 13
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main(argv=None, device=None, root: str = ROOT) -> dict:
    p = argparse.ArgumentParser(prog="python3 benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--steps", type=int, default=3)
    a = p.parse_args(argv)
    sys.path.insert(0, root)
    import torch

    from benchmark import run
    files = run.cell_files(run.manifest(root), a.workload, root)
    device = torch.device("cuda", 0) if device is None else torch.device(
        device)
    per_seed = {}
    for seed in a.seeds:
        per_seed[seed] = files["driver"].control(
            files["config"], files["traffic"], seed, device, a.steps)
        print(json.dumps({"seed": seed, "numbers": per_seed[seed]}),
              flush=True)
    lowest = {k: min(n[k] for rows in per_seed.values() for n in rows)
              for k in files["limits"]}
    fails = {k: lowest[k] > files["limits"][k] for k in lowest}
    out = {"workload": a.workload, "lowest": lowest,
           "limits": files["limits"], "fails_every_limit": fails}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
