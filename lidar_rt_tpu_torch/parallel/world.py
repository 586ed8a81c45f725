"""Launch a world of ranks on this host: `run_world(fn, dp, rays, ...)`.

Each rank is a process started with the `spawn` method, so it imports
only the module that defines `fn` and what that module imports: keep
`fn` in a module free of anything a rank must not load.  The ranks meet
through a `file://` store in a fresh temporary directory (no port to
collide with another world on the host), build their `Mesh`, and run
`fn(mesh, *args)`; each returns its result, with tensors as numpy
arrays, to the caller.  A rank that raises, or a world that passes its
deadline, has every rank killed and raises in the caller.

The backend is the caller's choice: "nccl" when each rank has a card of
its own, "gloo" for CPU tensors or for ranks that share one card (NCCL
refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lidar_rt_tpu_torch.parallel.sharding import make_mesh


def to_numpy(x):
    """Tensors (also inside dicts, lists and tuples) as numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        values = [to_numpy(v) for v in x]
        return type(x)(*values) if hasattr(x, "_fields") else type(x)(values)
    return x


def _rank_main(rank: int, world: int, dp: int, rays: int, backend: str,
               device: str, init_file: str, timeout_s: float, fn, args,
               results) -> None:
    try:
        torch.set_num_threads(1)
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = to_numpy(fn(make_mesh(dp, rays), *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_world(fn, dp: int, rays: int, backend: str, device: str = "cpu",
              timeout_s: float = 120.0, args: tuple = ()) -> list:
    """Run fn(mesh, *args) on dp * rays ranks; returns their results in
    rank order.  device: every rank's device ("cpu", "cuda:0" for ranks
    sharing card 0, or "cuda" for card i on rank i).  Raises
    RuntimeError with the first failing rank's traceback, or TimeoutError
    when the world has not finished within timeout_s; either way every
    rank is killed first."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                         f"{backend!r}")
    world = dp * rays
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="world-")
    init_file = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(
        target=_rank_main,
        args=(r, world, dp, rays, backend,
              f"cuda:{r}" if device == "cuda" else device, init_file,
              timeout_s, fn, args, results), daemon=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout_s
    out: dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    try:      # a failed rank's traceback may still be in flight
                        rank, ok, value = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} of {world} exited with code "
                            f"{procs[dead[0]].exitcode} and no result"
                        ) from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"world of {world} ranks unfinished after "
                        f"{timeout_s} s; ranks done: {sorted(out)}")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{value}")
            out[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.01))
    finally:
        for p in procs:
            if p.pid is None:         # never started
                continue
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
