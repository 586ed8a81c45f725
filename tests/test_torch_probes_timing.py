"""The street scene (`scripts.street`) and the port's timing probes
(`scripts.profile_binner`, `sweep_perf`, `compact_probe`) against the
reference's `bench.py` and scripts of the same names, on the CPU at a
small size (8,192 surfels scanned at 16 x 512).

The street soup is held to `bench.street_scene_bundle` bit for bit.  A
timing probe's times mean nothing here, so the reference's scripts are run
(as `_torch_probes.reference_probe` runs them) with their timers stubbed,
and the port's probes with one timed call, and what does not depend on
time is held to the reference's: the candidates per tile, their
percentiles and the truncated tiles of every binner config, the mean
candidates per tile of every sweep config, the gathers' GB, and the
per-ray lists a compacted design would build.  In `sweep_perf` the
reference's tracer is stubbed by a cheap function of the bundle (its
rendered channels feed only the times), and the port's probe renders
through the plain twins on CPU tensors, launching no kernel.
"""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu_torch.ops import kernels
from lidar_rt_tpu_torch.scripts import (compact_probe, profile_binner,
                                        street, sweep_perf)
from _torch_probes import ROOT, numbers, reference_bench, reference_probe

torch.set_num_threads(1)

H, W, N = 16, 512, 8192


@pytest.fixture(scope="module")
def scene():
    grid, s2w = street.sensor(H, "cpu")
    return street.street_scene_bundle(N, 0, "cpu"), grid, s2w


@pytest.mark.parametrize("n, seed", [(512, 3), (8192, 0), (131_072, 0)])
def test_street_scene_is_the_bench_scene(n, seed):
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    before = [getattr(jax.config, k) for k in keys]
    bench = reference_bench()
    # bench.py's own cache settings do not outlive its import.
    assert [getattr(jax.config, k) for k in keys] == before
    ref = bench.street_scene_bundle(n, seed=seed)
    got = street.street_scene_bundle(n, seed, "cpu")
    for f in got._fields:
        want = np.asarray(getattr(ref, f))
        assert getattr(got, f).dtype == torch.float32
        np.testing.assert_array_equal(getattr(got, f).numpy(), want,
                                      err_msg=f)
    assert (street.H, street.W, street.N_SURFELS) == \
        (bench.H, bench.W, bench.N_SURFELS)


def test_street_sensor_is_the_probes():
    """The probes' grid and pose (`scripts/survivor_stats.py:46-48`)."""
    from lidar_rt_tpu.core import rays as j_rays

    grid, s2w = street.sensor(street.H, "cpu")
    want = j_rays.SensorGrid.from_bounds(street.H, (-0.31, 0.04),
                                         pixel_offset=0.5)
    np.testing.assert_array_equal(grid.row_inclinations.numpy(),
                                  np.asarray(want.row_inclinations))
    assert (grid.pixel_offset, grid.angle_offset) == \
        (want.pixel_offset, want.angle_offset)
    np.testing.assert_array_equal(
        s2w.numpy(), np.asarray(jnp.eye(4).at[2, 3].set(2.0)))


def test_profile_binner_counts_are_the_references(scene):
    bundle, grid, s2w = scene
    r = profile_binner.profile(bundle, grid, W, s2w, "cpu", iters=1)
    out = reference_probe("profile_binner.py", H, W, N,
                          timed=lambda fn, bundle: 0.0)
    got = {ln[:28].strip(): ln for ln in profile_binner.lines(r)[1:]}
    want = {ln[:28].strip(): ln for ln in out.splitlines()[1:]}
    assert list(got) == list(want)
    for label, ln in got.items():
        # cand/tile mean, p95, max; truncated tiles and their overflow.
        want_n = numbers(want[label].split(" ms ")[1])
        if "m1024" in label:
            # K_a = 4 x 2048 = N here: the macro level is off, as in the
            # reference, and the line says so after the reference's
            # numbers.
            assert r[label]["macro_trunc"] is None
            assert ln.endswith("macro level off (K_a >= N)")
            ln = ln[:ln.index("   macro")]
        assert numbers(ln.split(" ms ")[1]) == want_n, label
    assert r["footprint_ms"] > 0.0


def test_sweep_perf_counts_are_the_references(scene):
    bundle, grid, s2w = scene
    kernels.reset_launches()
    rows = sweep_perf.sweep(bundle, grid, W, s2w, sweep_perf.CONFIGS,
                            fast=False, device="cpu", iters=1)
    assert kernels.forward_launches == kernels.backward_launches == 0

    def trace(b, *args):
        s = jnp.sum(b.opacities)
        return types.SimpleNamespace(channels=jnp.zeros((1, 1, 4)) + s)

    out = reference_probe(
        "sweep_perf.py", H, W, N, ITERS=1,
        tracer_lib=types.SimpleNamespace(TraceConfig=j_tracer.TraceConfig,
                                         trace=trace))
    want = {}
    for ln in out.splitlines():
        m = re.search(r" (\d+)x(\d+) K=(\d+) rb=\d+: .* mean cand/tile "
                      r"(\d+)$", ln)
        want.setdefault(tuple(int(v) for v in m.groups()[:3]),
                        set()).add(m.group(4))
    assert sorted(want) == sorted(r["tile"] for r in rows)
    for r, ln in zip(rows, sweep_perf.lines(rows)):
        assert want[r["tile"]] == {ln.rsplit(" ", 1)[1]}, ln
        assert r["fwd_ms"] > 0 and r["fwd_bwd_ms"] > 0 and r["bin_ms"] > 0
    assert len(out.splitlines()) == 5 and len(rows) == 3


def test_compact_probe_lists_are_the_references(scene):
    """The per-ray lists of K'=32 nearest gate-passers the reference's
    `build_lists` builds (taken from its timer stub) against the port's;
    every line's structure and the gathers' GB."""
    bundle, grid, s2w = scene
    built = []

    def timeit(fn, *args, iters=20, warmup=3):
        built.append(np.asarray(jax.block_until_ready(fn(*args))))
        return 1.0

    out = reference_probe(
        "compact_probe.py", H, W, N, timeit=timeit,
        chained_gather_ms=lambda ops, idx, iters=8: 1.0,
        chained_scatter_ms=lambda idx, grads, n, iters=8: 1.0)
    t_total = (H // 8) * (W // 128)
    lists = built[0].reshape(t_total, 8 * 128, compact_probe.K_LISTS)
    got = compact_probe.build_lists(bundle, grid, W, s2w,
                                    compact_probe.K_LISTS).numpy()
    assert got.shape == lists.shape
    np.testing.assert_array_equal(got, lists)

    r = compact_probe.probe(bundle, grid, W, s2w, "cpu", iters=1)
    got_lines, want_lines = compact_probe.lines(r), out.splitlines()
    assert len(got_lines) == len(want_lines)
    assert got_lines[0] == want_lines[0] == f"rays {H * W}, surfels {N}"
    for g, w_ in zip(got_lines[1:4], want_lines[1:4]):
        # gather F=58 K': its GB out.
        assert numbers(g)[:2] == numbers(w_)[:2]
        assert re.search(r"\(([\d.]+) GB out", g).group(1) == \
            re.search(r"\(([\d.]+) GB out", w_).group(1)
    for g, w_ in zip(got_lines[4:], want_lines[4:]):
        assert g.split(":")[0] == w_.split(":")[0]
    assert "dense flagship step, tile-order forward+backward here" in \
        got_lines[-1] and "~11.3 ms" not in "".join(got_lines)
    assert all(np.isfinite(v) and v > 0 for v in
               (r["segsum"], r["lists"], r["dense"],
                *r["gather"].values(), *r["scatter"].values()))


def test_probe_commands_run_on_the_cpu(capsys, monkeypatch):
    """Each timing probe's command with --device cpu, on the street scene
    cut to a tiny size: the card line reads CPU and its lines print."""
    monkeypatch.setattr(street, "H", 8)
    monkeypatch.setattr(street, "W", 256)
    monkeypatch.setattr(street, "N_SURFELS", 2048)
    argv = ["--device", "cpu"]
    profile_binner.main(argv)
    sweep_perf.main(argv + ["--fast"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("CPU; street scene 2048 surfels, 8 x 256")
    assert sum("macro level off" in ln for ln in lines) == 1
    assert sum(" fast: fwd " in ln for ln in lines) == 3
    assert (ROOT / "bench.py").exists()
