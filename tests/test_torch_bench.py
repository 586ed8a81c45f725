"""The port's bench (`lidar_rt_tpu_torch.bench`) and its six stage
profilers (`scripts.profile_stages`, `profile_amortized`, `stage_bench`,
`prep_bench`, `intercept_probe`, `grid_overhead_probe`) against the
reference's root `bench.py` and scripts of the same names, on the CPU at
16 x 512 rays and 8,192 surfels.

The reference's scripts run as `_torch_probes.reference_probe` runs them,
their timers stubbed and their values recorded.  `bench.py`'s jit and scan
are stubbed to run eagerly (the reference's eager render is what the port
is held to), so that each step's carry, loss and gradient can be read;
its renders take the jax engine, as its "auto" engine does off a TPU.
Where a script calls a Pallas function directly, that call is stubbed
(the jax engine in its place, or a constant where its output feeds only a
time).  The port's profilers run their coupled steps once on the host
clock (no CUDA graph on the CPU) through the kernels' plain twins.  Bars:
assignments and integers exact; a stage's float value within 1e-5
relative; arrays within 1e-5 of their largest magnitude; gradients within
3e-3 of the field's largest magnitude (the parity target's gradient bar).
"""

import collections
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu.ops import binning as j_binning
from lidar_rt_tpu.ops import pallas_tracer as j_pt
from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu_torch import bench
from lidar_rt_tpu_torch.core import sh as t_sh
from lidar_rt_tpu_torch.ops import cuda_tracer, kernels
from lidar_rt_tpu_torch.ops import tracer as t_tracer
from lidar_rt_tpu_torch.scripts import (grid_overhead_probe, intercept_probe,
                                        prep_bench, profile_amortized,
                                        profile_stages, stage_bench, street)
from _torch_probes import numbers, reference_bench, reference_probe

torch.set_num_threads(1)

H, W, N = 16, 512, 8192
STEPS, REBIN = 3, 2
GRAD_REL = 3e-3


class _Proxy:
    """A module with some attributes replaced."""

    def __init__(self, module, **attrs):
        self._module = module
        self.__dict__.update(attrs)

    def __getattr__(self, name):
        return getattr(self._module, name)


def _recording_vag(rec, grads: bool = True):
    """jax.value_and_grad that records each value (and with `grads` each
    gradient) as it is computed, eagerly or inside a jit
    (`jax.debug.callback`)."""
    def record(value, *grad):
        rec["losses"].append(value)
        rec["grads"].extend(grad)

    def value_and_grad(fn):
        vg = jax.value_and_grad(fn)

        def run(*args):
            value, g = vg(*args)
            jax.debug.callback(record, value, *((g,) if grads else ()))
            return value, g
        return run
    return value_and_grad


def _stepped_jax(rec):
    """jax whose lax.scan runs its steps from Python, each step jitted, so
    that each step's carry can be read (recorded in order), and whose
    value_and_grad records each value (`_recording_vag`); a jitted
    function runs once
    for each set of arguments, and block_until_ready records what it
    receives."""
    def jit(fn):
        memo = {}

        def run(*args):
            key = tuple(map(id, args))
            if key not in memo:
                memo[key] = fn(*args)
            return memo[key]
        return run

    def scan(fn, carry, xs=None, length=None):
        step = jax.jit(fn)
        for i in range(length if xs is None else len(xs)):
            carry, _ = step(carry, None if xs is None else xs[i])
            rec["carries"].append(carry)
        return carry, None

    def block_until_ready(x):
        rec["blocked"].append(x)
        return jax.block_until_ready(x)

    return _Proxy(jax, jit=jit, block_until_ready=block_until_ready,
                  value_and_grad=_recording_vag(rec, grads=False),
                  lax=_Proxy(jax.lax, scan=scan))


def _jax_trace(b, grid, width, s2w, bg, degree, pcfg, assignment=None):
    """The reference's Pallas `trace` replaced by its jax engine (the parity
    target) at the same tiles."""
    return j_tracer.trace(b, grid, width, s2w, bg, degree,
                          j_tracer.TraceConfig(tile=pcfg.tile, engine="jax"),
                          assignment=assignment)


def _close(got, want, rel=1e-5):
    """got within rel of want's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= rel * np.abs(want).max() + 1e-30


def _scalar(got, want, rel=1e-5):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * abs(want), (got, want)


def _same_assignment(got, want):
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.truncated.numpy(),
                                  np.asarray(want.truncated))


def _same_grads(got, want):
    for f in got._fields:
        _close(getattr(got, f).numpy(), getattr(want, f), GRAD_REL)


def _same_parts(got, want):
    """cuda_tracer._prepare_tile_inputs' six arrays against
    pallas_tracer's (whose opac and sign keep a unit axis)."""
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        _close(g.numpy(), w_.reshape(g.shape))


@pytest.fixture(scope="module")
def scene():
    grid, s2w = street.sensor(H, "cpu")
    return street.street_scene_bundle(N, 0, "cpu"), grid, s2w


@pytest.fixture(scope="module")
def ref_bundle():
    return reference_bench().street_scene_bundle(N)


def test_bench_step_is_the_references(scene):
    """3 coupled steps re-binned every 2 in float32: each step's
    assignment, loss and carried opacity gradient."""
    rec = collections.defaultdict(list)
    reference_probe("../bench.py", H, W, N, H=H, W=W, N_SURFELS=N,
                    ITERS=STEPS, WARMUP=1, REBIN_EVERY=REBIN,
                    jax=_stepped_jax(rec))
    bundle, grid, s2w = scene
    cfg = bench.trace_config(bench.knobs({}), fast=False)
    assert not cfg.use_cache and cfg.resolve_engine() == "cuda"
    sc = bench.scene(bundle, grid, W, s2w)
    carry, carries = bench.start(sc), []
    kernels.reset_launches()
    for i in range(STEPS):
        carry = bench.step(sc, cfg, carry, i, rebin_every=REBIN)
        carries.append(carry)
    assert sum(kernels.launch_counts().values()) == 0
    assert len(rec["carries"]) == len(rec["losses"]) == STEPS
    for i, (got, (g_ref, idx, val, trunc)) in enumerate(
            zip(carries, rec["carries"])):
        (a,) = got.chain
        np.testing.assert_array_equal(a.index.numpy(), np.asarray(idx[0]))
        np.testing.assert_array_equal(a.valid.numpy(), np.asarray(val[0]))
        np.testing.assert_array_equal(a.truncated.numpy(),
                                      np.asarray(trunc[0]))
        _scalar(got.loss, rec["losses"][i])
        _close(got.grad.numpy(), g_ref, GRAD_REL)
    # The steps after a rebin reuse its chain; the rebin at step 2 binned
    # the same scene again.
    assert carries[1].chain is carries[0].chain
    assert carries[2].chain is not carries[0].chain
    # The value the reference's timer waits on is the last carry's sum.
    assert float(rec["blocked"][-1]) == float(jnp.sum(rec["carries"][-1][0]))


def test_profile_stages_is_the_references(scene):
    rec = collections.defaultdict(list)

    def timed_scan(stage_fn, bundle, label):
        rec["labels"].append(label)
        rec["values"].append(stage_fn(bundle))
        return 1.0

    def bin_surfels(*args, **kw):
        rec["bin"].append(j_binning.bin_surfels(*args, **kw))
        return rec["bin"][-1]

    def prepare(*args):
        rec["prep"].append(j_pt._prepare_tile_inputs(*args))
        return rec["prep"][-1]

    out = reference_probe(
        "profile_stages.py", H, W, N, timed_scan=timed_scan,
        bin_surfels=bin_surfels, jax=_Proxy(
            jax, value_and_grad=_recording_vag(rec)),
        pallas_tracer=_Proxy(j_pt, trace=_jax_trace,
                             _prepare_tile_inputs=prepare))
    bundle, grid, s2w = scene
    rows = profile_stages.profile(bundle, grid, W, s2w, "cpu",
                                  bench.knobs({}), iters=1)
    assert list(rows) == rec["labels"] == list(profile_stages.LABELS)
    _same_assignment(rows["bin"]["value"], rec["bin"][0])
    _same_parts(rows["bin+prep"]["value"], rec["prep"][0])
    _scalar(sum(p.sum() for p in rows["bin+prep"]["value"][:3]),
            rec["values"][1])
    _scalar(rows["fwd (bin+prep+kernel+untile)"]["value"], rec["values"][2])
    loss, grads = rows["fwd+bwd"]["value"]
    _scalar(loss, rec["losses"][0])
    _same_grads(grads, rec["grads"][0])
    got = profile_stages.lines(rows, H, W, "cpu")
    assert got[0].startswith("CPU: no graph")
    for label, line in zip(profile_stages.LABELS, got[1:]):
        assert line.startswith(label) and " eager " in line
    assert sum(ln.startswith("stages (") for ln in got) == 2
    assert out.splitlines()[-1].startswith("stages: bin ")


def test_profile_amortized_is_the_references(scene, ref_bundle):
    rec = collections.defaultdict(list)
    stages = {}

    def timed(stage_fn, label):
        stages[label] = stage_fn
        return 1.0

    def prepare(*args):
        rec["prep_args"].append(args)
        return j_pt._prepare_tile_inputs(*args)

    out = reference_probe(
        "profile_amortized.py", H, W, N, pre={
            "timed": timed,
            "jax": _Proxy(jax, value_and_grad=_recording_vag(rec)),
            "pallas_tracer": _Proxy(j_pt, trace=_jax_trace,
                                    _prepare_tile_inputs=prepare)})
    want = {label: fn(ref_bundle) for label, fn in stages.items()}
    bundle, grid, s2w = scene
    r = profile_amortized.profile(bundle, grid, W, s2w, "cpu", iters=1)
    rows = r["rows"]
    assert list(rows) == list(want) == list(profile_amortized.LABELS)
    _, _, index, valid = rec["prep_args"][0]
    np.testing.assert_array_equal(r["assignment"].index.numpy(),
                                  np.asarray(index))
    np.testing.assert_array_equal(r["assignment"].valid.numpy(),
                                  np.asarray(valid))
    (mean,) = numbers(out.splitlines()[0])
    assert out.startswith("mean cand:")
    _scalar(r["mean_cand"], mean, 1e-7)
    labels = profile_amortized.LABELS
    _scalar(sum(p.sum() for p in rows[labels[0]]["value"][:3]),
            want[labels[0]])
    _scalar(rows[labels[1]]["value"], want[labels[1]])
    loss, grads = rows[labels[2]]["value"]
    _scalar(loss, rec["losses"][0])
    _same_grads(grads, rec["grads"][0])
    got = profile_amortized.lines(r, H, W, "cpu")
    assert got[0] == f"mean cand: {r['mean_cand']}"


def test_stage_bench_is_the_references(scene):
    """Binning and prep against the reference's; its kernel and
    trace_forward call Pallas and are stubbed there, so the port's kernel
    stage is held to its own trace_forward instead."""
    rec = {}

    def timeit(name, fn, *args):
        rec[name] = fn(*args)
        return rec[name]

    reference_probe("stage_bench.py", H, W, N, pre={
        "timeit": timeit,
        "pt": _Proxy(j_pt, _core_fwd_call=lambda *a: jnp.zeros(()),
                     trace_forward=lambda *a, **k: jnp.zeros(()))})
    bundle, grid, s2w = scene
    rows = stage_bench.profile(bundle, grid, W, s2w, "cpu", iters=1)
    assert list(rows) == list(rec) == list(stage_bench.LABELS)
    _same_assignment(rows["bin"]["value"], rec["bin"])
    got = rows["prep(gathers+basis)"]["value"]
    (cnt, dirs, _drows, mind, axes, plane, inv_scale, opac, sign,
     sh) = rec["prep(gathers+basis)"]
    np.testing.assert_array_equal(got.cnt.numpy(), np.asarray(cnt)[:, 0])
    np.testing.assert_array_equal(got.mind.numpy(), np.asarray(mind)[..., 0])
    _same_parts((got.dirs, got.axes, got.plane, got.inv_scale, got.opac,
                 got.sign, got.sh),
                (dirs, axes, plane, inv_scale, opac, sign, sh))
    chans, accum_tk = rows["kernel"]["value"]
    img, accum = rows["trace_forward total"]["value"]
    tile = stage_bench.TILE
    assert torch.equal(cuda_tracer.from_tiles(chans.transpose(1, 2), tile, H,
                                              W)[..., :10], img)
    assert torch.equal(cuda_tracer.scatter_accum(rows["bin"]["value"],
                                                 accum_tk, N), accum)


def test_prep_bench_is_the_references(scene):
    rec = {}

    def timeit(name, fn, *args):
        rec[name] = fn(*args)
        return rec[name]

    reference_probe("prep_bench.py", H, W, N, pre={"timeit": timeit})
    bundle, grid, s2w = scene
    rows = prep_bench.profile(bundle, grid, W, s2w, "cpu", iters=1)
    assert [f"{label}" for label in rows] == list(rec) == list(
        prep_bench.LABELS)
    value = {label: row["value"] for label, row in rows.items()}
    _same_assignment(value["bin"], rec["bin"])
    for g, w_ in zip(value["bin stage0 (bounds)"],
                     rec["bin stage0 (bounds)"]):
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        else:
            _close(g.numpy(), w_)
    # Stage 1: the reference's top-K of -range, the port's nearest ranges.
    # The ranges round apart by an ulp (the reference's come from a jitted
    # stage 0), the lists are the same.
    rng, idx = value["bin stage1 (topKc)"]
    w_neg, w_idx = (np.asarray(x) for x in rec["bin stage1 (topKc)"])
    live = np.isfinite(w_neg)
    np.testing.assert_array_equal(np.isfinite(rng.numpy()), live)
    _close(rng.numpy()[live], -w_neg[live])
    np.testing.assert_array_equal(idx.numpy()[live], w_idx[live])
    _close(value["dirs gather+tile"].numpy(), rec["dirs gather+tile"])
    _close(value["sh basis"].numpy(), rec["sh basis"])
    for f in value["build_frames (all N)"]._fields:
        _close(getattr(value["build_frames (all N)"], f).numpy(),
               getattr(rec["build_frames (all N)"], f))
    _same_parts(value["candidate gathers"], rec["candidate gathers"])
    assert all(row["ops"] is None for row in rows.values())


@pytest.fixture(scope="module")
def intercept(scene):
    bundle, grid, s2w = scene
    kernels.reset_launches()
    p = intercept_probe.profile(bundle, grid, W, s2w, "cpu",
                                bench.knobs({}), iters=1)
    assert sum(kernels.launch_counts().values()) == 0
    return p


def test_intercept_probe_is_the_references(intercept):
    rec = collections.defaultdict(list)

    def prepare(*args):
        rec["prep"].append(j_pt._prepare_tile_inputs(*args))
        return rec["prep"][-1]

    out = reference_probe(
        "intercept_probe.py", H, W, N,
        timed=lambda fn, *args, label="": 1.0,
        pallas_tracer=_Proxy(j_pt, _prepare_tile_inputs=prepare))
    head = out.splitlines()[0]
    m = re.match(r"tile (\d+)x(\d+) K=(\d+) rb=\d+: (\d+) tiles, \d+ grid "
                 r"steps, mean cnt (\d+)$", head)
    p = intercept
    got = intercept_probe.lines(p, "cpu")
    g = re.match(r"tile (\d+)x(\d+) K=(\d+) \(no ray_block here\): (\d+) "
                 r"tiles, (\d+) CUDA blocks of 128 rays, mean cnt (\d+)$",
                 got[0])
    assert m and g, (head, got[0])
    assert m.group(1, 2, 3, 4, 5) == g.group(1, 2, 3, 4, 6)
    assert int(g.group(5)) == p["tiles"] * (8 * 128 // 128)
    x = p["inputs"]
    _same_parts((x.axes, x.plane, x.inv_scale, x.opac, x.sign,
                 x.sh * t_sh.degree_mask(3)[:, None]), rec["prep"][0])
    assert [ln.split()[0] for ln in got[2:7]] == list(intercept_probe.LABELS)


def test_every_count_zero_forward_composites_nothing(intercept):
    """With every count zero the forward (the twin here) composites
    nothing: channel rows 0-7 and 10-15 and accum zero, the
    transmittance rows 8 and 9 the initial transmittance, exactly; the
    backward's opacity gradient zero."""
    rows, t0 = intercept["rows"], intercept["inputs"].t0
    chans, accum = rows["fwd_cnt0"]["value"]
    assert bool((chans[:, :8] == 0).all()) and bool((chans[:, 10:] == 0).all())
    assert torch.equal(chans[:, 8], t0) and torch.equal(chans[:, 9], t0)
    assert bool((accum == 0).all())
    assert bool((rows["fwd+bwd_cnt0"]["value"] == 0).all())
    full, _ = rows["fwd_full"]["value"]
    assert bool((full[:, 4] > 0).any())
    assert bool((rows["fwd+bwd_full"]["value"] != 0).any())


def test_grid_overhead_probe_is_the_references(scene):
    # Each row's one step carries its render's accum x 1e-30.
    rec = collections.defaultdict(list)
    out = reference_probe(
        "grid_overhead_probe.py", H, W, N, ITERS=1, jax=_stepped_jax(rec),
        pallas_tracer=_Proxy(j_pt, trace=_jax_trace))
    bundle, grid, s2w = scene
    rows = grid_overhead_probe.profile(bundle, grid, W, s2w, "cpu", iters=1)
    want = {}
    accums = [np.asarray(c, np.float64) * 1e30 for c in rec["carries"]]
    for line, accum in zip(out.splitlines(), accums):
        m = re.match(r"(\d+)x(\d+) K=(\d+) rb=(\d+) .* ms +(\d+) steps", line)
        th, tw, k, rb, steps = (int(v) for v in m.groups())
        tiles = steps // (th * tw // rb)
        want.setdefault((th, tw, k), []).append((tiles, accum))
    assert sorted(want) == sorted(r["tile"] for r in rows)
    assert [len(v) for v in want.values()] == [3, 1, 1, 1, 1]
    for r in rows:
        th, tw, k = r["tile"]
        for tiles, accum in want[r["tile"]]:
            assert r["tiles"] == tiles
            assert r["pairs"] == tiles * th * tw * k
            _scalar(r["value"].sum(), accum.sum())
            _close(r["value"].numpy(), accum, 1e-4)
    got = grid_overhead_probe.lines(rows, "cpu")
    assert len(got) == 1 + len(rows)


@pytest.mark.parametrize("ray_block", ["128", "256", "1024"])
def test_ray_block_other_than_512_raises(ray_block):
    with pytest.raises(ValueError, match="one thread per ray"):
        bench.knobs({"BENCH_RAY_BLOCK": ray_block})


def test_bench_knobs_are_the_references(monkeypatch):
    """The knobs' names and defaults are the reference's, and they reach
    the trace configuration."""
    ref = reference_bench()
    kn = bench.knobs({"BENCH_RAY_BLOCK": "512"})
    assert kn == bench.Knobs(ref._TILE_H, ref._TILE_W, ref._K, ref._TAIL,
                             ref._EXACT, ref._MACRO, ref._INT_EPS)
    env = {"BENCH_TILE_H": "16", "BENCH_TILE_W": "64", "BENCH_K": "128",
           "BENCH_TAIL": "1", "BENCH_EXACT": "1", "BENCH_MACRO_COLS": "512",
           "BENCH_INT_EPS": "0.5"}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    cfg = bench.trace_config()
    assert (cfg.tile.tile_h, cfg.tile.tile_w, cfg.tile.max_per_tile,
            cfg.tail_passes, cfg.exact_order, cfg.tile.macro_cols,
            cfg.tile.int_eps) == (16, 64, 128, 1, True, 512, 0.5)
    assert (cfg.tile.pad_px, cfg.tile.snap_pad_px, cfg.tile.binner,
            cfg.fast_math, cfg.cache_fwd) == (2.0, 0.5, "hier", True, True)
    assert not cfg.use_cache     # exact order replays, as the reference


@pytest.mark.parametrize("degree", [-2, -1, 0, 1, 2, 3, 4])
def test_degree_mask_keeps_the_cpu_render(scene, degree):
    """The mask made on the device has the bits of the mask the host used
    to copy, and a CPU render with it is bit-identical."""
    old = torch.as_tensor(t_sh._DEGREE_OF_COEFF <= degree,
                          dtype=torch.float32)
    assert torch.equal(t_sh.degree_mask(degree), old)
    if degree not in (0, 3):
        return
    bundle, grid, s2w = scene
    bg = torch.tensor([0.0, 0.0, 1.0])
    cfg = t_tracer.TraceConfig(tile=stage_bench.TILE)
    new = t_tracer.trace(bundle, grid, W, s2w, bg, degree, cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_sh, "degree_mask", lambda d, device=None: torch.as_tensor(
            t_sh._DEGREE_OF_COEFF <= int(d), dtype=torch.float32,
            device=device))
        was = t_tracer.trace(bundle, grid, W, s2w, bg, degree, cfg)
    assert torch.equal(new.channels, was.channels)
    assert torch.equal(new.accum_weights, was.accum_weights)


def test_graph_ms_on_the_cpu_runs_the_steps_on_the_host_clock():
    """On the CPU there is no graph: the steps run in order, once each,
    on the host clock, and the line says so."""
    seen = []
    g = street.graph_ms(seen.append, 4, "cpu")
    assert seen == [0, 1, 2, 3] and g.ms > 0
    assert g.captured == {k: 0 for k in kernels.LAUNCH_COUNTS}
    seen.clear()
    assert street.eager_ms(seen.append, 3, "cpu", warmup=2) > 0
    assert seen == [0, 1, 0, 1, 2]
    assert street.timer_note("cpu").startswith("CPU: no graph")
    assert street.device_profile(lambda: None, 1, "cpu") is None


def test_bench_commands_run_on_the_cpu(capsys, monkeypatch):
    """Each command with --device cpu on the street scene cut to a tiny
    size: the card line reads CPU, each prints its lines, the bench its
    JSON last."""
    import json

    monkeypatch.setattr(street, "H", 8)
    monkeypatch.setattr(street, "W", 256)
    monkeypatch.setattr(street, "N_SURFELS", 2048)
    monkeypatch.setattr(bench, "ITERS", 2)
    mods = (profile_stages, profile_amortized, stage_bench, prep_bench,
            intercept_probe, grid_overhead_probe)
    for mod in mods:
        monkeypatch.setattr(mod, "ITERS", 1)
    r = bench.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("CPU; street scene 2048 surfels, 8 x 256")
    last = json.loads(out[-1])
    assert sorted(last) == ["metric", "unit", "value"]
    assert "CPU" in last["metric"] and last["unit"] == "Mray/s/chip"
    assert r["graph_carry"].grad.shape == (2048,)
    for mod in mods:
        mod.main(["--device", "cpu"])
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith("CPU; street scene 2048 surfels")
        assert any(ln.startswith("CPU: no graph") for ln in out), mod


def test_se3_fills_its_corner_on_the_device():
    """`transforms.se3` (through `invert_se3`, which the render's binning
    calls) fills its corner with a device fill, which a CUDA graph can
    capture, and keeps the matrices it made."""
    from lidar_rt_tpu_torch.core import transforms

    gen = torch.Generator().manual_seed(0)
    r = torch.randn(5, 3, 3, generator=gen)
    t = torch.randn(5, 3, generator=gen)
    want = torch.zeros(5, 4, 4)
    want[:, :3, :3], want[:, :3, 3], want[:, 3, 3] = r, t, 1.0
    assert torch.equal(transforms.se3(r, t), want)
    assert torch.equal(transforms.se3(r[0], t[0]), want[0])
