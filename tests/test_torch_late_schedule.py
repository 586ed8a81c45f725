"""The late training schedule, both packages from one state, on the CPU.

1. In miniature, trained: the run-level counterpart of the density-control
tests in `test_torch_train.py`.  `configs/rehearsal/full.yaml` densifies
every 100 steps from 500 to 15,000, resets the opacities every 3,000,
raises the SH degree every 1,000, rebins every 10 steps and switches from
its warm-up budget (K=512) to K=256 with one tail pass at 2,000; every
densify event after the first reset runs with the world-size prune, and
the actors' with their box prune (`use_size`,
`lidar_rt_tpu/train/loop.py:547`, `lidar_rt_tpu_torch/train/loop.py:498`).
`LATE_OPT` keeps those events and their order at a few steps apiece on
the synthetic scene (3 frames, 16 x 128, one actor;
`test_torch_train.synthetic_scene`): densify events at 5, 10, 15, 20 and
25, those at 15, 20 and 25 with both prunes on, opacity resets at 10 and
20, the switch from K=256 to K=128 with one tail pass after step 8, an SH
raise at 15 and a rebin every 4 steps.  Its gradient threshold is 1e-3
(full.yaml: 2e-4): on 16 x 128 rays a surfel's mean gradient over 5 steps
runs higher than over 100 at 64 x 2650, and at 2e-4 half the background
splits at each early event and the capacity fills.  The reference's
`loop.Trainer` runs on its jax engine (its tail pass's cutoff taken with
its binner's range, `binner_range_cutoff`); the port's on its kernel
path, whose plain twins run on CPU tensors, in float32.  The port's
densify draws are the reference's: each event's jax key gives the split
and box normals, as `test_densify_and_prune_matches_reference` hands them
over.

Held, run free from one state: each reset at the same iterations; every
densify event at the same iterations, with equal counts (cloned, split,
pruned, dropped, alive) for the background and the actors up to the
event at 10, where the background's part (720 splits against 718), and
later within COUNT_FRAC of the asset's alive surfels; the loss at every
step within LOSS_RTOL before the first event, LOSS_FREE_RTOL after it;
at the end the actors' alive sets equal and their parameters within
PARAM_ATOL, the background's alive sets within COUNT_FRAC.  Why they
part: Adam's eps of 1e-15 moves a parameter by a whole learning rate
whatever its gradient's size, so where a gradient is noise its sign
decides (ROADMAP's numeric traps); after 5 steps the background's means
differ by up to 3.2 cm while the losses agree to 3e-6, and the first
event's children inherit that.  Rerun from the reference's state: the
port restarted from the reference's own state after each event (its
checkpoint carried as `export_jax_ckpt.py` and `import_jax_ckpt` carry
it, the reference's frames and draws) gives the reference's counts at the
next event exactly and its loss at every step within LOSS_RTOL, and from
the state after 25 the same alive sets and the parameters within
RESTART_ATOL after the last 3 steps: the schedule's rules are the
reference's, and what parts the free runs is drift.

2. At full length, stubbed: every schedule event of each Trainer over
`full.yaml`'s 30,000 iterations, driven as the CLIs drive them (a
`Trainer.run` per 1,000-step eval), with the step stubbed (the
reference's `make_train_step_n`, the port's `make_train_step`): the frame
and budget of each step, whether its frame's cached assignment was stale
(rebin), the SH degree, each densify with its `use_size`, each opacity
reset, each log stamp and each eval; and the same from a resume at 8,000
under `full.yaml` and the two fork configs, the port restored with
`Trainer.restore` and the reference given its state and iteration as its
CLI does (`lidar_rt_tpu/cli.py:163-165`).  The lists are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu import cli as j_cli
from lidar_rt_tpu import config as j_config
from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu.train import density as j_density
from lidar_rt_tpu.train import loop as j_loop
from lidar_rt_tpu_torch import config as t_config
from lidar_rt_tpu_torch.scripts import import_jax_ckpt
from lidar_rt_tpu_torch.train import density as t_density
from lidar_rt_tpu_torch.train import loop as t_loop
from lidar_rt_tpu_torch.train import options
from _torch_parity import binner_range_cutoff
from test_torch_jax_ckpt import _exporter
from test_torch_train import (SMALL_OPT, _port_inputs, _t,  # noqa: F401
                              _trainers, synthetic_scene)

torch.set_num_threads(1)

LATE_OPT = dict(SMALL_OPT, densify_from_iter=3, densification_interval=5,
                densify_until_iter=26, opacity_reset_interval=10,
                sh_increase_interval=15, rebin_interval=4, iterations=28,
                densify_grad_threshold=1e-3)
WARMUP_K, WARMUP_UNTIL, TAIL_PASSES = 256, 8, 1
STEPS = LATE_OPT["iterations"]
DENSIFY_AT = [5, 10, 15, 20, 25]
RESETS_AT = [10, 20]
# The reference's state is carried to the port after each of these.
SEGMENT_ENDS = DENSIFY_AT + [STEPS]
# Where the free runs' counts part: equal before this event.
PART_AT = 10
# The loss from one state and in the restarted segments: the plain-math
# bar (measured: 3.0e-6 at most).
LOSS_RTOL = 1e-5
# The free runs after the first event (measured: 6.9e-3 at most).
LOSS_FREE_RTOL = 1e-2
# A free-run count (and the alive sets' difference) against the asset's
# alive surfels after the parting (measured: 13 of 5,261, 0.25%; the
# alive sets 18 of 5,515 apart).
COUNT_FRAC = 1e-2
# The actors' parameters after the free runs (measured: 3.3e-4 at most,
# in log-scale), and every parameter 3 steps after a restart.
PARAM_ATOL = 1e-3
RESTART_ATOL = 1e-4


def _draws(key, boxed: bool, cap: int):
    """The normals the reference's `densify_and_prune` draws from `key`
    (`lidar_rt_tpu/train/density.py:147-155,192-195`): the split offsets'
    (cap, 3), and the box prune's (cap, 2, 3) when it runs."""
    box = None
    if boxed:
        k_box, key = jax.random.split(key)
        box = _t(jax.random.normal(k_box, (cap, 2, 3)))
    k_split, _ = jax.random.split(key)
    return _t(jax.random.normal(k_split, (cap, 3))), box


def _record_resets(trainer, resets: list) -> None:
    reset = trainer._reset_opacity

    def wrapped():
        resets.append(trainer.iteration)
        reset()

    trainer._reset_opacity = wrapped


def _carry(j_state) -> t_loop.TrainState:
    """The reference's TrainState as the port's, through the leaves and
    static fields `export_jax_ckpt.py` writes and `import_jax_ckpt`
    reads."""
    ex = _exporter()
    leaves = {k: np.asarray(v) for k, v in ex.dotted_leaves(j_state).items()}
    return import_jax_ckpt.train_state_of(leaves,
                                          {"static": ex._static(j_state)})


def _counts(log: list[dict]) -> list[dict]:
    return [{k: v if k == "asset" else int(v) for k, v in e.items()}
            for e in log]


@pytest.fixture(scope="module")
def late_run(synthetic_scene):
    """The reference STEPS steps, its state kept after each of
    SEGMENT_ENDS; the port STEPS steps free from the same state, and
    restarted from each kept state to the next."""
    frames, scene = synthetic_scene
    make_j, make_t, _ = _trainers(frames, scene, LATE_OPT, TAIL_PASSES,
                                  WARMUP_K, WARMUP_UNTIL)
    draws, pending = [], []
    real_j, real_t = j_density.densify_and_prune, t_density.densify_and_prune

    def j_densify(asset, opt_state, stats, key, **kw):
        boxed = (kw["prune_size_threshold"] is not None
                 and kw["track"] is not None)
        draws.append(_draws(key, boxed, asset.capacity))
        return real_j(asset, opt_state, stats, key, **kw)

    def t_densify(asset, moments, stats, **kw):
        split, box = pending.pop(0)
        return real_t(asset, moments, stats, split_normals=split,
                      box_normals=box, **kw)

    out = {"resets": {"reference": [], "port": []}, "kept": {},
           "restarts": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_tracer, "_tile_range_cutoff", binner_range_cutoff)
        mp.setattr(j_density, "densify_and_prune", j_densify)
        mp.setattr(t_density, "densify_and_prune", t_densify)
        jt = make_j()
        jt.CHUNK = 10 ** 9          # single steps: two compiled shapes
        _record_resets(jt, out["resets"]["reference"])
        drawn, next_frame = [], jt._next_frame
        jt._next_frame = lambda: drawn.append(next_frame()) or drawn[-1]
        for end in SEGMENT_ENDS:
            jt.run(iterations=end - jt.iteration, log_every=5)
            out["kept"][end] = (dataclasses.replace(jt.state), len(draws),
                                len(jt.densify_log))
        pending.extend(draws)
        tt = make_t()
        _record_resets(tt, out["resets"]["port"])
        tt.run(iterations=STEPS, log_every=5)
        assert pending == []
        for start, end in zip([0] + SEGMENT_ENDS[:-1], SEGMENT_ENDS):
            rt = make_t()
            n_draws = 0
            if start:
                j_state, n_draws, _ = out["kept"][start]
                rt.restore(_carry(j_state), start)
            rt._next_frame = iter(drawn[start:end]).__next__
            pending[:] = draws[n_draws:]
            rt.run(iterations=end - start, log_every=5)
            out["restarts"].append((start, end, rt))
    out.update(reference=jt, port=tt, frames=drawn)
    return out


def test_schedule_is_crossed(late_run):
    """The run crosses what it is for: both resets, three densify events
    with the size and box prunes on, the budget switch to one tail pass,
    an SH raise and the rebin interval."""
    jt, tt = late_run["reference"], late_run["port"]
    resets = late_run["resets"]
    assert resets["port"] == resets["reference"] == RESETS_AT
    assert [e["iteration"] for e in tt.densify_log] == \
        [e["iteration"] for e in jt.densify_log] == \
        [it for it in DENSIFY_AT for _ in range(2)]
    assert sum(it > LATE_OPT["opacity_reset_interval"]
               for it in DENSIFY_AT) >= 3
    assert (tt.step_cfg.tile.max_per_tile, tt.step_cfg.tail_passes,
            tt.warmup_until) == (128, TAIL_PASSES, 0)
    assert jt.step_fn is jt._main_step
    assert tt.state.scene.background.active_sh_degree == \
        int(np.max(jt.state.scene.background.active_sh_degree)) == 1
    # Both train frames rebinned after each of 5 events, every 4 steps
    # between them, and at the switch.
    assert tt.state.bins.rebins >= 2 * (len(DENSIFY_AT) + 2)


def test_densify_counts_at_every_event(late_run):
    """Equal before PART_AT; after it, each count within COUNT_FRAC of the
    asset's alive surfels."""
    got = late_run["port"].densify_log
    want = _counts(late_run["reference"].densify_log)
    assert [e["asset"] for e in got] == ["background", "actors"] * \
        len(DENSIFY_AT)
    for g, w in zip(got, want):
        if g["iteration"] < PART_AT:
            assert g == w
        else:
            for k in ("cloned", "split", "pruned", "dropped", "alive"):
                assert abs(g[k] - w[k]) <= COUNT_FRAC * w["alive"], (g, w)
    late = [e for e in got if e["iteration"] > RESETS_AT[0]]
    assert sum(e["pruned"] for e in late if e["asset"] == "actors") > 0
    assert all(e["split"] > 0 for e in got if e["asset"] == "background")


def test_loss_at_every_step(late_run):
    jt, tt = late_run["reference"], late_run["port"]
    ref = np.array([float(h["loss"]) for h in jt.history])
    port = np.array([float(h["loss"]) for h in tt.history])
    assert len(ref) == len(port) == STEPS
    assert [h["frame"] for h in tt.history] == late_run["frames"]
    first = DENSIFY_AT[0]
    np.testing.assert_allclose(port[:first], ref[:first], rtol=LOSS_RTOL)
    np.testing.assert_allclose(port, ref, rtol=LOSS_FREE_RTOL)


@pytest.mark.parametrize("part", ["background", "actors"])
def test_final_state(late_run, part):
    j_asset = getattr(late_run["reference"].state.scene, part)
    t_asset = getattr(late_run["port"].state.scene, part)
    alive = np.asarray(j_asset.alive)
    differ = int(np.sum(t_asset.alive.numpy() != alive))
    if part == "background":
        assert differ <= COUNT_FRAC * alive.sum()
        return
    assert differ == 0
    for f, v in t_asset.params().items():
        np.testing.assert_allclose(v.detach().numpy()[alive],
                                   np.asarray(j_asset.params()[f])[alive],
                                   atol=PARAM_ATOL, err_msg=f)


@pytest.mark.parametrize("segment", range(len(SEGMENT_ENDS)))
def test_restart_from_reference_state(late_run, segment):
    """The port from the reference's state at each event: the reference's
    loss at every step and its counts at the next event."""
    jt = late_run["reference"]
    start, end, rt = late_run["restarts"][segment]
    ref = [float(h["loss"]) for h in jt.history[start:end]]
    np.testing.assert_allclose([float(h["loss"]) for h in rt.history], ref,
                               rtol=LOSS_RTOL)
    kept = late_run["kept"]
    lo = kept[start][2] if start else 0
    assert rt.densify_log == _counts(jt.densify_log[lo:kept[end][2]])
    if end == STEPS:
        j_state = kept[end][0]
        for part in ("background", "actors"):
            j_asset = getattr(j_state.scene, part)
            t_asset = getattr(rt.state.scene, part)
            alive = np.asarray(j_asset.alive)
            np.testing.assert_array_equal(t_asset.alive.numpy(), alive)
            for f, v in t_asset.params().items():
                np.testing.assert_allclose(
                    v.detach().numpy()[alive],
                    np.asarray(j_asset.params()[f])[alive],
                    atol=RESTART_ATOL, err_msg=f"{part}.{f}")


# -- 2. the schedule at full length, the step stubbed -------------------

FULL = "configs/rehearsal/full.yaml"
FORKS = (FULL, "configs/rehearsal/full_nodensify8k.yaml",
         "configs/rehearsal/full_noreset8k.yaml")
FORK_AT = 8000


class _Events:
    """One trainer's schedule events, in order."""

    def __init__(self, trainer=None):
        self.trainer, self.list = trainer, []

    def step(self, it: int, frame: int, k: int, tail: int, sh: int,
             ages: list[int], rebin_every: int) -> None:
        """A stubbed step on `frame`: its budget and SH degree, and the
        rebin the step would make, with the step's aging of `ages`
        (`train_step`'s cache: stale at rebin_every)."""
        stale = ages[frame] >= rebin_every
        ages[:] = [a + 1 for a in ages]
        if stale:
            ages[frame] = 1
        self.list.append(("step", it, int(frame), k, tail, int(sh),
                          bool(stale)))

    def add(self, *event) -> None:
        self.list.append(event)


def _stub_reference(mp, events: dict) -> None:
    """The reference's step scanned by a stub, its density control
    recording."""
    def make_step_n(frames, step_fn):
        def step_n(state, ids):
            ev = events["reference"]
            jt = ev.trainer
            cfg = jt.trace_cfg if step_fn is jt._main_step \
                else jt._warmup_cfg
            ages = [int(a) for a in np.asarray(state.bins.age)]
            for f in np.asarray(ids).tolist():
                ev.it += 1
                ev.step(ev.it, f, cfg.tile.max_per_tile, cfg.tail_passes,
                        np.max(state.scene.background.active_sh_degree),
                        ages, jt.rebin_every)
            state = dataclasses.replace(state, bins=state.bins._replace(
                age=jnp.asarray(ages, jnp.int32)))
            zero = jnp.zeros(len(ids))
            return state, {"loss": zero}
        return step_n

    def densify(asset, opt_state, stats, key, **kw):
        events["reference"].add(
            "densify", events["reference"].trainer.iteration,
            kw["track"] is not None, kw["prune_size_threshold"] is not None)
        counts = j_density.DensifyCounts(0, 0, 0, 0, 0)
        return asset, opt_state, stats, counts

    def reset(asset, opt_state):
        events["reference"].add("reset",
                                events["reference"].trainer.iteration)
        return asset, opt_state

    mp.setattr(j_loop, "make_train_step_n", make_step_n)
    mp.setattr(j_density, "densify_and_prune", densify)
    mp.setattr(j_density, "reset_opacity", reset)


def _stub_port(mp, events: dict) -> None:
    def make_step(frames, args, cfg, rebin_every):
        def step(state, batch):
            ev = events["port"]
            ev.step(ev.trainer.iteration, batch.frame,
                    cfg.tile.max_per_tile, cfg.tail_passes,
                    state.scene.background.active_sh_degree,
                    state.bins.age, rebin_every)
            return state, {"loss": torch.zeros(())}
        return step

    def densify(asset, moments, stats, *, track=None,
                prune_size_threshold=None, **kw):
        events["port"].add("densify", events["port"].trainer.iteration,
                           track is not None,
                           prune_size_threshold is not None)
        return stats, t_density.DensifyCounts(0, 0, 0, 0, 0)

    def reset(asset, moments):
        events["port"].add("reset", events["port"].trainer.iteration)

    mp.setattr(t_loop, "make_train_step", make_step)
    mp.setattr(t_density, "densify_and_prune", densify)
    mp.setattr(t_density, "reset_opacity", reset)


def _drive(trainer, ev: _Events, total: int, testing: int) -> None:
    """The CLIs' loop: `run` to each held-out eval (log stamps every
    100 steps), then the eval."""
    logged = len(trainer.history)
    while trainer.iteration < total:
        trainer.run(iterations=min(testing, total - trainer.iteration),
                    log_every=100)
        for h in trainer.history[logged:]:
            if "alive" in h:
                ev.add("log", int(h["iteration"]))
        logged = len(trainer.history)
        ev.add("eval", trainer.iteration)


def _schedule(scene, frames, exp: str, start: int) -> dict:
    """Each package's event list for `exp` from iteration `start` (0, or a
    resume) to its `opt.iterations`."""
    j_args = j_config.parse(exp)
    t_args = t_config.parse(exp)
    t_scene, t_frames = _port_inputs(scene, frames)
    events = {"reference": _Events(), "port": _Events()}

    def reference():
        cfg, warm, until = j_cli._trace_cfg(j_args)
        return j_loop.Trainer(scene, frames, j_args, cfg, warmup_cfg=warm,
                              warmup_until=until)

    def port():
        cfg, warm, until = options.trace_configs(t_args, "cpu")
        return t_loop.Trainer(t_scene, t_frames, t_args, cfg,
                              warmup_cfg=warm, warmup_until=until)

    with pytest.MonkeyPatch.context() as mp:
        _stub_reference(mp, events)
        _stub_port(mp, events)
        # One after the other: each Trainer seeds the shared `random`.
        for key, make in (("reference", reference), ("port", port)):
            trainer = make()
            if start:
                # A checkpoint at `start` holds the SH degree raised to
                # then; the reference's CLI sets its state and iteration.
                state = trainer.state
                for _ in range(start // int(j_args.opt.sh_increase_interval)):
                    state.scene = state.scene.one_up_sh_degree()
                if key == "port":
                    trainer.restore(state, start)
                else:
                    trainer.state = jax.tree.map(lambda x: x, state)
                    trainer.iteration = start
            ev = events[key]
            ev.trainer, ev.it = trainer, start
            _drive(trainer, ev, int(j_args.opt.iterations),
                   int(j_args.testing_iterations))
    return {k: v.list for k, v in events.items()}


@pytest.fixture(scope="module")
def full_schedules(synthetic_scene):
    frames, scene = synthetic_scene
    return {(exp, start): _schedule(scene, frames, exp, start)
            for exp, start in [(FULL, 0)] + [(f, FORK_AT) for f in FORKS]}


def _of(events, kind):
    return [e[1:] for e in events if e[0] == kind]


@pytest.mark.parametrize("exp,start", [(FULL, 0)]
                         + [(f, FORK_AT) for f in FORKS])
def test_schedule_events_match(full_schedules, exp, start):
    ev = full_schedules[(exp, start)]
    assert ev["port"] == ev["reference"]
    port = ev["port"]
    steps = _of(port, "step")
    assert [s[0] for s in steps] == list(range(start + 1, 30_001))
    assert _of(port, "eval") == [(i,) for i in range(start + 1000, 30_001,
                                                     1000)]
    assert _of(port, "log") == [(i,) for i in range(start + 100, 30_001,
                                                    100)]
    # The budget: K=512, then K=256 with one tail pass from the first
    # step after warmup_until (2,000) that the reference does not scan in
    # a chunk of 20: 2,081 (its chunks run 2,001-2,080 up to the events at
    # 2,100), 8,081 after a resume at 8,000; a rebin of every frame there.
    switch = start + 81 if start else 2081
    assert {(s[2], s[3]) for s in steps if s[0] >= switch} == {(256, 1)}
    assert {(s[2], s[3]) for s in steps if s[0] < switch} == {(512, 1)}
    assert steps[switch - start - 1][5]
    if start == 0:
        assert [s[0] for s in steps if s[4] > (steps[s[0] - 2][4]
                                                if s[0] > 1 else 0)] == \
            [1000, 2000, 3000]
    else:
        assert {s[4] for s in steps} == {3}
    dens = _of(port, "densify")
    resets = _of(port, "reset")
    until = {FULL: 15_000, FORKS[1]: FORK_AT, FORKS[2]: 15_000}[exp]
    interval = {FULL: 3000, FORKS[1]: 3000, FORKS[2]: FORK_AT}[exp]
    want_dens = [i for i in range(max(600, start + 100), until, 100)]
    assert [d[0] for d in dens] == [i for i in want_dens for _ in range(2)]
    assert dens == [(i, actor, i > interval) for i in want_dens
                    for actor in (False, True)]
    # One reset of the background and one of the actors at each.
    assert resets == [(i,) for i in range(interval, until, interval)
                      if i > start for _ in range(2)]
    # A rebin at each frame's first step after an event, and every
    # rebin_interval steps of a frame's cache otherwise.
    assert any(s[5] for s in steps[:3])
