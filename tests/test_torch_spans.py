"""The port's profiler spans (`utils/profiling.py` `span`, `SPANS`) on the
CPU, on the small synthetic trainer of the CLI tests: one `Trainer.step`
under `torch.profiler` records each layer's span inside `lrt.step`'s
interval; every recorded `lrt.*` name is in `SPANS`; with no profiler a
span never reaches `record_function`; and a step is bit-identical with
and without a profiler."""

import torch
from torch.profiler import ProfilerActivity, profile

from lidar_rt_tpu_torch.data import synthetic
from lidar_rt_tpu_torch.data.build import assemble_scene
from lidar_rt_tpu_torch.ops import tracer
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.scene.asset import PARAM_FIELDS
from lidar_rt_tpu_torch.train import loop, options
from lidar_rt_tpu_torch.utils import profiling

torch.set_num_threads(1)

STEP_CHILDREN = ("lrt.compose", "lrt.render", "lrt.chamfer", "lrt.loss",
                 "lrt.backward", "lrt.adam", "lrt.density_stats", "lrt.bin")


def _trainer():
    """The CLI tests' small trainer (one vehicle, 2 frames of 16 x 64, the
    Chamfer term on); built just before it steps, as it seeds `random`."""
    frames, track = synthetic.generate(num_frames=2, height=16, width=64,
                                       device="cpu")
    args = options.experiment_options(
        seed=1, densify_from_iter=2, densification_interval=5,
        sh_increase_interval=3, rebin_interval=3)
    scene = assemble_scene(frames, [track], args, capacity_headroom=2.0)
    cfg = tracer.TraceConfig(tile=TileConfig(tile_h=8, tile_w=64,
                                             max_per_tile=64), tile_batch=2)
    return loop.Trainer(scene, frames, args, cfg)


def _spans(prof) -> list[tuple[str, int, int]]:
    """(name, start, end) in microseconds of every `lrt.*` annotation."""
    out = []
    for e in prof.events():
        if e.name.startswith("lrt."):
            start = e.time_range.start
            out.append((e.name, start, e.time_range.end))
    return out


def test_step_records_every_layer_inside_the_step():
    trainer = _trainer()
    assert all(age == loop.STALE_AGE for age in trainer.state.bins.age)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.step()
    spans = _spans(prof)
    steps = [(a, b) for n, a, b in spans if n == "lrt.step"]
    assert len(steps) == 1
    a, b = steps[0]
    inside = {n for n, s, e in spans if n != "lrt.step" and a <= s <= e <= b}
    assert set(STEP_CHILDREN) <= inside, set(STEP_CHILDREN) - inside
    assert trainer.state.bins.rebins == 1


def test_recorded_names_are_the_declared_spans():
    """Over a densify event and a log event every name recorded is one of
    `SPANS`, and the schedule's own spans appear."""
    trainer = _trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.run(5, log_every=5)
    names = {n for n, _, _ in _spans(prof)}
    assert names <= set(profiling.SPANS), names - set(profiling.SPANS)
    assert {"lrt.step", "lrt.densify", "lrt.flush"} <= names
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    assert all(n.startswith("lrt.") for n in profiling.SPANS)


def test_span_off_never_reaches_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first = profiling.span("step")
    assert profiling.span("render") is first
    with first:
        pass
    _trainer().step()


def _leaves(trainer) -> dict[str, torch.Tensor]:
    scene = trainer.state.scene
    out = {}
    for name, asset in (("bg", scene.background), ("ac", scene.actors)):
        for f in PARAM_FIELDS.values():
            out[f"{name}.{f}"] = getattr(asset, f).detach().clone()
    return out


def test_step_is_bit_identical_under_the_profiler():
    plain = _trainer()
    m_plain = plain.step()
    leaves_plain = _leaves(plain)
    traced = _trainer()
    with profile(activities=[ProfilerActivity.CPU]):
        m_traced = traced.step()
    leaves_traced = _leaves(traced)
    assert m_plain.keys() == m_traced.keys()
    for k in m_plain:
        assert torch.equal(m_plain[k], m_traced[k]), k
    for k in leaves_plain:
        assert torch.equal(leaves_plain[k], leaves_traced[k]), k
    assert float(m_plain["cd"]) > 0.0
