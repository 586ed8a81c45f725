"""One training step of the port in the tracer's other modes, one tail pass
and exact (per-ray depth) order, held to the reference's step on the same
jittered synthetic scene (`test_torch_train.synthetic_scene`).

As in `test_torch_train.one_step`, the port renders with the reference's
freshly binned assignments (here the whole tail chain), so the step is
compared apart from the binner's order of near-tied candidates.  Bars are
`test_torch_train`'s: plain math 1e-6 + 1e-5 relative, gradients 3e-3
absolute after scaling by the reference's largest magnitude.  Each mode
jit-compiles one reference step, so the fixture is module-scoped.
"""

import numpy as np
import pytest
import torch

from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu.ops.binning import TileConfig as JTileConfig
from lidar_rt_tpu.train import loop as j_loop
from lidar_rt_tpu_torch.ops import tracer as t_tracer
from lidar_rt_tpu_torch.ops.binning import TileAssignment
from lidar_rt_tpu_torch.ops.binning import TileConfig as TTileConfig
from lidar_rt_tpu_torch.scene import compose
from lidar_rt_tpu_torch.train import loop as t_loop
from lidar_rt_tpu_torch.train import options
from test_torch_train import (GROUPS, SMALL_OPT, TILE, _close,  # noqa: F401
                              _grad_close, _j_args, _moments_of,
                              _port_inputs, _t, synthetic_scene)

torch.set_num_threads(1)

MODES = {"tail": {"tail_passes": 1}, "exact": {"exact_order": True}}
FRAME = 1                                   # the actor is in view


@pytest.fixture(scope="module", params=sorted(MODES))
def mode_step(request, synthetic_scene):
    """(mode, reference state and metrics, port state and metrics, the
    port's trainer, and the port's own step from a stale cache)."""
    frames, scene = synthetic_scene
    kw = MODES[request.param]
    j_cfg = j_tracer.TraceConfig(tile=JTileConfig(**TILE), tile_batch=2,
                                 **kw)
    t_cfg = t_tracer.TraceConfig(tile=TTileConfig(**TILE), **kw)
    jt = j_loop.Trainer(scene, frames, _j_args(), j_cfg)
    j_state, j_metrics = jt.step_fn(jt.state,
                                    j_loop.frame_batch(frames, FRAME))
    t_scene, t_frames = _port_inputs(scene, frames)
    args = options.experiment_options(**SMALL_OPT)
    tt = t_loop.Trainer(t_scene, t_frames, args, t_cfg)
    bins = tt.state.bins
    bins.index[FRAME] = _t(j_state.bins.index[FRAME])       # (P, T, K)
    bins.valid[FRAME] = _t(j_state.bins.valid[FRAME])
    bins.age[FRAME] = 0                                     # fresh: no rebin
    batch = t_loop.frame_batch(t_frames, FRAME)
    t_state, t_metrics = tt.step_fn(tt.state, batch)
    own = t_loop.Trainer(t_scene, t_frames, args, t_cfg)
    own_state, _ = own.step_fn(own.state, batch)
    return (request.param, j_state, j_metrics, t_state, t_metrics, tt,
            own_state)


class TestTrainStepModes:
    def test_loss_breakdown(self, mode_step):
        _, _, j_metrics, _, t_metrics, _, _ = mode_step
        assert set(t_metrics) == set(j_metrics)
        for k in j_metrics:
            _close(t_metrics[k], j_metrics[k], msg=k)

    @pytest.mark.parametrize("part", ["background", "actors"])
    def test_gradients_via_first_moments(self, mode_step, part):
        """After one step Adam's first moment is 0.1 * grad in both: the
        gradient of a tail step runs through both passes and the carried
        raw transmittance."""
        _, j_state, _, t_state, _, _, _ = mode_step
        j_opt = j_state.opt_state_bg if part == "background" \
            else j_state.opt_state_actors
        t_opt = t_state.opt_bg if part == "background" \
            else t_state.opt_actors
        for g in GROUPS:
            _grad_close(t_opt.moments(g)[0], _moments_of(j_opt, g)[0], g)
        assert np.abs(t_opt.moments("xyz")[0].numpy()).max() > 0.0

    def test_bin_cache_holds_the_chain(self, mode_step):
        """The cache has one pass per tail pass plus one; a stale frame
        bins the whole chain once, and a tail chain's second pass lists
        candidates (the K = 128 budget truncates every tile here)."""
        mode, j_state, _, t_state, _, _, own_state = mode_step
        passes = 2 if mode == "tail" else 1
        assert t_state.bins.index.shape[1] == passes
        assert tuple(t_state.bins.index.shape) == tuple(
            np.asarray(j_state.bins.index).shape)
        assert own_state.bins.rebins == 1 and t_state.bins.rebins == 0
        np.testing.assert_array_equal(
            own_state.bins.valid[FRAME, 0].numpy(),
            np.asarray(j_state.bins.valid[FRAME, 0]))
        assert bool(own_state.bins.valid[FRAME, passes - 1].any())

    def test_mode_reaches_the_render(self, mode_step):
        """The trainer's render differs from a tile-order one-pass render
        of the same scene and assignment: the mode reached the tracer."""
        mode, _, _, _, _, tt, _ = mode_step
        cfg = tt.trace_cfg
        scene = tt.state.scene
        with torch.no_grad():
            bundle, _ = compose(scene, FRAME)
            chain = [TileAssignment(
                tt.state.bins.index[FRAME, p], tt.state.bins.valid[FRAME, p],
                torch.zeros(tt.state.bins.index.shape[2], dtype=torch.int64))
                for p in range(cfg.tail_passes + 1)]
            args = (bundle, tt.frames.grid, tt.frames.width,
                    tt.frames.pose(FRAME), scene.background.active_sh_degree)
            got = t_tracer.render_frame(
                *args, cfg, assignment=chain if cfg.tail_passes else chain[0])
            plain = t_tracer.render_frame(*args, t_tracer.TraceConfig(
                tile=cfg.tile), assignment=chain[0])
        assert float((got["depth"] - plain["depth"]).abs().max()) > 1e-2
