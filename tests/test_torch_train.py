"""The port's training slice held to `lidar_rt_tpu` on the same numpy inputs:
losses, SSIM, Chamfer, the learning-rate schedule, per-group Adam, density
control, one training step and a short trainer run.

Bars: plain math at 1e-6 absolute + 1e-5 relative; gradients at the Pallas
gradient bar, 3e-3 absolute after scaling by the reference's largest
magnitude (tests/test_pallas_tracer.py); density control exactly, except
split children's positions, which go through a rotation (1e-6).  The
reference renders with its jax engine (exact top-k); the port with its
kernel path, whose plain twins run on the CPU.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lidar_rt_tpu.config import Args, default_experiment, parse
from lidar_rt_tpu.data import build, synthetic
from lidar_rt_tpu.ops import chamfer as j_chamfer
from lidar_rt_tpu.ops import ssim as j_ssim
from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu.ops.binning import TileConfig as JTileConfig
from lidar_rt_tpu.scene import asset as j_asset
from lidar_rt_tpu.scene import tracks as j_tracks
from lidar_rt_tpu.train import density as j_density
from lidar_rt_tpu.train import loop as j_loop
from lidar_rt_tpu.train import losses as j_losses
from lidar_rt_tpu.train import optim as j_optim
from lidar_rt_tpu_torch.ops import chamfer as t_chamfer
from lidar_rt_tpu_torch.ops import kernels
from lidar_rt_tpu_torch.ops import ssim as t_ssim
from lidar_rt_tpu_torch.ops import tracer as t_tracer
from lidar_rt_tpu_torch.ops.binning import TileConfig as TTileConfig
from lidar_rt_tpu_torch.scene import asset as t_asset
from lidar_rt_tpu_torch.scene.tracks import ActorTrack
from lidar_rt_tpu_torch.train import density as t_density
from lidar_rt_tpu_torch.train import loop as t_loop
from lidar_rt_tpu_torch.train import losses as t_losses
from lidar_rt_tpu_torch.train import optim as t_optim
from lidar_rt_tpu_torch.train import options
from _torch_parity import jittered, port_frames, port_scene

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
GROUPS = t_optim.GROUPS


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def _grad_close(got, want, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=3e-3,
                               err_msg=msg)


def _t(x):
    return torch.tensor(np.asarray(x))


# -- options -----------------------------------------------------------


def test_options_hold_the_experiment_config():
    """The port's namespace holds configs/base.yaml + configs/exp.yaml;
    default_experiment() differs from the files only in rebin_interval
    (0, the reference's bin-every-step default) and in cd_max_points,
    which it leaves to the trainer's default of the same value."""
    ns = options.experiment_options()
    files = parse("configs/exp.yaml")
    assert vars(ns.opt) == files.opt.to_dict()
    assert ns.seed == files.seed == default_experiment().seed
    defaults = default_experiment().opt.to_dict()
    differ = {k for k in vars(ns.opt) if defaults.get(k) != vars(ns.opt)[k]}
    assert differ == {"rebin_interval", "cd_max_points"}
    assert (defaults["rebin_interval"], ns.opt.rebin_interval) == (0, 10)
    assert options.experiment_options(iterations=7).opt.iterations == 7
    with pytest.raises(KeyError, match="bogus"):
        options.experiment_options(bogus=1)


def test_trace_configs_by_device():
    """`trace_configs` reads fast_math and cache_fwd (missing: the
    reference's default, True) and turns them on for a CUDA device only,
    as the reference's engine applies them only where it runs its
    kernels; the TPU-only keys stay unread."""
    from types import SimpleNamespace

    def resolve(block, device):
        ns = options.experiment_options()
        ns.tracer = SimpleNamespace(**block)
        return options.trace_configs(ns, device)[0]

    cpu = resolve({"fast_math": True}, "cpu")
    assert (cpu.fast_math, cpu.cache_fwd, cpu.use_cache) == (False, False,
                                                             False)
    card = resolve({"fast_math": True}, torch.device("cuda", 0))
    assert (card.fast_math, card.cache_fwd, card.use_cache) == (True, True,
                                                                True)
    assert resolve({}, "cuda").use_cache
    off = resolve({"fast_math": True, "cache_fwd": False}, "cuda")
    assert off.fast_math and not off.use_cache
    assert not resolve({"fast_math": False}, "cuda").fast_math
    exact = resolve({"exact_order": True}, "cuda")
    assert exact.fast_math and not exact.use_cache
    assert options.TPU_ONLY == ("approx_topk", "macro_cols", "ray_block")


# -- losses, SSIM, Chamfer -----------------------------------------------


def _images(seed, h=24, w=40):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(-0.2, 1.2, (h, w)).astype(np.float32)
    gt = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    mask = rng.uniform(size=(h, w)) > 0.3
    return pred, gt, mask


LOSS_CASES = {
    "masked_mean": lambda lib, p, g, m: lib.masked_mean(p, m),
    "l1": lambda lib, p, g, m: lib.l1(p, g, m),
    "l1_unmasked": lambda lib, p, g, m: lib.l1(p, g),
    "l2": lambda lib, p, g, m: lib.l2(p, g, m),
    "psnr": lambda lib, p, g, m: lib.psnr(p, g, m),
    "bce_probs": lambda lib, p, g, m: lib.bce_probs(
        (p - p.min()) / (p.max() - p.min()), m),
    "dssim": lambda lib, p, g, m: lib.dssim(p, g),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_primitives(name):
    pred, gt, mask = _images(1)
    fn = LOSS_CASES[name]
    want = fn(j_losses, jnp.asarray(pred), jnp.asarray(gt),
              jnp.asarray(mask))
    got = fn(t_losses, _t(pred), _t(gt), _t(mask))
    _close(got, want, msg=name)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.0, 4.0)])
def test_ssim_value_and_gradient(lo, hi):
    """Out-of-range images exercise the variance clamps and the
    Cauchy-Schwarz covariance bound."""
    rng = np.random.default_rng(2)
    a = rng.uniform(lo, hi, (2, 20, 33)).astype(np.float32)
    b = rng.uniform(lo, hi, (2, 20, 33)).astype(np.float32)
    want, want_g = jax.value_and_grad(j_ssim.ssim)(jnp.asarray(a),
                                                   jnp.asarray(b))
    ta = _t(a).requires_grad_()
    got = t_ssim.ssim(ta, _t(b))
    got.backward()
    _close(got.detach(), want)
    _grad_close(ta.grad, want_g)


def _clouds(seed, n=700, m=500):
    rng = np.random.default_rng(seed)
    a = rng.normal(scale=3.0, size=(n, 3)).astype(np.float32)
    b = rng.normal(scale=3.0, size=(m, 3)).astype(np.float32)
    return a, rng.uniform(size=n) > 0.2, b, rng.uniform(size=m) > 0.2


def test_chamfer_distance_fscore_and_gradient():
    a, am, b, bm = _clouds(3)
    ja, jam, jb, jbm = map(jnp.asarray, (a, am, b, bm))
    ta, tam, tb, tbm = map(_t, (a, am, b, bm))
    d_ab = t_chamfer.min_sq_dists(ta, tam, tb, tbm)
    j_ab = j_chamfer.min_sq_dists(ja, jam, jb, jbm)
    _close(d_ab, j_ab, atol=1e-5)
    d_ba = t_chamfer.min_sq_dists(tb, tbm, ta, tam)
    j_ba = j_chamfer.min_sq_dists(jb, jbm, ja, jam)
    _close(t_chamfer.fscore(d_ab, tam, d_ba, tbm, 0.5),
           j_chamfer.fscore(j_ab, jam, j_ba, jbm, 0.5))
    want, (ga, gb) = jax.value_and_grad(
        lambda x, y: j_losses.chamfer_loss(x, jam, y, jbm),
        argnums=(0, 1))(ja, jb)
    ta.requires_grad_()
    tb.requires_grad_()
    got = t_losses.chamfer_loss(ta, tam, tb, tbm)
    got.backward()
    _close(got.detach(), want)
    _grad_close(ta.grad, ga)
    _grad_close(tb.grad, gb)


def test_chamfer_with_no_valid_point():
    """A cloud with no valid point matches nothing either way: zero
    distances and zero gradients, as in the reference, with no pairs
    gathered for the rows that found no match."""
    a, am, b, _ = _clouds(5)
    bm = np.zeros(b.shape[0], bool)
    ja, jam, jb, jbm = map(jnp.asarray, (a, am, b, bm))
    ta, tam, tb, tbm = (_t(a).requires_grad_(), _t(am),
                        _t(b).requires_grad_(), _t(bm))
    d_ab = t_chamfer.min_sq_dists(ta, tam, tb, tbm)
    _close(d_ab.detach(), j_chamfer.min_sq_dists(ja, jam, jb, jbm))
    assert not bool(d_ab.detach().any())
    want, (ga, gb) = jax.value_and_grad(
        lambda x, y: j_losses.chamfer_loss(x, jam, y, jbm),
        argnums=(0, 1))(ja, jb)
    got = t_losses.chamfer_loss(ta, tam, tb, tbm)
    got.backward()
    _close(got.detach(), want)
    _close(ta.grad, ga)
    _close(tb.grad, gb)
    assert not bool(ta.grad.any()) and not bool(tb.grad.any())


def _asset_pair(seed, cap=64, extent=10.0):
    """Random raw asset leaves as (reference asset, port asset)."""
    rng = np.random.default_rng(seed)
    leaves = {
        "xyz": rng.normal(scale=0.6, size=(cap, 3)),
        "f_dc": rng.normal(size=(cap, 1, 3)),
        "f_rest": rng.normal(scale=0.1, size=(cap, 15, 3)),
        "log_scale": rng.uniform(-9.0, -1.5, (cap, 2)),
        "quat": rng.normal(size=(cap, 4)),
        "opacity_logit": rng.uniform(-7.0, 3.0, cap),
    }
    leaves["log_scale"][:cap // 3] -= 5.0          # clone-sized splats
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    alive = rng.uniform(size=cap) > 0.25
    j = j_asset.GaussianAsset(
        **{k: jnp.asarray(v) for k, v in leaves.items()},
        alive=jnp.asarray(alive), active_sh_degree=jnp.asarray(3),
        extent=extent)
    t = t_asset.GaussianAsset(**{k: _t(v) for k, v in leaves.items()},
                              alive=_t(alive), active_sh_degree=3,
                              extent=extent)
    return j, t


def _track_pair():
    size = np.array([1.2, 0.8, 0.6], np.float32)
    j = j_tracks.ActorTrack(jnp.asarray(size), jnp.zeros((2, 3)),
                            jnp.tile(jnp.array([1.0, 0, 0, 0]), (2, 1)),
                            jnp.ones(2, bool))
    t = ActorTrack(_t(size), torch.zeros(2, 3),
                   torch.tensor([[1.0, 0, 0, 0]] * 2), torch.ones(2, dtype=bool))
    return j, t


@pytest.mark.parametrize("boxed", [False, True])
def test_box_reg_loss(boxed):
    ja, ta = _asset_pair(4, extent=3.0)
    jt, tt = _track_pair() if boxed else (None, None)
    _close(t_losses.box_reg_loss(ta, tt), j_losses.box_reg_loss(ja, jt))


def test_render_losses_breakdown():
    pred, gt, mask = _images(5)
    rng = np.random.default_rng(5)
    depth = rng.uniform(0, 30, pred.shape).astype(np.float32)
    gt_depth = rng.uniform(0, 30, pred.shape).astype(np.float32)
    drop = rng.uniform(0, 1, pred.shape).astype(np.float32)
    lw = dict(depth_l1=0.1, intensity_l1=0.85, intensity_l2=0.3,
              intensity_dssim=0.15, raydrop_bce=0.01, cd=0.01, reg=0.01)
    want = j_losses.render_losses(
        *map(jnp.asarray, (depth, pred, drop, gt_depth, gt, mask)),
        j_losses.LossWeights(**lw), cd_loss=jnp.float32(1.5),
        reg_loss=jnp.float32(0.25))
    got = t_losses.render_losses(
        *map(_t, (depth, pred, drop, gt_depth, gt, mask)),
        t_losses.LossWeights(**lw), cd_loss=torch.tensor(1.5),
        reg_loss=torch.tensor(0.25))
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        _close(a, b, msg=name)


# -- schedule and Adam ---------------------------------------------------


def test_expon_lr_schedule():
    kw = dict(lr_init=0.00016 * 37.0, lr_final=0.0000016 * 37.0,
              lr_delay_mult=0.01, max_steps=30_000)
    for delay in (0, 500):
        j = j_optim.expon_lr_schedule(lr_delay_steps=delay, **kw)
        t = t_optim.expon_lr_schedule(lr_delay_steps=delay, **kw)
        for step in (0, 1, 250, 499, 15_000, 30_000, 40_000):
            _close(t(step), j(step), msg=f"delay {delay} step {step}")


def _moments_of(opt_state, group):
    """(mu, nu) of one group of an optax multi_transform Adam state."""
    for n in jax.tree_util.tree_leaves(
            opt_state.inner_states[group],
            is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState)):
        if isinstance(n, optax.ScaleByAdamState):
            return np.asarray(n.mu[group]), np.asarray(n.nu[group])
    raise KeyError(group)


def _with_moments(opt_state, moments):
    """An optax multi_transform Adam state with the given (mu, nu) per
    group."""
    inner = dict(opt_state.inner_states)
    for group, (mu, nu) in moments.items():
        def visit(n, group=group, mu=mu, nu=nu):
            if isinstance(n, optax.ScaleByAdamState):
                return n._replace(mu={**n.mu, group: jnp.asarray(mu)},
                                  nu={**n.nu, group: jnp.asarray(nu)})
            return n

        inner[group] = jax.tree.map(
            visit, inner[group],
            is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState))
    return opt_state._replace(inner_states=inner)


def test_asset_optimizer_matches_optax():
    """Three steps of the port's per-group Adam against optax's
    multi_transform on the same params and gradients.  With eps = 1e-15 a
    step moves each parameter by about lr * m / sqrt(v): at step one
    exactly +-lr * sign(g), so a gradient near 0 flips a whole lr step on
    rounding noise.  Parameters are compared only where every step's
    |g| is above 1e-3 of its group's largest."""
    args = options.experiment_options().opt
    ja, ta = _asset_pair(6)
    extent = 37.0
    j_opt = j_optim.asset_optimizer(args, extent)
    j_params = ja.params()
    j_state = j_opt.init(j_params)
    t_params = {k: v.clone().requires_grad_() for k, v in ta.params().items()}
    t_opt = t_optim.AssetOptimizer(args, extent, t_params)
    rng = np.random.default_rng(6)
    keep = {k: np.ones(v.shape, bool) for k, v in t_params.items()}
    for _ in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in t_params.items()}
        for k, g in grads.items():
            keep[k] &= np.abs(g) > 1e-3 * np.abs(g).max()
        upd, j_state = j_opt.update({k: jnp.asarray(g)
                                     for k, g in grads.items()},
                                    j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        t_opt.zero_grad()
        for k, g in grads.items():
            t_params[k].grad = _t(g)
        t_opt.step()
    for k in GROUPS:
        got = t_params[k].detach().numpy()
        want = np.asarray(j_params[k])
        _close(got[keep[k]], want[keep[k]], msg=k)
        assert np.abs(got - want).max() <= 2e-2, k
        for mine, ref in zip(t_opt.moments(k), _moments_of(j_state, k)):
            _close(mine, ref, msg=k)
    assert t_opt.adam.param_groups[0]["name"] == "xyz"
    assert t_opt.adam.param_groups[0]["lr"] == pytest.approx(
        float(j_optim.expon_lr_schedule(
            args.position_lr_init * extent, args.position_lr_final * extent,
            max_steps=args.position_lr_max_steps)(2)))


# -- density control -----------------------------------------------------


def _density_case(seed, boxed, cap=64):
    """An asset, densify stats and random Adam moments for both packages:
    clones, splits, low-opacity, oversized and (boxed) outside-box prunes,
    fewer free slots than children when cap is small."""
    ja, ta = _asset_pair(seed, cap=cap, extent=10.0)
    rng = np.random.default_rng(seed + 100)
    grad = rng.uniform(0, 6e-4, cap).astype(np.float32)
    denom = rng.integers(0, 3, cap).astype(np.float32)
    moments = {g: tuple(rng.normal(size=np.asarray(v).shape)
                        .astype(np.float32) for _ in range(2))
               for g, v in ja.params().items()}
    j_state = _with_moments(
        j_optim.asset_optimizer(options.experiment_options().opt,
                                10.0).init(ja.params()), moments)
    t_moments = [_t(m) for g in GROUPS for m in moments[g]]
    tracks = _track_pair() if boxed else (None, None)
    return (ja, ta, j_density.DensifyStats(jnp.asarray(grad),
                                           jnp.asarray(denom)),
            t_density.DensifyStats(_t(grad), _t(denom)), j_state, t_moments,
            tracks)


@pytest.mark.parametrize("seed,boxed,cap", [(7, False, 64), (8, True, 64),
                                            (9, False, 12)])
def test_densify_and_prune_matches_reference(seed, boxed, cap):
    ja, ta, j_stats, t_stats, j_state, t_moments, (jt, tt) = _density_case(
        seed, boxed, cap)
    kw = dict(grad_threshold=2e-4, scale_threshold=2e-4 * 10.0,
              opacity_threshold=0.003,
              prune_size_threshold=0.1 if boxed else None)
    key = jax.random.key(seed)
    j_new, j_ost, j_zero, j_counts = j_density.densify_and_prune(
        ja, j_state, j_stats, key, track=jt, **kw)
    # The reference's draws, handed to the port.
    box_normals = None
    k = key
    if boxed:
        k_box, k = jax.random.split(k)
        box_normals = _t(jax.random.normal(k_box, (cap, 2, 3)))
    k_split, _ = jax.random.split(k)
    split_normals = _t(jax.random.normal(k_split, (cap, 3)))
    t_zero, t_counts = t_density.densify_and_prune(
        ta, t_moments, t_stats, track=tt, split_normals=split_normals,
        box_normals=box_normals, **kw)

    assert t_counts._asdict() == {k: int(v) for k, v in
                                  j_counts._asdict().items()}
    assert t_counts.cloned > 0 and t_counts.split > 0
    # The small asset has too few free slots; the others prune.
    assert (t_counts.dropped if cap == 12 else t_counts.pruned) > 0
    for f in ("alive", "f_dc", "f_rest", "log_scale", "quat",
              "opacity_logit"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(j_new, f)), f)
    _close(ta.xyz, j_new.xyz, rtol=1e-6, atol=1e-6)
    got_moments = iter(t_moments)
    for g in GROUPS:
        for mine, ref in zip((next(got_moments), next(got_moments)),
                             _moments_of(j_ost, g)):
            np.testing.assert_array_equal(mine.numpy(), ref, g)
    for a, b in zip(t_zero, j_zero):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_reset_opacity_matches_reference():
    ja, ta, _, _, j_state, t_moments, _ = _density_case(10, False)
    j_new, j_ost = j_density.reset_opacity(ja, j_state)
    opacity = GROUPS.index("opacity")
    t_density.reset_opacity(ta, t_moments[2 * opacity:2 * opacity + 2])
    np.testing.assert_array_equal(ta.opacity_logit.numpy(),
                                  np.asarray(j_new.opacity_logit))
    got_moments = iter(t_moments)
    for g in GROUPS:
        for mine, ref in zip((next(got_moments), next(got_moments)),
                             _moments_of(j_ost, g)):
            np.testing.assert_array_equal(mine.numpy(), ref, g)


# -- one step and a short run on the synthetic scene ---------------------

SMALL_OPT = dict(densify_from_iter=15, densification_interval=20,
                 densify_until_iter=70, opacity_reset_interval=10_000,
                 cd_max_points=1024, iterations=80, sh_increase_interval=30,
                 rebin_interval=10)
TILE = dict(tile_h=8, tile_w=16, max_per_tile=128)   # the actor is a candidate


def _j_args():
    d = default_experiment().to_dict()
    d["opt"].update(SMALL_OPT)
    d["model"].update(obj_pt_num=256, voxel_size=0.3)
    return Args(d)


def _port_inputs(j_scene, frames):
    return port_scene(j_scene), port_frames(frames)


@pytest.fixture(scope="module")
def synthetic_scene():
    """The synthetic scene, its surfels jittered by 5 cm: surfels assembled
    from range images tie in range to rounding (a ground ring at one
    elevation), and the two packages round the range differently, so
    they would list tied candidates in different orders."""
    frames, track = synthetic.generate(num_frames=3, height=16, width=128)
    scene = build.assemble_scene(frames, [track], _j_args(),
                                 capacity_headroom=1.5)
    return frames, jittered(scene)


def _trainers(frames, scene):
    j_cfg = j_tracer.TraceConfig(tile=JTileConfig(**TILE), tile_batch=2)
    t_cfg = t_tracer.TraceConfig(tile=TTileConfig(**TILE))
    t_scene, t_frames = _port_inputs(scene, frames)
    return (lambda: j_loop.Trainer(scene, frames, _j_args(), j_cfg),
            lambda: t_loop.Trainer(t_scene, t_frames,
                                   options.experiment_options(**SMALL_OPT),
                                   t_cfg),
            t_frames)


@pytest.fixture(scope="module")
def one_step(synthetic_scene):
    """One step of each package on frame 1 from the same scene.  The port
    renders with the reference's freshly binned assignment, so the step is
    compared apart from the binner's order of near-tied candidates
    (test_bin_cache holds the port's own binning to the same candidate
    sets)."""
    frames, scene = synthetic_scene
    make_j, make_t, t_frames = _trainers(frames, scene)
    f = 1                                   # the actor is in view
    jt = make_j()
    j_state, j_metrics = jt.step_fn(jt.state, j_loop.frame_batch(frames, f))
    tt = make_t()
    bins = tt.state.bins
    bins.index[f] = _t(j_state.bins.index[f])   # (P, T, K), P = 1
    bins.valid[f] = _t(j_state.bins.valid[f])
    bins.age[f] = 0                         # fresh: no rebin
    before = {k: v.detach().clone()
              for k, v in tt.state.scene.background.params().items()}
    t_state, t_metrics = tt.step_fn(tt.state,
                                    t_loop.frame_batch(t_frames, f))
    own = make_t()
    own_state, _ = own.step_fn(own.state, t_loop.frame_batch(t_frames, f))
    return j_state, j_metrics, t_state, t_metrics, before, own_state


class TestTrainStep:
    def test_loss_breakdown(self, one_step):
        _, j_metrics, _, t_metrics, _, _ = one_step
        assert set(t_metrics) == set(j_metrics)
        for k in j_metrics:
            _close(t_metrics[k], j_metrics[k], msg=k)

    @pytest.mark.parametrize("part", ["background", "actors"])
    def test_gradients_via_first_moments(self, one_step, part):
        """After one step Adam's first moment is 0.1 * grad in both."""
        j_state, _, t_state, _, _, _ = one_step
        j_opt = j_state.opt_state_bg if part == "background" \
            else j_state.opt_state_actors
        t_opt = t_state.opt_bg if part == "background" \
            else t_state.opt_actors
        for g in GROUPS:
            _grad_close(t_opt.moments(g)[0], _moments_of(j_opt, g)[0], g)
        assert np.abs(t_opt.moments("xyz")[0].numpy()).max() > 0.0

    def test_new_parameters(self, one_step):
        """Step one moves each parameter by +-lr * sign(g): compared where
        |g| is well above the gradient bar, and bounded by lr elsewhere."""
        j_state, _, t_state, _, before, _ = one_step
        new_j = j_state.scene.background.params()
        new_t = t_state.scene.background.params()
        for g in GROUPS:
            grad = t_state.opt_bg.moments(g)[0].numpy() / 0.1
            sure = np.abs(grad) > 1e-2 * (np.abs(grad).max() + 1e-30)
            got, want = new_t[g].detach().numpy(), np.asarray(new_j[g])
            _close(got[sure], want[sure], msg=g)
            lr = t_state.opt_bg.adam.param_groups[GROUPS.index(g)]["lr"]
            moved = np.abs(got - before[g].numpy())
            assert moved.max() <= lr * (1 + 1e-4), g

    def test_densify_stats(self, one_step):
        j_state, _, t_state, _, _, _ = one_step
        for t_st, j_st in ((t_state.stats_bg, j_state.stats_bg),
                           (t_state.stats_actors, j_state.stats_actors)):
            _grad_close(t_st.grad_accum, j_st.grad_accum)
            np.testing.assert_array_equal(t_st.denom.numpy(),
                                          np.asarray(j_st.denom))
        assert float(t_state.stats_bg.denom.sum()) > 0

    def test_bin_cache(self, one_step):
        """The port's own rebin of the stale frame: the reference's valid
        masks and, per tile, its candidate sets; every frame aged."""
        j_state, _, t_state, _, _, own_state = one_step
        for bins in (t_state.bins, own_state.bins):
            assert bins.age == [STALE + 1, 1, STALE + 1]
            assert not bool(bins.valid[0].any())
        j_index = np.asarray(j_state.bins.index[1, 0])
        j_valid = np.asarray(j_state.bins.valid[1, 0])
        index = own_state.bins.index[1, 0].numpy()
        valid = own_state.bins.valid[1, 0].numpy()
        np.testing.assert_array_equal(valid, j_valid)
        assert valid.any()
        for t in range(index.shape[0]):
            assert set(index[t][valid[t]]) == set(j_index[t][j_valid[t]])

    def test_every_step_renders_from_the_cache(self, synthetic_scene):
        """The step always renders from the bin cache: a trainer without a
        rebin interval of at least one step is refused."""
        frames, scene = synthetic_scene
        t_scene, t_frames = _port_inputs(scene, frames)
        for interval in (0, -1):
            args = options.experiment_options(
                **{**SMALL_OPT, "rebin_interval": interval})
            with pytest.raises(ValueError, match="rebin_every"):
                t_loop.Trainer(t_scene, t_frames, args)


RUN_STEPS = 30
STALE = t_loop.STALE_AGE


@pytest.fixture(scope="module")
def short_run(synthetic_scene):
    """Both trainers for RUN_STEPS steps from the same seed (the same frame
    order), crossing the densify event at step 20."""
    frames, scene = synthetic_scene
    make_j, make_t, _ = _trainers(frames, scene)
    jt = make_j()
    jt.CHUNK = 10 ** 9          # one compiled step shape
    jt.run(iterations=RUN_STEPS, log_every=10)
    kernels.forward_launches = kernels.backward_launches = 0
    tt = make_t()
    history = tt.run(iterations=RUN_STEPS, log_every=10)
    return jt, tt, history


class TestTrainerRun:
    def test_loss_falls_and_history(self, short_run):
        _, tt, history = short_run
        assert [h["iteration"] for h in history] == list(
            range(1, RUN_STEPS + 1))
        losses = [h["loss"] for h in history]
        assert np.isfinite(losses).all()
        assert np.mean(losses[-5:]) < np.mean(losses[:5])
        assert "alive" in history[-1] and "elapsed" in history[9]
        assert {h["frame"] for h in history} <= set(tt.frames.train_frames)
        # CPU tensors: the plain twins, no kernel launch.
        assert kernels.forward_launches == kernels.backward_launches == 0

    def test_densify_counts_match_reference(self, short_run):
        jt, tt, _ = short_run
        assert [e["iteration"] for e in tt.densify_log] == [20, 20]
        assert tt.densify_log == [{k: int(v) if k not in ("asset",) else v
                                   for k, v in e.items()}
                                  for e in jt.densify_log]

    def test_state_stays_finite_and_sh_warms_up(self, short_run):
        _, tt, _ = short_run
        for part in ("background", "actors"):
            asset = getattr(tt.state.scene, part)
            for v in asset.params().values():
                assert bool(torch.isfinite(v).all())
            assert asset.active_sh_degree == 1      # one warm-up at 30
        # Rebinned since the densify event at 20 invalidated every frame;
        # held-out frames are never rendered.
        ages = tt.state.bins.age
        assert tt.state.bins.rebins >= 2 * len(tt.frames.train_frames)
        for f in range(len(ages)):
            if f in tt.frames.train_frames:
                assert ages[f] <= 10
            else:
                assert ages[f] > STALE

    def test_render_eval(self, short_run):
        _, tt, _ = short_run
        out = tt.render_eval(0)
        assert out["depth"].shape == (16, 128)
        assert not out["depth"].requires_grad
