"""The tracer's training modes (`TraceConfig(fast_math=True,
cache_fwd=True)`) held to `lidar_rt_tpu` on the same numpy inputs.

On the CPU the kernel path runs the plain twins: the forward twin encodes
the cache as the kernel does (`cuda_tracer.encode_cache`), the backward
twin decodes it as the kernel does, and the fast sums are a card-only
precision (the twins stay float32).  Bars: the forward's channels to the
bit against the uncached forward; gradients at the reference's cache bars
(tests/test_pallas_tracer.py TestCacheFwd: 1.5e-2 absolute after scaling
by the reference's largest magnitude, cosine > 0.999) against the
reference's float32 jax engine and against the port's own replay; a
cache encoded in float32 decodes to the replay's gradients at 1e-5.  The
kernels themselves are held to these twins in tests/test_torch_kernels.py,
on a card.
"""

import jax
import numpy as np
import pytest
import torch

from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu.ops.binning import TileConfig as JTileConfig
from lidar_rt_tpu.train import loop as j_loop
from lidar_rt_tpu_torch.ops import cuda_tracer, kernels
from lidar_rt_tpu_torch.ops import tracer as t_tracer
from lidar_rt_tpu_torch.ops.binning import TileConfig as TTileConfig
from lidar_rt_tpu_torch.ops.composite import SurfelBundle as TBundle
from lidar_rt_tpu_torch.train import loop as t_loop
from lidar_rt_tpu_torch.train import options
from test_torch_tracer import (BG, GRAD_FIELDS, POSE, W, _grads_of, _grids,
                               _jb, _requiring_grad, _surfels, _tile_case,
                               _upstream)
from test_torch_train import (GROUPS, SMALL_OPT, TILE, _close,  # noqa: F401
                              _j_args, _moments_of, _port_inputs, _t,
                              synthetic_scene)

torch.set_num_threads(1)

CACHE_ATOL, CACHE_COS = 1.5e-2, 0.999
FAST = dict(fast_math=True, cache_fwd=True)


def _cache_close(got, want, name):
    """The reference's cache bars."""
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    scale = np.abs(want).max() + 1e-8
    np.testing.assert_allclose(got / scale, want / scale, atol=CACHE_ATOL,
                               err_msg=name)
    norms = np.linalg.norm(got) * np.linalg.norm(want)
    if norms == 0.0:                  # a field with no gradient in both
        assert not got.any() and not want.any(), name
        return
    assert got @ want / norms > CACHE_COS, (name, got @ want / norms)


class _CacheCalls:
    """Records the `cache` argument of every forward twin call."""

    def __init__(self, monkeypatch):
        self.calls = []
        twin = cuda_tracer.forward_tiles_reference

        def recording(*args, cache=False, **kw):
            self.calls.append(bool(cache))
            return twin(*args, cache=cache, **kw)

        monkeypatch.setattr(cuda_tracer, "forward_tiles_reference",
                            recording)


def test_trace_config_resolves_the_cache():
    """The cache is used only with fast_math, in tile order
    (lidar_rt_tpu/ops/tracer.py:252-256); a config that asks for it in
    exact order is taken, uncached; both modes default off."""
    assert not t_tracer.TraceConfig().use_cache
    assert not t_tracer.TraceConfig().fast_math
    assert t_tracer.TraceConfig(**FAST).use_cache
    assert not t_tracer.TraceConfig(cache_fwd=True).use_cache
    assert not t_tracer.TraceConfig(exact_order=True, **FAST).use_cache


def _stops(live, cnt):
    """Each ray's last index the long way: the first candidate below cnt
    at which the float32 replay's T_MIN test fails, else cnt - 1."""
    live, cnt = live.numpy(), cnt.numpy()
    out = np.empty(live.shape[:2], np.int32)
    for t in range(live.shape[0]):
        for r in range(live.shape[1]):
            stops = np.flatnonzero(~live[t, r, :cnt[t]])
            out[t, r] = stops[0] if stops.size else cnt[t] - 1
    return out


@pytest.mark.parametrize("k", [128, 256])
def test_cached_forward_is_the_uncached_forward(k):
    """The forward twin with the cache gives the uncached channels and
    accum to the bit, and encodes each pair's gates in the cache's sign
    bits: a negative alpha where the ALPHA_MAX clamp held, zero where a
    gate failed, a negative transmittance where the T_MIN test failed.
    Its last index is, for every ray, the candidate at which the float32
    replay stops it, or the tile's last candidate where none does."""
    inputs, _ = _tile_case(k, seed=k + 1)
    inputs = inputs._replace(opac=(inputs.opac * 1.5).clamp_max(0.999))
    chans, accum = cuda_tracer.forward_tiles_reference(*inputs)
    c_chans, c_accum, cache = cuda_tracer.forward_tiles_reference(
        *inputs, cache=True)
    assert torch.equal(c_chans, chans) and torch.equal(c_accum, accum)
    t, r = inputs.dirs.shape[:2]
    assert cache.pairs.dtype == torch.bfloat16
    assert tuple(cache.pairs.shape) == kernels.cache_shape(t, k, r)
    assert cache.last.dtype == torch.int32
    assert tuple(cache.last.shape) == (t, r)
    f = cuda_tracer._pairs(*inputs[:8])
    want = _stops(f.live, inputs.cnt)
    np.testing.assert_array_equal(cache.last.numpy(), want)
    last_cand = inputs.cnt.numpy()[:, None] - 1
    assert (want < last_cand).any() and (want == last_cand).any()
    ac, te = cache.pairs.float().permute(3, 0, 2, 1)
    clamped = f.ok & (f.alpha_raw >= 0.99)
    assert bool(clamped.any()) and bool((~f.live).any())
    np.testing.assert_array_equal((ac < 0).numpy(), clamped.numpy())
    np.testing.assert_array_equal((ac == 0).numpy(), (~f.ok).numpy())
    np.testing.assert_array_equal((te > 0).numpy(), f.live.numpy())
    np.testing.assert_allclose(ac.abs().numpy(), f.alpha.numpy(),
                               rtol=2 ** -8, atol=0)
    np.testing.assert_allclose(te.abs().numpy(), f.t_excl.numpy(),
                               rtol=2 ** -8, atol=0)


def _cases(k, fac):
    inputs, _ = _tile_case(k, seed=k + 7)
    inputs = inputs._replace(opac=(inputs.opac * fac).clamp_max(0.999))
    chans, _ = cuda_tracer.forward_tiles_reference(*inputs)
    g = _upstream(chans, seed=k, raw_t=False)
    replay = cuda_tracer.backward_tiles_reference(*inputs, chans, g)
    return inputs, chans, g, replay


@pytest.mark.parametrize("k,fac", [(128, 1.0), (256, 1.5)])
def test_float32_cache_decodes_to_the_replay(k, fac):
    """The decode is the replay's algebra: a cache holding each pair's
    float32 values (no bf16 rounding) gives the replay twin's gradients at
    1e-5, at the reference test's opacities and at 1.5 x, where rays stop
    at T_MIN and alphas clamp (the training loss puts no gradient on raw
    T, row 9)."""
    inputs, chans, g, replay = _cases(k, fac)
    f = cuda_tracer._pairs(*inputs[:8])
    clamped = f.ok & (f.alpha_raw >= 0.99)
    if fac > 1.0:                           # the opaque case stops rays
        assert bool(clamped.any()) and bool((~f.live).any())
    exact = kernels.TracerCache(
        torch.stack([torch.where(clamped, -f.alpha, f.alpha),
                     torch.where(f.live, f.t_excl, -f.t_excl)],
                    -1).transpose(1, 2),
        torch.tensor(_stops(f.live, inputs.cnt)))
    decoded = cuda_tracer.backward_tiles_reference(*inputs, chans, g,
                                                   cache=exact)
    for name, a, b in zip(GRAD_FIELDS, decoded, replay):
        scale = float(b.abs().max()) + 1e-12
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("k,fac,atol,cos", [(128, 1.0, CACHE_ATOL, CACHE_COS),
                                            (256, 1.0, CACHE_ATOL, CACHE_COS),
                                            (256, 1.5, 3e-2, 0.9996)])
def test_bf16_cache_against_the_replay(k, fac, atol, cos):
    """The bf16 cache against the float32 replay.  At the reference test's
    opacities, the cache bars.  At 1.5 x the opacity, where many hits
    clamp at ALPHA_MAX and rays stop after a few, the bf16 weights reach
    dL/dalpha_j through A_j / (1 - alpha_j), up to 100 x at the clamp
    (measured here: up to 1.9e-2 of d_plane's largest magnitude, cosine
    >= 0.99992): the bars there are 3e-2 and the fast mode's cosine on the
    TPU (PARITY_r03.json, 0.9996).  The port sums A_j from the decoded
    weights themselves, back to front (the reference takes gw_total from
    the float32 channels less a prefix of decoded weights, which gave up
    to 6e-2 and cosine 0.99899 on these tiles)."""
    inputs, chans, g, replay = _cases(k, fac)
    _, _, cache = cuda_tracer.forward_tiles_reference(*inputs, cache=True)
    rounded = cuda_tracer.backward_tiles_reference(*inputs, chans, g,
                                                   cache=cache)
    for name, a, b in zip(GRAD_FIELDS, rounded, replay):
        a, b = a.double().flatten(), b.double().flatten()
        assert float((a - b).abs().max() / b.abs().max()) <= atol, name
        assert float(torch.nn.functional.cosine_similarity(a, b, 0)) > cos


def _loss(out):
    """The reference's cache test loss (TestCacheFwd), every channel and
    the raw transmittance."""
    ch = out.channels
    return ((ch[..., 3] ** 2).sum() * 1e-3 + (ch[..., 0:3] ** 2).sum()
            + (ch[..., 5:8] * 0.1).sum() + ch[..., 8].sum()
            + out.raw_trans.sum())


@pytest.mark.parametrize("k,tile_h,n,seed", [
    pytest.param(128, 8, 300, 0, id="128-seed0"),
    pytest.param(128, 8, 300, 5, id="128-seed5"),
    pytest.param(256, 16, 600, 11, id="256-multichunk")])
def test_cached_gradients_match_jax(k, tile_h, n, seed):
    """Bundle gradients of the cache test's loss through `trace`: the
    port's cached path against the reference's float32 jax engine and
    against the port's own replay, at the cache bars (K = 256 over 16 x
    128 tiles: the prefix and the stop run on past a chunk of 128)."""
    s = _surfels(n, seed)
    jg, tg = _grids()
    j_cfg = j_tracer.TraceConfig(
        tile=JTileConfig(tile_h=tile_h, tile_w=128, max_per_tile=k),
        tile_batch=2, engine="jax")
    tile = TTileConfig(tile_h=tile_h, tile_w=128, max_per_tile=k)
    ref = jax.grad(lambda b: _loss(j_tracer.trace(
        b, jg, W, POSE, BG, 3, j_cfg)))(_jb(s))
    grads = {}
    for label, cfg in (("cached", t_tracer.TraceConfig(tile=tile, **FAST)),
                       ("replay", t_tracer.TraceConfig(tile=tile))):
        b = TBundle(**{key: torch.tensor(v, requires_grad=True)
                       for key, v in s.items()})
        _loss(t_tracer.trace(b, tg, W, torch.tensor(POSE), torch.tensor(BG),
                             3, cfg)).backward()
        grads[label] = {name: getattr(b, name).grad for name in s}
    for name in s:
        _cache_close(grads["cached"][name], getattr(ref, name), name)
        _cache_close(grads["cached"][name], grads["replay"][name], name)


def test_exact_order_config_trains_uncached(monkeypatch):
    """TraceConfig(exact_order=True, fast_math=True, cache_fwd=True)
    renders and differentiates without a cache, as the reference's config
    resolves it, with the exact order's gradients."""
    calls = _CacheCalls(monkeypatch)
    s = _surfels(300, 2)
    _, tg = _grids()
    tile = TTileConfig(tile_h=8, tile_w=128, max_per_tile=128)
    grads = []
    for cfg in (t_tracer.TraceConfig(tile=tile, exact_order=True, **FAST),
                t_tracer.TraceConfig(tile=tile, exact_order=True)):
        b = TBundle(**{key: torch.tensor(v, requires_grad=True)
                       for key, v in s.items()})
        _loss(t_tracer.trace(b, tg, W, torch.tensor(POSE), torch.tensor(BG),
                             3, cfg)).backward()
        grads.append([getattr(b, name).grad for name in s])
    assert calls.calls == [False, False]
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_cache_only_under_grad(monkeypatch):
    """The forward asks for the cache only when a gradient will be taken:
    not under no_grad, not for inputs that need none; under grad each tail
    pass asks for its own."""
    calls = _CacheCalls(monkeypatch)
    s = _surfels(900, 3)
    _, tg = _grids()
    tile = TTileConfig(tile_h=8, tile_w=128, max_per_tile=128)
    cfg = t_tracer.TraceConfig(tile=tile, tail_passes=1, **FAST)
    plain = TBundle(**{key: torch.tensor(v) for key, v in s.items()})
    args = (tg, W, torch.tensor(POSE), torch.tensor(BG), 3, cfg)
    with torch.no_grad():
        t_tracer.trace(plain, *args)
    t_tracer.trace(plain, *args)
    assert calls.calls == [False] * 4
    leaf = TBundle(**{key: torch.tensor(v, requires_grad=True)
                      for key, v in s.items()})
    _loss(t_tracer.trace(leaf, *args)).backward()
    assert calls.calls[4:] == [True, True]


def test_autograd_saves_and_decodes_the_cache():
    """`forward_tiles` with the cache under autograd gives the backward
    twin's decode of the forward twin's cache, bit for bit."""
    inputs, _ = _tile_case(128, seed=21)
    diff = _requiring_grad(inputs)
    chans, _ = cuda_tracer.forward_tiles(cuda_tracer.TileInputs(*diff),
                                         fast=True, cache=True)
    g = _upstream(chans, seed=21, raw_t=False)
    (chans * g).sum().backward()
    _, _, cache = cuda_tracer.forward_tiles_reference(*inputs, cache=True)
    want = cuda_tracer.backward_tiles_reference(*inputs, chans.detach(), g,
                                                cache=cache)
    for name, got, w in zip(GRAD_FIELDS, _grads_of(diff), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0, msg=name)


@pytest.fixture(scope="module")
def cached_step(synthetic_scene):
    """One training step of each package on frame 1 from the same scene:
    the reference with its float32 jax engine, the port in the training
    modes (their plain twins, the cache encoded and decoded), rendering
    the reference's fresh assignment (as `test_torch_train.one_step`)."""
    frames, scene = synthetic_scene
    f = 1
    j_cfg = j_tracer.TraceConfig(tile=JTileConfig(**TILE), tile_batch=2,
                                 engine="jax")
    jt = j_loop.Trainer(scene, frames, _j_args(), j_cfg)
    j_state, j_metrics = jt.step_fn(jt.state, j_loop.frame_batch(frames, f))
    t_scene, t_frames = _port_inputs(scene, frames)
    tt = t_loop.Trainer(t_scene, t_frames,
                        options.experiment_options(**SMALL_OPT),
                        t_tracer.TraceConfig(tile=TTileConfig(**TILE),
                                             **FAST))
    bins = tt.state.bins
    bins.index[f] = _t(j_state.bins.index[f])
    bins.valid[f] = _t(j_state.bins.valid[f])
    bins.age[f] = 0
    t_state, t_metrics = tt.step_fn(tt.state, t_loop.frame_batch(t_frames, f))
    return j_state, j_metrics, t_state, t_metrics


class TestCachedTrainStep:
    def test_loss_breakdown(self, cached_step):
        """The forward is the uncached one: every loss term as the
        reference's, at the plain-math bar."""
        _, j_metrics, _, t_metrics = cached_step
        assert set(t_metrics) == set(j_metrics)
        for k in j_metrics:
            _close(t_metrics[k], j_metrics[k], msg=k)

    @pytest.mark.parametrize("part", ["background", "actors"])
    def test_gradients_via_first_moments(self, cached_step, part):
        """Adam's first moment (0.1 * grad) at the cache bars."""
        j_state, _, t_state, _ = cached_step
        j_opt = j_state.opt_state_bg if part == "background" \
            else j_state.opt_state_actors
        t_opt = t_state.opt_bg if part == "background" \
            else t_state.opt_actors
        for g in GROUPS:
            _cache_close(t_opt.moments(g)[0], _moments_of(j_opt, g)[0], g)
        assert np.abs(t_opt.moments("xyz")[0].numpy()).max() > 0.0
