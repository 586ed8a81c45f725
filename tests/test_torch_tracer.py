"""Port tracer held to `lidar_rt_tpu`'s tracer on the same numpy inputs, at
the kernel boundary and for whole renders, forward and backward, in tile
order and exact (per-ray depth) order, with per-ray min depth and initial
transmittance, tail passes and dual returns.

The reference for tiled rendering is the jax engine (engine="jax", exact
top-k).  Bars are the Pallas kernels' CPU parity bars: 2e-4 absolute on
channels, and on gradients 3e-3 absolute after scaling by the reference's
largest magnitude (tests/test_pallas_tracer.py).  On the CPU the kernel path
runs the kernels' plain twins `forward_tiles_reference` and
`backward_tiles_reference`; the CUDA kernels themselves are held to those
twins in tests/test_torch_kernels.py, on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu.core import quaternions as j_quat
from lidar_rt_tpu.core import rays as j_rays
from lidar_rt_tpu.ops import binning as j_bin
from lidar_rt_tpu.ops import geometry as j_geo
from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu.ops.composite import SurfelBundle as JBundle
from lidar_rt_tpu_torch.core import rays as t_rays
from lidar_rt_tpu_torch.core import sh as t_sh
from lidar_rt_tpu_torch.ops import binning as t_bin
from lidar_rt_tpu_torch.ops import cuda_tracer, kernels
from lidar_rt_tpu_torch.ops import tracer as t_tracer
from lidar_rt_tpu_torch.ops.composite import SurfelBundle as TBundle

torch.set_num_threads(1)

ATOL = 2e-4
H, W = 16, 256


def f32(x):
    return np.asarray(x, np.float32)


def _surfels(n, seed):
    rng = np.random.default_rng(seed)
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0, :] = rng.uniform(-0.5, 1.0, size=(n, 3))
    sh[:, 1:9, :] = rng.normal(scale=0.15, size=(n, 8, 3))
    return dict(
        means=f32(rng.normal(scale=3.0, size=(n, 3)) + np.array([12.0, 0, 0])),
        rotations=f32(rng.normal(size=(n, 4))),
        scales=f32(rng.uniform(0.2, 0.6, (n, 2))),
        opacities=f32(rng.uniform(0.4, 0.95, n)),
        sh=sh)


def _tb(s):
    return TBundle(**{k: torch.tensor(v) for k, v in s.items()})


def _jb(s):
    return JBundle(**{k: jnp.asarray(v) for k, v in s.items()})


def _close(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t_out), np.asarray(j_out),
                               atol=atol, rtol=0)


def _tile_case(k, seed, degree=3, exact=False):
    """Two tiles of 8x128 rays x K candidates with a partly filled last
    tile, random per-ray min depth and initial transmittance, one
    degenerate-plane candidate, as (port TileInputs, per-tile reference
    arguments in tile or exact order)."""
    rng = np.random.default_rng(seed)
    n, r, t = 2 * k, 1024, 2
    s = _surfels(n, seed)
    origin = f32([0.0, 0.0, 0.3])
    # A surfel whose plane passes through the origin (p == 0).
    s["means"][3] = origin
    d = rng.normal(size=(t, r, 3)) * np.array([1.0, 0.12, 0.12]) + [1, 0, 0]
    dirs = f32(d / np.linalg.norm(d, axis=-1, keepdims=True))
    index = np.stack([rng.permutation(n)[:k] for _ in range(t)])
    cnt = np.array([k, k - 37])
    valid = np.arange(k)[None, :] < cnt[:, None]
    mind = f32(rng.uniform(0.2, 9.0, (t, r)))
    t0 = f32(rng.uniform(0.3, 1.0, (t, r)))

    bundle = _tb(s)
    axes, plane, inv_scale, opac, sign, sh = cuda_tracer._prepare_tile_inputs(
        bundle, torch.tensor(origin), torch.tensor(index),
        torch.tensor(valid))
    # The port folds the SH degree mask into the coefficients.
    inputs = cuda_tracer.TileInputs(
        torch.tensor(cnt, dtype=torch.int32), torch.tensor(dirs),
        torch.tensor(mind), torch.tensor(t0), axes, plane, inv_scale, opac,
        sign, sh * t_sh.degree_mask(degree)[:, None])

    frames = j_geo.build_frames(s["means"],
                                j_quat.to_rotation_matrix(s["rotations"]),
                                origin)
    ref_args = []
    for i in range(t):
        idx = index[i]
        ref_args.append((
            dirs[i], j_geo.SurfelFrames(*(f[idx] for f in frames)),
            s["scales"][idx], s["opacities"][idx], s["sh"][idx], valid[i],
            f32([0.0, 0.0, 0.0]), degree, exact, mind[i], t0[i]))
    return inputs, ref_args


class TestForwardTilesReference:
    @pytest.mark.parametrize("k,degree,exact", [
        pytest.param(128, 3, False, id="128-3"),
        pytest.param(256, 3, False, id="256-3"),
        pytest.param(128, 1, False, id="128-1"),
        pytest.param(128, 3, True, id="128-3-exact"),
        pytest.param(256, 3, True, id="256-3-exact")])
    def test_matches_reference_composite(self, k, degree, exact):
        """The forward twin against the reference's `_composite_tile` in
        the same order (exact: its stable argsort by depth), 2e-4."""
        inputs, ref_args = _tile_case(k, seed=k + degree, degree=degree,
                                      exact=exact)
        chans, accum = cuda_tracer.forward_tiles_reference(*inputs,
                                                           exact=exact)
        assert chans.shape == (2, 16, 1024) and accum.shape == (2, k)
        np.testing.assert_array_equal(chans[:, 10:].numpy(), 0.0)
        for i, args in enumerate(ref_args):
            ref_ch, ref_acc = j_tracer._composite_tile(*args)
            _close(chans[i, :10].T, ref_ch)
            _close(accum[i], ref_acc)
        assert float(chans[:, 4].max()) > 0.5     # the tiles do composite

    def test_dispatch_on_cpu_takes_the_twin(self):
        inputs, _ = _tile_case(128, seed=5)
        kernels.forward_launches = 0
        out = cuda_tracer.forward_tiles(inputs)
        ref = cuda_tracer.forward_tiles_reference(*inputs)
        assert kernels.forward_launches == 0
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    def test_gradients_are_refused(self):
        """Inputs that require grad are not refused: forward_tiles under
        autograd gives the plain backward twin's gradients on the CPU, and
        launches no kernel."""
        inputs, _ = _tile_case(128, seed=6)
        diff = _requiring_grad(inputs)
        kernels.forward_launches = kernels.backward_launches = 0
        chans, _ = cuda_tracer.forward_tiles(cuda_tracer.TileInputs(*diff))
        g = _upstream(chans, seed=6)
        (chans * g).sum().backward()
        assert kernels.forward_launches == kernels.backward_launches == 0
        ref = cuda_tracer.backward_tiles_reference(*inputs, chans.detach(),
                                                   g)
        for name, got, want in zip(GRAD_FIELDS, _grads_of(diff), ref):
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=name)
        d_t0 = (g[:, :10] * chans.detach()[:, :10]).sum(1) / inputs.t0
        torch.testing.assert_close(diff[3].grad, d_t0)


GRAD_FIELDS = ("d_axes", "d_plane", "d_inv_scale", "d_opac", "d_sh")


def _requiring_grad(inputs):
    return [x.detach().clone().requires_grad_(x.is_floating_point())
            for x in inputs]


def _grads_of(diff):
    """Gradients of the kernel boundary's differentiable inputs, in the
    backward's output order."""
    return [diff[i].grad for i in (4, 5, 6, 7, 9)]


def _upstream(chans, seed, raw_t=True):
    """Random upstream gradients for the 10 channel rows (row 9, raw T,
    optional), zero on the padding rows."""
    rng = np.random.default_rng(seed)
    g = torch.tensor(rng.normal(size=chans.shape), dtype=torch.float32)
    g[:, 10:] = 0.0
    if not raw_t:
        g[:, 9] = 0.0
    return g


def _grad_close(got, want, name, atol=3e-3):
    """The Pallas gradient bar: absolute after scaling by max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-8
    np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                               err_msg=name)


# (K, seed, opacity factor, upstream on raw T, exact order): no ray reaches
# T_MIN where row 9 gets a gradient (the twin's raw T is the full product,
# the kernel's stops); the opaque case stops ~30 rays and clamps alphas.
GRAD_CASES = [
    pytest.param(*case, id="-".join(map(str, case[:4]))
                 + ("-exact" if case[4] else ""))
    for case in [(128, 31, 1.0, True, False), (256, 32, 1.0, True, False),
                 (256, 256, 3.0, False, False), (128, 31, 1.0, True, True),
                 (256, 256, 3.0, False, True)]]


def _grad_case(k, seed, fac, exact=False):
    """`_tile_case` with opacities scaled by fac (clamped below 1) in both
    packages' inputs."""
    inputs, ref_args = _tile_case(k, seed, exact=exact)
    inputs = inputs._replace(opac=(inputs.opac * fac).clamp_max(0.999))
    ref_args = [(a[:3] + (np.minimum(a[3] * fac, 0.999).astype(np.float32),)
                 + a[4:]) for a in ref_args]
    return inputs, ref_args


class TestBackwardTilesReference:
    @pytest.mark.parametrize("k,seed,fac,raw_t,exact", GRAD_CASES)
    def test_matches_jax_grad_of_composite(self, k, seed, fac, raw_t, exact):
        """The twin's gradients against jax.grad through the reference's
        `_composite_tile` (in the same order) of a loss over all 10
        channel rows."""
        inputs, ref_args = _grad_case(k, seed, fac, exact)
        diff = _requiring_grad(inputs)
        chans, _ = cuda_tracer.forward_tiles(cuda_tracer.TileInputs(*diff),
                                             exact)
        g = _upstream(chans, seed, raw_t)
        (chans * g).sum().backward()
        d_axes, d_plane, d_inv_s, d_opac, d_sh = _grads_of(diff)
        stopped = int((chans.detach()[:, 9] < j_geo.T_MIN).sum())
        assert (stopped > 0) == (not raw_t)
        for i, (dirs, fr, scales, opac, sh, valid, bg, deg, exact, mind,
                t0) in enumerate(ref_args):
            g_i = jnp.asarray(g[i, :10].T.numpy())

            def loss(fr, scales, opac, sh, t0):
                ch, _ = j_tracer._composite_tile(dirs, fr, scales, opac, sh,
                                                 valid, bg, deg, exact, mind,
                                                 t0)
                return jnp.sum(ch * g_i)

            jf, js, jo, jsh, jt0 = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
                fr, scales, opac, sh, t0)
            for a, name in enumerate(("n", "w1", "w2")):
                _grad_close(d_axes[i, a].T, getattr(jf, name), name)
            for r, name in enumerate(("p", "a_u", "a_v")):
                _grad_close(d_plane[i, r], getattr(jf, name), name)
            inv_s = inputs.inv_scale[i].T
            _grad_close(-d_inv_s[i].T * inv_s * inv_s, js, "scales")
            _grad_close(d_opac[i], jo, "opacities")
            _grad_close(d_sh[i].permute(2, 1, 0), jsh, "sh")
            _grad_close(diff[3].grad[i], jt0, "t0")
            assert float(np.abs(np.asarray(jo)).max()) > 0.0

    @pytest.mark.parametrize("k,seed,fac,raw_t,exact", GRAD_CASES)
    def test_equals_autograd_of_forward_twin(self, k, seed, fac, raw_t,
                                             exact):
        """The closed-form VJP equals torch autograd through
        `forward_tiles_reference` in the same order (1e-5 relative to each
        field's largest magnitude)."""
        inputs, _ = _grad_case(k, seed, fac, exact)
        diff = _requiring_grad(inputs)
        chans, _ = cuda_tracer.forward_tiles_reference(*diff, exact=exact)
        g = _upstream(chans, seed, raw_t)
        (chans * g).sum().backward()
        got = cuda_tracer.backward_tiles_reference(*inputs, chans.detach(),
                                                   g, exact=exact)
        for name, a, b in zip(GRAD_FIELDS, got, _grads_of(diff)):
            _grad_close(a, b, name, atol=1e-5)


def _configs(k, binner="hier", exact=False, tail=0):
    j_cfg = j_tracer.TraceConfig(
        tile=j_bin.TileConfig(tile_h=8, tile_w=128, max_per_tile=k,
                              binner=binner),
        exact_order=exact, tile_batch=2, engine="jax", tail_passes=tail)
    tile = t_bin.TileConfig(tile_h=8, tile_w=128, max_per_tile=k,
                            binner=binner)
    return j_cfg, tile


def _grids():
    return (j_rays.SensorGrid.from_bounds(H, (-0.3, 0.1)),
            t_rays.SensorGrid.from_bounds(H, (-0.3, 0.1), device="cpu"))


POSE = np.eye(4, dtype=np.float32)
POSE[:3, 3] = [0.4, -0.3, 0.2]
BG = f32([0.0, 0.0, 1.0])


class TestTrace:
    @pytest.mark.parametrize("k,degree,binner", [
        (128, 3, "hier"), (256, 3, "hier"), (128, 1, "topk")])
    def test_both_engines_match_jax_engine(self, k, degree, binner):
        s = _surfels(300, seed=k + degree)
        jg, tg = _grids()
        j_cfg, tile = _configs(k, binner)
        ref = j_tracer.trace(_jb(s), jg, W, POSE, BG, degree, j_cfg)
        assert float(np.asarray(ref.channels)[..., 4].max()) > 0.5
        kernels.forward_launches = 0
        for engine in ("cuda", "torch"):
            out = t_tracer.trace(_tb(s), tg, W, torch.tensor(POSE),
                                 torch.tensor(BG), degree,
                                 t_tracer.TraceConfig(tile=tile, tile_batch=3,
                                                      engine=engine))
            assert out.channels.shape == (H, W, 9)
            _close(out.channels, ref.channels)
            _close(out.accum_weights, ref.accum_weights)
            _close(out.raw_trans, ref.raw_trans)
        assert kernels.forward_launches == 0

    def test_torch_engine_exact_order(self):
        """Exact order on both engines against the jax engine's; on CPU
        tensors the kernel path runs the exact twins, no kernel."""
        s = _surfels(300, seed=11)
        jg, tg = _grids()
        j_cfg, tile = _configs(128, exact=True)
        ref = j_tracer.trace(_jb(s), jg, W, POSE, BG, 3, j_cfg)
        kernels.reset_launches()
        for engine in ("cuda", "torch"):
            cfg = t_tracer.TraceConfig(tile=tile, exact_order=True,
                                       engine=engine)
            out = t_tracer.trace(_tb(s), tg, W, torch.tensor(POSE),
                                 torch.tensor(BG), 3, cfg)
            _close(out.channels, ref.channels)
            _close(out.accum_weights, ref.accum_weights)
            _close(out.raw_trans, ref.raw_trans)
        assert kernels.forward_exact_launches == 0
        tile_order = j_tracer.trace(_jb(s), jg, W, POSE, BG, 3,
                                    _configs(128)[0])
        assert np.abs(np.asarray(tile_order.channels)
                      - np.asarray(ref.channels)).max() > 1e-2

    @pytest.mark.parametrize("mode", ["min_depth", "init_trans", "tail",
                                      "tail-exact"])
    def test_modes_match_jax_engine(self, mode):
        """min_depth, init_trans and one tail pass (the last in exact order,
        with both per-ray images) on a case whose K = 128 budget
        truncates, both engines against jax `trace`."""
        s = _surfels(900, seed=13)
        jg, tg = _grids()
        exact = mode == "tail-exact"
        tail = int(mode.startswith("tail"))
        j_cfg, tile = _configs(128, exact=exact, tail=tail)
        rng = np.random.default_rng(13)
        md = f32(rng.uniform(0.2, 12.0, (H, W)))
        t0 = f32(rng.uniform(0.3, 1.0, (H, W)))
        kw = {"min_depth": md if mode != "init_trans" else None,
              "init_trans": t0 if mode != "min_depth" else None}
        if mode == "tail":
            kw = {}
        ref = j_tracer.trace(_jb(s), jg, W, POSE, BG, 3, j_cfg,
                             **{k: None if v is None else jnp.asarray(v)
                                for k, v in kw.items()})
        truncated = cuda_tracer.bin_bundle(_tb(s), tg, W, torch.tensor(POSE),
                                           tile).truncated
        assert int((truncated > 0).sum()) > 0
        for engine in ("cuda", "torch"):
            cfg = t_tracer.TraceConfig(tile=tile, exact_order=exact,
                                       engine=engine, tail_passes=tail)
            out = t_tracer.trace(
                _tb(s), tg, W, torch.tensor(POSE), torch.tensor(BG), 3, cfg,
                **{k: None if v is None else torch.tensor(v)
                   for k, v in kw.items()})
            _close(out.channels, ref.channels)
            _close(out.accum_weights, ref.accum_weights)
            _close(out.raw_trans, ref.raw_trans)

    def test_tail_chain_and_refusals(self):
        """A tail render takes a precomputed chain (`bin_tail_chain`) and
        gives what it bins itself; a single assignment or a chain of the
        wrong length is refused."""
        s = _surfels(900, seed=14)
        _, tg = _grids()
        _, tile = _configs(128)
        cfg = t_tracer.TraceConfig(tile=tile, tail_passes=1)
        args = (_tb(s), tg, W, torch.tensor(POSE), torch.tensor(BG), 3, cfg)
        chain = t_tracer.bin_tail_chain(
            _tb(s), tg, W, torch.linalg.inv(torch.tensor(POSE)), tile, 1)
        assert len(chain) == 2 and bool(chain[1].valid.any())
        got = t_tracer.trace(*args, assignment=chain)
        want = t_tracer.trace(*args)
        torch.testing.assert_close(got.channels, want.channels, rtol=0,
                                   atol=0)
        with pytest.raises(ValueError, match="sequence"):
            t_tracer.trace(*args, assignment=chain[0])
        with pytest.raises(ValueError, match="chain"):
            t_tracer.trace(*args, assignment=chain[:1])

    @pytest.mark.parametrize("engine", ["cuda", "torch"])
    def test_render_multi_return_matches_jax(self, engine):
        s = _surfels(900, seed=15)
        jg, tg = _grids()
        j_cfg, tile = _configs(128)
        refs = j_tracer.render_multi_return(_jb(s), jg, W, POSE, 3, j_cfg)
        outs = t_tracer.render_multi_return(
            _tb(s), tg, W, torch.tensor(POSE), 3,
            t_tracer.TraceConfig(tile=tile, engine=engine))
        for out, ref in zip(outs, refs):
            for key in ("depth", "intensity", "raydrop", "accum_weights",
                        "channels"):
                _close(out[key], ref[key])
        # Some rays return twice.
        assert float(outs[1]["channels"][..., 4].max()) > 0.5

    @pytest.mark.parametrize("k,binner,exact,tail", [
        pytest.param(128, "hier", False, 0, id="128-hier"),
        pytest.param(256, "topk", False, 0, id="256-topk"),
        pytest.param(128, "hier", True, 0, id="128-hier-exact"),
        pytest.param(128, "hier", False, 1, id="128-hier-tail"),
        pytest.param(128, "hier", True, 1, id="128-hier-tail-exact")])
    def test_render_frame_gradients_match_jax(self, k, binner, exact, tail):
        """Gradients w.r.t. every SurfelBundle field through render_frame's
        depth, intensity and ray-drop heads: the kernel path (twins) and
        the torch engine against jax.grad of the jax engine.  The tail
        cases truncate (900 surfels, K = 128), so the gradient also runs
        through the second pass and the carried raw transmittance."""
        s = _surfels(900 if tail else 300, seed=40 + k)
        jg, tg = _grids()
        j_cfg, tile = _configs(k, binner, exact, tail)
        rng = np.random.default_rng(k)
        wts = {key: f32(rng.normal(size=(H, W)))
               for key in ("depth", "intensity", "raydrop")}

        def j_loss(b):
            out = j_tracer.render_frame(b, jg, W, POSE, 3, j_cfg)
            return sum(jnp.sum(out[key] * w) for key, w in wts.items())

        ref = jax.grad(j_loss)(_jb(s))
        for engine in ("cuda", "torch"):
            b = TBundle(**{key: torch.tensor(v, requires_grad=True)
                           for key, v in s.items()})
            out = t_tracer.render_frame(
                b, tg, W, torch.tensor(POSE), 3,
                t_tracer.TraceConfig(tile=tile, tile_batch=3, engine=engine,
                                     exact_order=exact, tail_passes=tail))
            sum((out[key] * torch.tensor(w)).sum()
                for key, w in wts.items()).backward()
            for name in s:
                _grad_close(getattr(b, name).grad, getattr(ref, name),
                            f"{engine}: {name}")

    @pytest.mark.parametrize("engine", ["cuda", "torch"])
    def test_exact_order_past_the_kernels_k_matches_jax(self, engine):
        """Exact order at K = 512, past the exact kernels' 256: the "cuda"
        config resolves to the torch engine, as the reference's resolves to
        its jax engine.  Its render and its gradients through
        render_frame's heads against the jax engine's, at the bars above,
        on a scene with tiles of more than 256 candidates."""
        s = _surfels(1500, seed=51)
        jg, tg = _grids()
        j_cfg, tile = _configs(512, exact=True)
        cfg = t_tracer.TraceConfig(tile=tile, exact_order=True,
                                   engine=engine)
        assert cfg.resolve_engine() == "torch"
        cand = cuda_tracer.bin_bundle(_tb(s), tg, W, torch.tensor(POSE),
                                      tile).valid.sum(-1)
        assert int(cand.max()) > kernels.EXACT_MAX_K
        ref = j_tracer.trace(_jb(s), jg, W, POSE, BG, 3, j_cfg)
        kernels.reset_launches()
        out = t_tracer.trace(_tb(s), tg, W, torch.tensor(POSE),
                             torch.tensor(BG), 3, cfg)
        _close(out.channels, ref.channels)
        _close(out.accum_weights, ref.accum_weights)
        _close(out.raw_trans, ref.raw_trans)
        assert float(np.asarray(ref.channels)[..., 4].max()) > 0.5

        rng = np.random.default_rng(512)
        wts = {key: f32(rng.normal(size=(H, W)))
               for key in ("depth", "intensity", "raydrop")}

        def j_loss(b):
            o = j_tracer.render_frame(b, jg, W, POSE, 3, j_cfg)
            return sum(jnp.sum(o[key] * w) for key, w in wts.items())

        j_grads = jax.grad(j_loss)(_jb(s))
        b = TBundle(**{key: torch.tensor(v, requires_grad=True)
                       for key, v in s.items()})
        o = t_tracer.render_frame(b, tg, W, torch.tensor(POSE), 3, cfg)
        sum((o[key] * torch.tensor(w)).sum()
            for key, w in wts.items()).backward()
        for name in s:
            _grad_close(getattr(b, name).grad, getattr(j_grads, name),
                        f"{engine}: {name}")
        assert kernels.forward_exact_launches == 0
        assert kernels.backward_exact_launches == 0

    @pytest.mark.parametrize("use_rayhit", [True, False])
    def test_render_frame_heads(self, use_rayhit):
        s = _surfels(300, seed=12)
        jg, tg = _grids()
        j_cfg, tile = _configs(128)
        ref = j_tracer.render_frame(_jb(s), jg, W, POSE, 3, j_cfg,
                                    use_rayhit)
        out = t_tracer.render_frame(_tb(s), tg, W, torch.tensor(POSE), 3,
                                    t_tracer.TraceConfig(tile=tile),
                                    use_rayhit)
        for key in ("depth", "intensity", "raydrop", "accum_weights"):
            _close(out[key], ref[key])

    def test_unknown_engine_rejected(self):
        with pytest.raises(ValueError, match="engine"):
            t_tracer.TraceConfig(engine="pallas")
        with pytest.raises(ValueError, match="tail_passes"):
            t_tracer.TraceConfig(tail_passes=-1)
        # The exact kernels take K <= 256: a wider exact config routes to
        # the torch engine, as the reference's routes to its jax engine.
        big = t_bin.TileConfig(max_per_tile=512)
        assert t_tracer.TraceConfig(
            tile=big, exact_order=True).resolve_engine() == "torch"
        assert t_tracer.TraceConfig(
            tile=big, exact_order=True, engine="torch").resolve_engine() \
            == "torch"


# (exact order, K) -> the engine a "cuda" config resolves to; a "torch"
# config always resolves to "torch".
ROUTES = {(False, 512): "cuda", (True, 128): "cuda", (True, 256): "cuda",
          (True, 384): "torch", (True, 512): "torch"}


@pytest.mark.parametrize("engine", ["cuda", "torch"])
@pytest.mark.parametrize("exact,k", sorted(ROUTES))
def test_resolve_engine_routes_as_the_reference(exact, k, engine):
    """`TraceConfig.resolve_engine` decides from the config alone, as the
    reference's does (lidar_rt_tpu/ops/tracer.py:104): the kernel path
    unless exact order asks for more candidates than the exact kernels
    take; the cache only on the kernel path, in tile order."""
    cfg = t_tracer.TraceConfig(tile=t_bin.TileConfig(max_per_tile=k),
                               exact_order=exact, engine=engine,
                               fast_math=True, cache_fwd=True)
    want = ROUTES[exact, k] if engine == "cuda" else "torch"
    assert cfg.resolve_engine() == want
    assert cfg.use_cache == (want == "cuda" and not exact)


@pytest.mark.slow
def test_twin_matches_pallas_kernel_interpret():
    """forward_tiles_reference against the Pallas forward kernel itself
    (interpret mode) on one tile."""
    from lidar_rt_tpu.ops import pallas_tracer

    inputs, _ = _tile_case(128, seed=21)
    x = [np.asarray(v[:1]) for v in inputs]
    cnt, dirs, mind, t0, axes, plane, inv_scale, opac, sign, sh = x
    chans, accum = pallas_tracer._core_fwd_call(
        512, False, False, False, jnp.asarray(cnt, jnp.float32)[:, None],
        dirs, dirs.transpose(0, 2, 1), mind[..., None], t0[..., None], axes,
        plane, inv_scale, opac[:, None], sign[:, None], sh)
    ref_chans, ref_accum = cuda_tracer.forward_tiles_reference(
        *(v[:1] for v in inputs))
    _close(ref_chans[:, :9], np.asarray(chans)[:, :9])
    _close(ref_accum, np.asarray(accum)[:, 0])


@pytest.mark.slow
def test_backward_twin_matches_pallas_kernel_interpret():
    """backward_tiles_reference against the Pallas backward kernel itself
    (interpret mode) on one tile, with the Pallas forward's channels."""
    from lidar_rt_tpu.ops import pallas_backward, pallas_tracer

    inputs, _ = _tile_case(128, seed=22)
    x = [np.asarray(v[:1]) for v in inputs]
    cnt, dirs, mind, t0, axes, plane, inv_scale, opac, sign, sh = x
    args = (jnp.asarray(cnt, jnp.float32)[:, None], dirs,
            dirs.transpose(0, 2, 1), mind[..., None], t0[..., None], axes,
            plane, inv_scale, opac[:, None], sign[:, None], sh)
    chans, _ = pallas_tracer._core_fwd_call(512, False, False, False, *args)
    g = _upstream(torch.tensor(np.asarray(chans)), seed=22, raw_t=False)
    ref = pallas_backward.backward_pallas_call(*args, chans,
                                               jnp.asarray(g.numpy()), 512)
    got = cuda_tracer.backward_tiles_reference(
        *(v[:1] for v in inputs), torch.tensor(np.asarray(chans)), g)
    ref = [np.asarray(r) for r in ref]
    ref[3] = ref[3][:, 0]                      # d_opac (T, 1, K) -> (T, K)
    for name, a, b in zip(GRAD_FIELDS, got, ref):
        _grad_close(a, b, name)
