"""Port tracer held to `lidar_rt_tpu`'s tile-order tracer on the same numpy
inputs, at the kernel boundary and for whole renders.

The reference for tiled rendering is the jax engine (engine="jax", exact
top-k).  Bars are the Pallas kernel's CPU parity bar, 2e-4 absolute
(tests/test_pallas_tracer.py).  On the CPU the kernel path runs the
kernel's plain twin `forward_tiles_reference`; the CUDA kernel itself is
held to that twin in tests/test_torch_kernels.py, on a card.
"""

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


def _tile_case(k, seed, degree=3):
    """Two tiles of 8x128 rays x K candidates with a partly filled last
    tile, random per-ray min depth and initial transmittance, one
    degenerate-plane candidate, as (port TileInputs, per-tile reference
    arguments)."""
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
            f32([0.0, 0.0, 0.0]), degree, False, mind[i], t0[i]))
    return inputs, ref_args


class TestForwardTilesReference:
    @pytest.mark.parametrize("k,degree", [(128, 3), (256, 3), (128, 1)])
    def test_matches_reference_composite(self, k, degree):
        inputs, ref_args = _tile_case(k, seed=k + degree, degree=degree)
        chans, accum = cuda_tracer.forward_tiles_reference(*inputs)
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
        inputs, _ = _tile_case(128, seed=6)
        inputs = inputs._replace(opac=inputs.opac.requires_grad_())
        with pytest.raises(NotImplementedError, match="backward"):
            cuda_tracer.forward_tiles(inputs)
        with torch.no_grad():
            cuda_tracer.forward_tiles(inputs)


def _configs(k, binner="hier", exact=False):
    j_cfg = j_tracer.TraceConfig(
        tile=j_bin.TileConfig(tile_h=8, tile_w=128, max_per_tile=k,
                              binner=binner),
        exact_order=exact, tile_batch=2, engine="jax")
    tile = t_bin.TileConfig(tile_h=8, tile_w=128, max_per_tile=k,
                            binner=binner)
    return j_cfg, tile


def _grids():
    return (j_rays.SensorGrid.from_bounds(H, (-0.3, 0.1)),
            t_rays.SensorGrid.from_bounds(H, (-0.3, 0.1)))


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
        s = _surfels(300, seed=11)
        jg, tg = _grids()
        j_cfg, tile = _configs(128, exact=True)
        ref = j_tracer.trace(_jb(s), jg, W, POSE, BG, 3, j_cfg)
        cfg = t_tracer.TraceConfig(tile=tile, exact_order=True,
                                   engine="torch")
        out = t_tracer.trace(_tb(s), tg, W, torch.tensor(POSE),
                             torch.tensor(BG), 3, cfg)
        _close(out.channels, ref.channels)
        _close(out.accum_weights, ref.accum_weights)
        with pytest.raises(NotImplementedError, match="exact_order"):
            t_tracer.trace(_tb(s), tg, W, torch.tensor(POSE),
                           torch.tensor(BG), 3,
                           t_tracer.TraceConfig(tile=tile, exact_order=True))

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
