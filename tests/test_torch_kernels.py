"""The hand-written CUDA kernels: their build key and input checks (here),
and each kernel against its plain twin (on a card).

This file imports torch and the port only, so the card tests run where
jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

Bars on the card: channels 1e-3 absolute (the reference's on-device parity
bar); accum, a sum over rays taken with atomics in no fixed order, 1e-3
absolute plus 1e-4 relative.  Gradients, also sums taken with atomics:
cosine > 0.999 per field (the reference's on-device gradient bar) and max
abs error <= 3e-3 x max |twin| (its CPU gradient bar, scaled).
"""

import numpy as np
import pytest
import torch

from lidar_rt_tpu_torch.core import rays as t_rays
from lidar_rt_tpu_torch.ops import cuda_tracer, geometry, kernels
from lidar_rt_tpu_torch.ops import tracer as t_tracer
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.ops.composite import SurfelBundle

torch.set_num_threads(1)


def _bundle(n, seed, device):
    rng = np.random.default_rng(seed)
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0, :] = rng.uniform(-0.5, 1.0, size=(n, 3))
    sh[:, 1:, :] = rng.normal(scale=0.1, size=(n, 15, 3))
    arrays = dict(
        means=rng.normal(scale=3.0, size=(n, 3)) + np.array([12.0, 0, 0]),
        rotations=rng.normal(size=(n, 4)),
        scales=rng.uniform(0.2, 0.6, (n, 2)),
        opacities=rng.uniform(0.4, 0.95, n),
        sh=sh)
    return SurfelBundle(**{k: torch.tensor(v, dtype=torch.float32,
                                           device=device)
                           for k, v in arrays.items()})


def _case(k, seed, device, tile_h=8, tile_w=128):
    """One small render's tile inputs, with random per-ray min depth and
    initial transmittance in place of the defaults, an empty first tile
    and a short second one."""
    grid = t_rays.SensorGrid.from_bounds(16, (-0.3, 0.1), device=device)
    pose = torch.eye(4, device=device)
    tile = TileConfig(tile_h=tile_h, tile_w=tile_w, max_per_tile=k,
                      binner="hier")
    bundle = _bundle(300, seed, device)
    inputs, _ = cuda_tracer.tile_inputs(bundle, grid, 256, pose, 3, tile)
    g = torch.Generator().manual_seed(seed)
    shape = inputs.mind.shape
    cnt = inputs.cnt.clone()
    cnt[0] = 0
    cnt[1] = cnt[1].clamp_max(5)
    return inputs._replace(
        cnt=cnt,
        mind=(0.2 + 8.0 * torch.rand(shape, generator=g)).to(device),
        t0=(0.3 + 0.7 * torch.rand(shape, generator=g)).to(device))


def test_library_is_keyed_by_source(tmp_path, monkeypatch):
    """Every file under csrc/ keys every library: an edit to a kernel
    source or to the header both kernels include rebuilds both."""
    (tmp_path / "tracer_forward.cu").write_text("// one\n")
    (tmp_path / "tracer_backward.cu").write_text("// two\n")
    header = tmp_path / "tracer_common.cuh"
    header.write_text("// shared\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    paths = {name: kernels.library_path(name) for name in kernels.KERNELS}
    assert len(set(paths.values())) == len(kernels.KERNELS)
    assert all(p.parent == kernels.BUILD_DIR for p in paths.values())
    header.write_text("// shared, edited\n")
    edited = {name: kernels.library_path(name) for name in kernels.KERNELS}
    assert all(edited[n] != paths[n] for n in kernels.KERNELS)
    header.write_text("// shared\n")
    assert {n: kernels.library_path(n) for n in kernels.KERNELS} == paths
    (tmp_path / "tracer_forward.cu").write_text("// one, edited\n")
    assert kernels.library_path("tracer_backward") != paths["tracer_backward"]


def test_kernel_wrapper_refuses_cpu_tensors():
    inputs = _case(128, 0, "cpu")
    before = kernels.forward_launches
    with pytest.raises(ValueError, match="CUDA"):
        kernels.tracer_forward(*inputs)
    assert kernels.forward_launches == before
    chans, _ = cuda_tracer.forward_tiles_reference(*inputs)
    before = kernels.backward_launches
    with pytest.raises(ValueError, match="CUDA"):
        kernels.tracer_backward(*inputs, chans, torch.ones_like(chans))
    assert kernels.backward_launches == before


def _upstream(chans, seed, raw_t=False):
    """Upstream gradients for rows 0-8, drawn from a seed; row 9 (raw T,
    never read by the training loss) gets one only if raw_t."""
    g = torch.randn(chans.shape, generator=torch.Generator().manual_seed(
        seed)).to(chans.device)
    g[:, 10 if raw_t else 9:] = 0.0
    return g


GRAD_FIELDS = ("d_axes", "d_plane", "d_inv_scale", "d_opac", "d_sh")


def grad_errors(got, ref) -> dict[str, tuple[float, float]]:
    """Per gradient field: (cosine, max abs error / max |ref|)."""
    out = {}
    for name, a, b in zip(GRAD_FIELDS, got, ref):
        a, b = a.double().flatten(), b.double().flatten()
        cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        scale = float(b.abs().max()) + 1e-30
        out[name] = (cos, float((a - b).abs().max()) / scale)
    return out


def _assert_grad_bars(got, ref):
    for name, (cos, rel) in grad_errors(got, ref).items():
        assert cos > 0.999 and rel <= 3e-3, (name, cos, rel)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_bars(chans, accum, ref_chans, ref_accum):
    torch.testing.assert_close(chans, ref_chans, rtol=0, atol=1e-3)
    torch.testing.assert_close(accum, ref_accum, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("k,tile_h,tile_w", [
    (128, 8, 128), (256, 8, 128),
    (200, 4, 48)])     # ragged: 192 rays per tile, K not a chunk multiple
def test_kernel_matches_twin_on_card(cuda_device, k, tile_h, tile_w):
    inputs = _case(k, k, cuda_device, tile_h, tile_w)
    before = kernels.forward_launches
    with torch.no_grad():
        chans, accum = cuda_tracer.forward_tiles(inputs)
        torch.cuda.synchronize()
        assert kernels.forward_launches == before + 1
        _assert_bars(chans, accum,
                     *cuda_tracer.forward_tiles_reference(*inputs))
    assert float(chans[:, 4].max()) > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("k,tile_h,tile_w,fac", [
    (128, 8, 128, 1.0), (256, 8, 128, 1.0), (200, 4, 48, 1.0),
    (128, 8, 128, 0.05), (256, 8, 128, 0.05), (200, 4, 48, 0.05)])
def test_backward_kernel_matches_twin_on_card(cuda_device, k, tile_h,
                                              tile_w, fac):
    """Ragged shapes, an empty first tile and a 5-candidate second one.
    At 1/20 of the opacity no ray reaches T_MIN, so the kernel's raw T is
    the twin's full product and row 9 gets an upstream gradient too."""
    inputs = _case(k, k + 1, cuda_device, tile_h, tile_w)
    inputs = inputs._replace(opac=inputs.opac * fac)
    raw_t = fac < 1.0
    with torch.no_grad():
        chans, _ = kernels.tracer_forward(*inputs)
        if raw_t:
            ref_chans, _ = cuda_tracer.forward_tiles_reference(*inputs)
            assert float(ref_chans[:, 9].min()) >= geometry.T_MIN
        g = _upstream(chans, k, raw_t)
        before = kernels.backward_launches
        got = kernels.tracer_backward(*inputs, chans, g)
        torch.cuda.synchronize()
        assert kernels.backward_launches == before + 1
        ref = cuda_tracer.backward_tiles_reference(*inputs, chans, g)
    _assert_grad_bars(got, ref)
    for x in got:
        assert bool(x[0].eq(0).all())          # the empty tile
    assert float(got[3].abs().max()) > 0.0


@pytest.mark.cuda
def test_forward_tiles_gradients_on_card(cuda_device):
    """Autograd through the kernel boundary launches the backward kernel
    once and gives the twin's gradients, t0 included."""
    inputs = _case(256, 7, cuda_device)
    diff = [x.clone().requires_grad_(x.is_floating_point()) for x in inputs]
    chans, _ = cuda_tracer.forward_tiles(cuda_tracer.TileInputs(*diff))
    g = _upstream(chans, 3)
    before = kernels.backward_launches
    (chans * g).sum().backward()
    torch.cuda.synchronize()
    assert kernels.backward_launches == before + 1
    with torch.no_grad():
        ref = cuda_tracer.backward_tiles_reference(*inputs, chans, g)
    _assert_grad_bars([diff[i].grad for i in (4, 5, 6, 7, 9)], ref)
    d_t0 = (g[:, :10] * chans[:, :10]).sum(1) / inputs.t0
    torch.testing.assert_close(diff[3].grad, d_t0)


@pytest.mark.cuda
def test_kernel_rejects_wrong_inputs_on_card(cuda_device):
    inputs = _case(128, 3, cuda_device)
    with pytest.raises(ValueError, match="cnt"):
        kernels.tracer_forward(*inputs._replace(cnt=inputs.cnt.float()))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.tracer_forward(*inputs._replace(
            plane=inputs.plane.transpose(1, 2).contiguous().transpose(1, 2)))
    chans, _ = kernels.tracer_forward(*inputs)
    with pytest.raises(ValueError, match="g_chans"):
        kernels.tracer_backward(*inputs, chans, chans[:, :10])


@pytest.mark.cuda
def test_render_on_card_matches_torch_engine(cuda_device):
    grid = t_rays.SensorGrid.from_bounds(16, (-0.3, 0.1), device=cuda_device)
    pose = torch.eye(4, device=cuda_device)
    bundle = _bundle(300, 9, cuda_device)
    background = torch.tensor([0.0, 0.0, 1.0], device=cuda_device)
    tile = TileConfig(tile_h=8, tile_w=128, max_per_tile=128, binner="hier")
    outs = [t_tracer.trace(bundle, grid, 256, pose, background, 3,
                           t_tracer.TraceConfig(tile=tile, engine=engine))
            for engine in ("cuda", "torch")]
    _assert_bars(outs[0].channels, outs[0].accum_weights,
                 outs[1].channels, outs[1].accum_weights)
