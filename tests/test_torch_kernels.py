"""The hand-written CUDA kernel: its build key and input checks (here), and
the kernel against its plain twin (on a card).

This file imports torch and the port only, so the card tests run where
jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

Bars on the card: channels 1e-3 absolute (the reference's on-device parity
bar); accum, a sum over rays taken with atomics in no fixed order, 1e-3
absolute plus 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from lidar_rt_tpu_torch.core import rays as t_rays
from lidar_rt_tpu_torch.ops import cuda_tracer, kernels
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
    a, b = tmp_path / "a.cu", tmp_path / "b.cu"
    a.write_text("// one\n")
    b.write_text("// two\n")
    monkeypatch.setattr(kernels, "SOURCE", a)
    path_a = kernels.library_path()
    monkeypatch.setattr(kernels, "SOURCE", b)
    assert kernels.library_path() != path_a
    b.write_text("// one\n")
    assert kernels.library_path() == path_a
    assert path_a.parent == kernels.BUILD_DIR


def test_kernel_wrapper_refuses_cpu_tensors():
    inputs = _case(128, 0, "cpu")
    before = kernels.forward_launches
    with pytest.raises(ValueError, match="CUDA"):
        kernels.tracer_forward(*inputs)
    assert kernels.forward_launches == before


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
def test_kernel_rejects_wrong_inputs_on_card(cuda_device):
    inputs = _case(128, 3, cuda_device)
    with pytest.raises(ValueError, match="cnt"):
        kernels.tracer_forward(*inputs._replace(cnt=inputs.cnt.float()))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.tracer_forward(*inputs._replace(
            plane=inputs.plane.transpose(1, 2).contiguous().transpose(1, 2)))


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
