"""The eval and refine modules on a card against the CPU: the eval's
value-only nearest-neighbour search against a float64 numpy brute force on
20k x 20k points, and the U-Net and the LPIPS network on the card against
the same modules on the CPU; and a training step in exact order at the
rehearsal's K = 512 warm-up budget, which runs on the torch engine on the
card, then one at K = 256 on the exact kernels.

This file imports torch and the port only, so it runs where jax is not
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cli_cuda.py

Bars: the search 1e-3 m^2 absolute (float32's |a|^2 + |b|^2 - 2 a.b on
points within 20 m of the origin, against exact float64); the U-Net and
LPIPS 1e-4 (TF32 off: cuDNN would run float32 convolutions in TF32).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lidar_rt_tpu_torch.data import build, synthetic
from lidar_rt_tpu_torch.eval import lpips, metrics
from lidar_rt_tpu_torch.models import unet
from lidar_rt_tpu_torch.ops import chamfer, kernels
from lidar_rt_tpu_torch.train import loop, options, refine

torch.set_num_threads(1)


@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _brute_force(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.empty(len(a))
    b_sq = (b * b).sum(1)
    for s in range(0, len(a), 2048):
        blk = a[s:s + 2048]
        d2 = (blk * blk).sum(1)[:, None] + b_sq[None] - 2.0 * blk @ b.T
        out[s:s + 2048] = np.maximum(d2.min(1), 0.0)
    return out


@pytest.mark.cuda
def test_nearest_search_on_card(cuda_device):
    rng = np.random.default_rng(0)
    a = rng.uniform(-20, 20, (20_000, 3))
    b = np.concatenate([a[:10_000] + rng.normal(0, 0.05, (10_000, 3)),
                        rng.uniform(-20, 20, (10_000, 3))])
    want = _brute_force(a, b)
    got = chamfer.nearest_sq_dists(
        torch.as_tensor(a, dtype=torch.float32, device=cuda_device),
        torch.as_tensor(b, dtype=torch.float32, device=cuda_device),
        chunk=2048).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    m = metrics.points_metrics(torch.as_tensor(a, device=cuda_device),
                               torch.as_tensor(b, device=cuda_device))
    assert 0.0 < m["fscore"] < 1.0 and np.isfinite(m["chamfer_dist"])


@pytest.mark.cuda
def test_unet_on_card_matches_cpu(cuda_device):
    gen = torch.Generator().manual_seed(0)
    cpu = unet.make_unet(9, "cpu", gen)
    card = unet.make_unet(9, cuda_device)
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(1, 9, 64, 256, generator=gen)
    want = refine.apply_unet(cpu, *x[0, :3], x[0, 3:6].permute(1, 2, 0),
                             x[0, 6:].permute(1, 2, 0))
    xc = x.to(cuda_device)
    got = refine.apply_unet(card, *xc[0, :3], xc[0, 3:6].permute(1, 2, 0),
                            xc[0, 6:].permute(1, 2, 0))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_unet_trains_on_card(cuda_device):
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(3, 3, 32, 64, generator=gen).to(cuda_device)
    y = (x[:, 2:3] > 0.5).float()
    model, hist = refine.train_unet(x, y, epochs=3, batch_size=2)
    assert all(np.isfinite(hist)) and next(model.parameters()).is_cuda


@pytest.mark.cuda
def test_lpips_on_card_matches_cpu(cuda_device):
    gen = torch.Generator().manual_seed(2)
    cpu = lpips.init_weights(lpips.new_lpips("cpu"), gen)
    card = lpips.new_lpips(cuda_device)
    card.load_state_dict(cpu.state_dict())
    gt = torch.rand(64, 256, generator=gen)
    pred = (gt + 0.1 * torch.randn(64, 256, generator=gen)).clamp(0, 1)
    want = lpips.make_lpips_fn(cpu)(pred, gt)
    got = lpips.make_lpips_fn(card)(pred.to(cuda_device), gt.to(cuda_device))
    assert want > 0
    assert got == pytest.approx(want, rel=1e-4, abs=1e-7)


@pytest.mark.cuda
def test_exact_training_step_at_k512_on_card(cuda_device):
    """`trace_configs` of {exact_order, warmup_max_per_tile: 512} on the
    card: step 1 at K = 512 resolves to the torch engine (no kernel
    launch, finite loss and parameters on the card); step 2, past the
    switch, at K = 256 on the exact forward and the exact backward with
    the configs' fast sums, fed by the candidate gather and scatter."""
    frames, track = synthetic.generate(num_frames=2, height=32, width=256,
                                       device=cuda_device)
    args = options.experiment_options(rebin_interval=10)
    args.tracer = SimpleNamespace(tile_h=8, tile_w=128, max_per_tile=256,
                                  exact_order=True, warmup_max_per_tile=512,
                                  warmup_until=1)
    cfg, warm, until = options.trace_configs(args, cuda_device)
    assert (warm.resolve_engine(), cfg.resolve_engine()) == ("torch", "cuda")
    scene = build.assemble_scene(
        frames, [track], args,
        torch.Generator(device=cuda_device).manual_seed(0))
    trainer = loop.Trainer(scene, frames, args, cfg, warmup_cfg=warm,
                           warmup_until=until)
    kernels.reset_launches()
    trainer.run(1, log_every=1)
    assert trainer.step_cfg.tile.max_per_tile == 512
    assert set(kernels.launch_counts().values()) == {0}
    trainer.run(1, log_every=1)
    assert trainer.step_cfg.tile.max_per_tile == 256
    n = kernels.launch_counts()
    assert n["forward_exact_launches"] == n["backward_exact_fast_launches"] \
        == 1
    # and the candidate gather and its scatter, one each for the pass
    assert n["prep_gather_launches"] == n["prep_scatter_launches"] == 1
    assert sum(n.values()) == 4
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    for v in trainer.state.scene.background.params().values():
        assert v.is_cuda and bool(torch.isfinite(v).all())
