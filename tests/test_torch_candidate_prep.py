"""The candidate gather and its scatter-add VJP (`csrc/candidate_prep.cu`
via `ops.kernels.candidate_gather` / `candidate_scatter`, the
`cuda_tracer._CandidatePrep` boundary): their plain versions against
autograd (here, in float64), and the kernels against them (on a card).

This file imports torch and the port only, so the card tests run where
jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_candidate_prep.py

Bars on the card: the gather's six outputs to float32 rounding (the same
float32 operations in the same order; sh, inv_scale, opac and sign to the
bit); the scatter's five gradients and the origin's against the plain
scatter in float64 within 1e-4 of each field's largest magnitude, the
float32 rounding of sums taken with atomics in no fixed order, up to
every valid slot of a render on one surfel.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import _candidate_fns, candidate_bound
from lidar_rt_tpu_torch.core import rays as t_rays
from lidar_rt_tpu_torch.core import sh as t_sh
from lidar_rt_tpu_torch.ops import cuda_tracer, kernels
from lidar_rt_tpu_torch.ops import tracer as t_tracer
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.train import loop

torch.set_num_threads(1)

DEGREES = [None, 0, 1, 2, 3]
FIELDS = ("means", "rotations", "scales", "opacities", "sh")
SCATTER_REL = 1e-4


def _bundle(n, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    sh = np.zeros((n, 16, 3))
    sh[:, 0, :] = rng.uniform(-0.5, 1.0, size=(n, 3))
    sh[:, 1:, :] = rng.normal(scale=0.1, size=(n, 15, 3))
    arrays = dict(
        means=rng.normal(scale=3.0, size=(n, 3)) + np.array([12.0, 0, 0]),
        rotations=rng.normal(size=(n, 4)),
        scales=rng.uniform(0.2, 0.6, (n, 2)),
        opacities=rng.uniform(0.4, 0.95, n),
        sh=sh)
    return SurfelBundle(**{k: torch.tensor(v, dtype=dtype, device=device)
                           for k, v in arrays.items()})


def _small_case(seed, dtype=torch.float64, t=4, k=6, n=9):
    """A hand-made assignment on a small bundle: valid prefixes of every
    length (tile 0 empty, tile 1 full), the sentinel N past them, surfels
    listed in several tiles and one tile listing a surfel twice, and
    surfel 2 centred on the origin (p == 0)."""
    g = torch.Generator().manual_seed(seed)
    bundle = _bundle(n, seed, "cpu", dtype)
    origin = torch.tensor([0.5, -0.25, 1.5], dtype=dtype)
    bundle.means[2] = origin
    counts = [0, k] + [int(c) for c in torch.randint(1, k, (t - 2,),
                                                      generator=g)]
    index = torch.full((t, k), n, dtype=torch.int64)
    for row, c in enumerate(counts):
        index[row, :c] = torch.randint(0, n - 1, (c,), generator=g)
    index[1, :3] = torch.tensor([2, 4, 4])
    valid = index < n
    return bundle, origin, index, valid


def _upstream(outs, valid, seed):
    """Random gradients of the gather's outputs but sign, zero past each
    tile's valid prefix, as the tracer backward leaves them."""
    g = torch.Generator().manual_seed(seed)
    grads = []
    for i, x in enumerate(outs):
        if i == 4:
            continue
        d = torch.randn(x.shape, generator=g, dtype=torch.float64).to(
            x.device, x.dtype)
        grads.append(d * valid.view(valid.shape[0], *[1] * (x.dim() - 2),
                                    valid.shape[1]))
    return grads


@pytest.mark.parametrize("degree", DEGREES)
def test_scatter_reference_matches_autograd(degree):
    """The plain scatter's closed-form VJP is autograd's through the plain
    gather, in float64: sentinel slots, a surfel listed twice in a tile
    and in several tiles, a degenerate plane (p == 0), each SH degree,
    and the origin's gradient."""
    bundle, origin, index, valid = _small_case(1)
    leaves = [x.clone().requires_grad_() for x in (*bundle, origin)]
    outs = cuda_tracer.prepare_tile_inputs_reference(
        SurfelBundle(*leaves[:5]), leaves[5], index, valid, degree)
    assert not outs[4].requires_grad
    grads = _upstream(outs, valid, 2)
    diff = [x for i, x in enumerate(outs) if i != 4]
    want = torch.autograd.grad(diff, leaves, grads)
    got = cuda_tracer.candidate_scatter_reference(bundle, origin, index,
                                                  valid, *grads, degree)
    for name, a, b in zip((*FIELDS, "origin"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12, msg=name)
    assert got[3][2] == 0.0 and outs[3][:, :][index == 2].eq(0).all()


def test_twin_gradients_past_the_count_are_zero():
    """The tracer backward's twin gives exactly zero gradients at every
    slot k >= cnt, the fact on which the scatter's skip of invalid slots
    rests (the kernels write only slots below the count of their zeroed
    output)."""
    grid = t_rays.SensorGrid.from_bounds(16, (-0.3, 0.1), device="cpu")
    tile = TileConfig(tile_h=8, tile_w=128, max_per_tile=128, binner="hier")
    inputs, _ = cuda_tracer.tile_inputs(_bundle(300, 5, "cpu"), grid, 256,
                                        torch.eye(4), 3, tile)
    cnt = inputs.cnt.clone()
    cnt[1] = cnt[1].clamp_max(5)
    inputs = inputs._replace(cnt=cnt)
    k = inputs.axes.shape[-1]
    assert bool((cnt < k).any()) and bool((cnt > 0).any())
    chans, _ = cuda_tracer.forward_tiles_reference(*inputs)
    g = torch.randn(chans.shape, generator=torch.Generator().manual_seed(3))
    past = torch.arange(k) >= cnt[:, None]                    # (T, K)
    for d in cuda_tracer.backward_tiles_reference(*inputs, chans, g):
        mask = past.view(past.shape[0], *[1] * (d.dim() - 2), k).expand(
            d.shape)
        assert torch.equal(d[mask], torch.zeros_like(d[mask]))


def test_prepare_tile_inputs_on_cpu_is_the_plain_gather():
    """On CPU tensors `_prepare_tile_inputs` is the plain gather, values
    and autograd gradients (gradcheck in float64; no degenerate plane,
    where opacity's p != 0 fold is a step)."""
    bundle, origin, index, valid = _small_case(4)
    bundle.means[2] += 1.0
    got = cuda_tracer._prepare_tile_inputs(bundle, origin, index, valid)
    want = cuda_tracer.prepare_tile_inputs_reference(bundle, origin, index,
                                                     valid)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    leaves = [x.clone().requires_grad_() for x in (*bundle, origin)]

    def fn(*xs):
        return cuda_tracer._prepare_tile_inputs(SurfelBundle(*xs[:5]),
                                                xs[5], index, valid)

    assert torch.autograd.gradcheck(fn, leaves)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_degree_folds_into_the_gather(degree):
    """The gather's sh_degree is the mask `tile_inputs` applied after
    it."""
    bundle, origin, index, valid = _small_case(6, torch.float32)
    sh = cuda_tracer._prepare_tile_inputs(bundle, origin, index, valid)[5]
    masked = cuda_tracer._prepare_tile_inputs(bundle, origin, index, valid,
                                              degree)[5]
    assert torch.equal(masked,
                       sh * t_sh.degree_mask(degree)[:, None])
    assert t_sh.kept_coeffs(degree) == (degree + 1) ** 2


@pytest.mark.parametrize("degree", [None, 1])
def test_candidate_prep_boundary_with_plain_stand_ins(monkeypatch, degree):
    """`_CandidatePrep`, the kernels stood in by the plain gather and
    scatter at their wrappers' signatures, gives the plain gather's
    values and autograd's gradients, the origin's included: the
    boundary's arguments, saved tensors and returned gradients line up
    with the kernels'."""
    _plain_kernels(monkeypatch)
    bundle, origin, index, valid = _small_case(8)
    kept = 16 if degree is None else t_sh.kept_coeffs(degree)
    leaves = [x.clone().requires_grad_() for x in (*bundle, origin)]
    outs = cuda_tracer._CandidatePrep.apply(kept, leaves[5], index, valid,
                                            *leaves[:5])
    want = cuda_tracer.prepare_tile_inputs_reference(
        SurfelBundle(*leaves[:5]), leaves[5], index, valid, degree)
    for a, b in zip(outs, want):
        assert torch.equal(a, b)
    assert not outs[4].requires_grad
    grads = _upstream(outs, valid, 9)
    got = torch.autograd.grad([x for i, x in enumerate(outs) if i != 4],
                              leaves, grads)
    ref = torch.autograd.grad([x for i, x in enumerate(want) if i != 4],
                              leaves, grads)
    for name, a, b in zip((*FIELDS, "origin"), got, ref):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12, msg=name)
    no_origin = cuda_tracer._CandidatePrep.apply(kept, origin, index, valid,
                                                 *leaves[:5])
    assert torch.autograd.grad(no_origin[0].sum(), leaves[0]) is not None


def test_candidate_kernels_refuse_cpu_tensors():
    bundle, origin, index, valid = _small_case(0, torch.float32)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.candidate_gather(*bundle, origin, index, valid)
    outs = cuda_tracer.prepare_tile_inputs_reference(bundle, origin, index,
                                                     valid)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.candidate_scatter(*bundle[:4], origin, index, valid,
                                  *(x for i, x in enumerate(outs) if i != 4))
    assert kernels.launches_since(before) == dict.fromkeys(
        kernels.LAUNCH_COUNTS, 0)


def test_times_bound_and_plain_stand_ins():
    """`chip_smoke.py --times`'s bytes of the two kernels, counted by
    hand on the small case, and its plain versions and PyTorch's
    indexing and `index_put_` yardsticks, which run on any device."""
    bundle, origin, index, valid = _small_case(2, torch.float32)
    t, k = index.shape
    n = bundle.means.shape[0]
    listed = len(set(index.clamp(0, n - 1).flatten().tolist()))
    listed_valid = len(set(index[valid].tolist()))
    want = {"candidate_gather": 9 * t * k + 4 * (58 * listed + 64 * t * k),
            "candidate_scatter": 9 * t * k + 4 * (
                63 * int(valid.sum()) + 10 * listed_valid + 58 * n)}
    got = candidate_bound(index, valid, n)
    assert got == pytest.approx({key: b / 3.35e12 * 1e3
                                 for key, b in want.items()})
    a = SimpleNamespace(index=index, valid=valid)
    outs = cuda_tracer.prepare_tile_inputs_reference(bundle, origin, index,
                                                     valid)
    grads = [x for i, x in enumerate(outs) if i != 4]
    fns = _candidate_fns(bundle, origin, a, grads, torch.Generator())
    assert set(fns) == {"candidate_gather", "candidate_scatter",
                        "candidate_gather_plain", "candidate_scatter_plain",
                        "indexing", "index_put_"}
    for name in ("candidate_gather_plain", "candidate_scatter_plain",
                 "indexing", "index_put_"):
        fns[name]()


def _plain_kernels(monkeypatch):
    """Stand the candidate kernels in by their plain versions at the
    wrappers' signatures (sh_kept as the leading coefficients kept)."""
    def keep(kept, device):
        return (torch.arange(16, device=device) < kept).to(torch.float64)

    def gather(means, rotations, scales, opacities, sh, origin, index,
               valid, sh_kept=16):
        out = cuda_tracer.prepare_tile_inputs_reference(
            SurfelBundle(means, rotations, scales, opacities, sh), origin,
            index, valid)
        return (*out[:5], out[5] * keep(sh_kept, sh.device)[:, None])

    def scatter(means, rotations, scales, opacities, origin, index, valid,
                d_axes, d_plane, d_inv_scale, d_opac, d_sh, sh_kept=16):
        bundle = SurfelBundle(means, rotations, scales, opacities, None)
        d_sh = d_sh * keep(sh_kept, d_sh.device)[:, None]
        return cuda_tracer.candidate_scatter_reference(
            bundle, origin, index, valid, d_axes, d_plane, d_inv_scale,
            d_opac, d_sh)[:5]

    monkeypatch.setattr(kernels, "candidate_gather", gather)
    monkeypatch.setattr(kernels, "candidate_scatter", scatter)


def test_chip_smoke_candidate_check_with_plain_stand_ins(monkeypatch):
    """`chip_smoke.candidate_check`, the kernel table's check of the pair
    against their plain versions, on a small render on the CPU with the
    kernels, the tracer backward and the timers stood in by plain
    versions: its checks pass (the scatter's float32 sums within its bar
    of float64's), the gather's error is zero, and it names both
    kernels."""
    import chip_smoke
    from lidar_rt_tpu_torch.scripts import street

    _plain_kernels(monkeypatch)
    monkeypatch.setattr(kernels, "tracer_backward",
                        cuda_tracer.backward_tiles_reference)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(street, "graph_ms", lambda step, iters, dev: (
        step(0), SimpleNamespace(ms=0.0))[1])
    monkeypatch.setattr(chip_smoke, "_event_ms", lambda fn, iters: (
        fn(), 0.0)[1])
    grid = t_rays.SensorGrid.from_bounds(16, (-0.3, 0.1), device="cpu")
    tile = TileConfig(tile_h=8, tile_w=128, max_per_tile=128, binner="hier")
    bundle = _bundle(300, 5, "cpu")
    pose = torch.eye(4)
    inputs, a = cuda_tracer.tile_inputs(bundle, grid, 256, pose, 2, tile)
    chans, _ = cuda_tracer.forward_tiles_reference(*inputs)
    g = torch.randn(chans.shape, generator=torch.Generator().manual_seed(3))
    origin, _ = t_rays.range_rays(grid, 256, pose)
    got = chip_smoke.candidate_check("cpu", "cpu", bundle, origin, a, inputs,
                                     chans, g, 2, torch.Generator())
    assert set(got) == {"candidate_gather", "candidate_scatter"}
    assert got["candidate_gather"][0] == 0.0
    for err, ms, plain, library, bound in got.values():
        assert np.isfinite(err) and (ms, plain, library) == (0.0, 0.0, 0.0)
        assert bound > 0


def test_chip_smoke_launch_keys_pair_the_candidate_kernels():
    """chip_smoke's launch keys read the candidate kernels' counters, and
    `_with_prep` adds one gather a forward and one scatter a backward
    launch of any kind."""
    import chip_smoke

    assert dict(zip(chip_smoke.LAUNCH_KEYS, chip_smoke.LAUNCH_COUNTERS))[
        "prep_g"] == "prep_gather_launches"
    assert set(chip_smoke.LAUNCH_COUNTERS) == set(kernels.LAUNCH_COUNTS)
    assert chip_smoke._with_prep((1, 2, 3, 4, 5, 6, 7)) == (
        1, 2, 3, 4, 5, 6, 7, 9, 19)


# On the card.


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _trainer_case(dev, seed=0, k=256, n=600):
    """One render's candidates as the trainer bins them (8 x 128 tiles,
    hier, the cached tile's 2 px pad): bundle, origin, index, valid."""
    grid = t_rays.SensorGrid.from_bounds(16, (-0.3, 0.1), device=dev)
    pose = torch.eye(4, device=dev)
    pose[:3, 3] = torch.tensor([0.3, -0.2, 0.1], device=dev)
    cfg = t_tracer.TraceConfig(tile=TileConfig(
        tile_h=8, tile_w=128, max_per_tile=k, binner="hier"))
    bundle = _bundle(n, seed, dev)
    a = cuda_tracer.bin_bundle(bundle, grid, 256, pose, loop.cache_tile(cfg))
    origin, _ = t_rays.range_rays(grid, 256, pose)
    return bundle, origin, a.index, a.valid


def _assert_gather(got, want):
    """Six outputs to float32 rounding: the unit axes within 1e-6 and the
    plane offsets within 2e-6 of their largest magnitude (the twin's CUDA
    norm of the quaternion may round the other way, and an ulp there
    moves an axis by several); the copies, reciprocals, folds and signs
    to the bit (sign and opac where the plane offset is not within
    rounding of 0)."""
    axes, plane, inv_scale, opac, sign, sh = got
    torch.testing.assert_close(axes, want[0], rtol=0, atol=1e-6)
    scale = want[1].abs().amax()
    torch.testing.assert_close(plane, want[1], rtol=0, atol=2e-6 * scale)
    assert torch.equal(inv_scale, want[2])
    assert torch.equal(sh, want[5])
    clear = want[1][:, 0].abs() > 1e-5 * scale
    assert torch.equal(sign[clear], want[4][clear])
    assert torch.equal(opac[clear], want[3][clear])
    for x in got:
        assert x.is_contiguous() and x.dtype == torch.float32


def _assert_scatter(got, want):
    for name, a, b in zip((*FIELDS, "origin"), got, want):
        bar = SCATTER_REL * float(b.abs().max()) + 1e-30
        err = float((a.double() - b).abs().max())
        assert err <= bar, (name, err, bar)


def _scatter_against_plain(bundle, origin, index, valid, degree, seed):
    """The kernel pair through `_CandidatePrep` (autograd) against the
    plain gather and scatter (float64) on the same inputs."""
    leaves = [x.clone().requires_grad_() for x in (*bundle, origin)]
    outs = cuda_tracer._prepare_tile_inputs(
        SurfelBundle(*leaves[:5]), leaves[5], index, valid, degree)
    want = cuda_tracer.prepare_tile_inputs_reference(bundle, origin, index,
                                                     valid, degree)
    _assert_gather([x.detach() for x in outs], want)
    grads = _upstream(outs, valid, seed)
    before, slots = kernels.launch_counts(), kernels.prep_slots
    got = torch.autograd.grad([x for i, x in enumerate(outs) if i != 4],
                              leaves, grads)
    torch.cuda.synchronize()
    n = kernels.launches_since(before)
    assert (n["prep_scatter_launches"],
            kernels.prep_slots - slots) == (1, index.numel())
    ref = cuda_tracer.candidate_scatter_reference(
        SurfelBundle(*(x.double() for x in bundle)), origin.double(), index,
        valid, *(g.double() for g in grads), degree)
    _assert_scatter(got, ref)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("degree", DEGREES)
def test_candidate_kernels_match_plain_on_card(cuda_device, degree):
    """At the trainer's tile inputs, with an empty tile, a degenerate
    plane and each SH degree; surfel N - 1, listed in no valid slot but
    in every sentinel slot, gets exactly zero gradient."""
    bundle, origin, index, valid = _trainer_case(cuda_device)
    n = bundle.means.shape[0]
    valid = valid.clone()
    valid[0] = False
    index = torch.where(valid, index, n)
    index = torch.where(index == n - 1, 0, index)
    index[1, 0] = 0
    bundle.means[0] = origin
    assert bool((~valid).any()) and bool((index[valid] == 0).any())
    got = _scatter_against_plain(bundle, origin, index, valid, degree, 1)
    for g in got[:5]:
        assert torch.equal(g[n - 1], torch.zeros_like(g[n - 1]))
    assert got[3][0] == 0.0      # p == 0: no opacity gradient


@pytest.mark.cuda
def test_scatter_worst_contention_on_card(cuda_device):
    """Every valid slot of the render on one surfel: T x K atomics on one
    row, within the bar."""
    bundle, origin, index, valid = _trainer_case(cuda_device)
    index = torch.where(valid, 7, index)
    _scatter_against_plain(bundle, origin, index, valid, 3, 2)


@pytest.mark.cuda
def test_scatter_kernel_matches_plain_scatter_on_card(cuda_device):
    """The scatter launched directly on the tracer backward's own
    gradients (views of its (T, 64, K) buffer, read in place), which are
    zero past each tile's count."""
    bundle = _bundle(600, 3, cuda_device)
    grid = t_rays.SensorGrid.from_bounds(16, (-0.3, 0.1), device=cuda_device)
    pose = torch.eye(4, device=cuda_device)
    pose[:3, 3] = torch.tensor([0.3, -0.2, 0.1], device=cuda_device)
    origin = pose[:3, 3]
    tile = TileConfig(tile_h=8, tile_w=128, max_per_tile=256, binner="hier")
    a = cuda_tracer.bin_bundle(bundle, grid, 256, pose, loop.cache_tile(
        t_tracer.TraceConfig(tile=tile)))
    inputs, _ = cuda_tracer.tile_inputs(bundle, grid, 256, pose, 3, tile,
                                        assignment=a)
    chans, _ = kernels.tracer_forward(*inputs)
    g = torch.randn(chans.shape, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(4))
    g[:, 9:] = 0.0
    d = kernels.tracer_backward(*inputs, chans, g)
    k = inputs.axes.shape[-1]
    past = torch.arange(k, device=cuda_device) >= inputs.cnt[:, None]
    for x in d:
        mask = past.view(past.shape[0], *[1] * (x.dim() - 2), k).expand(
            x.shape)
        assert not bool(x[mask].any())
    assert not all(x.is_contiguous() for x in d)
    got = kernels.candidate_scatter(*bundle[:4], origin, a.index, a.valid,
                                    *d)
    ref = cuda_tracer.candidate_scatter_reference(
        SurfelBundle(*(x.double() for x in bundle)), origin.double(),
        a.index, a.valid, *(x.double() for x in d))
    _assert_scatter(got, ref[:5])


@pytest.mark.cuda
def test_candidate_kernels_count_launches_on_card(cuda_device):
    """One render counts one gather; it counts one scatter, of T x K
    slots, when a gradient is taken, none under no_grad."""
    grid = t_rays.SensorGrid.from_bounds(16, (-0.3, 0.1), device=cuda_device)
    pose = torch.eye(4, device=cuda_device)
    bg = torch.zeros(3, device=cuda_device)
    cfg = t_tracer.TraceConfig(tile=TileConfig(
        tile_h=8, tile_w=128, max_per_tile=128, binner="hier"))
    bundle = SurfelBundle(*(x.requires_grad_() for x in _bundle(
        300, 1, cuda_device)))
    before, slots = kernels.launch_counts(), kernels.prep_slots
    out = t_tracer.trace(bundle, grid, 256, pose, bg, 3, cfg)
    out.channels.sum().backward()
    torch.cuda.synchronize()
    n = kernels.launches_since(before)
    tiles = cfg.tile.num_tiles(16, 256)
    assert (n["prep_gather_launches"], n["prep_scatter_launches"],
            kernels.prep_slots - slots) == (1, 1, tiles[0] * tiles[1] * 128)
    assert all(x.grad is not None for x in bundle)
    before, slots = kernels.launch_counts(), kernels.prep_slots
    with torch.no_grad():
        t_tracer.trace(bundle, grid, 256, pose, bg, 3, cfg)
    n = kernels.launches_since(before)
    assert (n["prep_gather_launches"], n["prep_scatter_launches"],
            kernels.prep_slots - slots) == (1, 0, 0)
