"""The hand-written CUDA kernels: their build key and input checks (here),
and each kernel in each mode (tile order, exact per-ray depth order; the
forward's cache and the backward's decode of it; the fast sums) against
its plain twin (on a card).

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

import ctypes
import re

import numpy as np
import pytest
import torch

from chip_smoke import (FAST_COS, FAST_REL, cache_check, check_cached_pair,
                        last_index_check, permuted_rays, street_soup)
from lidar_rt_tpu_torch.core import rays as t_rays
from lidar_rt_tpu_torch.ops import cuda_tracer, geometry, kernels
from lidar_rt_tpu_torch.ops import tracer as t_tracer
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import bf16_microbench, kernel_microbench

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
    and a short second one.  Past K = 256, 2K surfels, so that tiles hold
    more candidates than the smaller budgets take."""
    grid = t_rays.SensorGrid.from_bounds(16, (-0.3, 0.1), device=device)
    pose = torch.eye(4, device=device)
    tile = TileConfig(tile_h=tile_h, tile_w=tile_w, max_per_tile=k,
                      binner="hier")
    bundle = _bundle(300 if k <= 256 else 2 * k, seed, device)
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


def _c_signatures(source: str) -> dict[str, list]:
    """The `extern "C" int ...(...)` entry points of a CUDA source,
    each parameter as the ctypes type that passes it: c_void_p for a
    pointer, c_int for an int (None for anything else)."""
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                   source):
        types = []
        for param in params.split(","):
            param = " ".join(param.split())
            types.append(ctypes.c_void_p if "*" in param
                         else ctypes.c_int if re.fullmatch(r"int \w+", param)
                         else None)
        out[name] = types
    return out


def test_entry_point_argtypes_match_sources():
    """Every C entry point of every kernel library takes the pointers and
    ints, in order, that the loader's argtypes pass: a mismatch would
    segfault on the card instead of raising, so it fails here."""
    for name in kernels.KERNELS:
        found = _c_signatures((kernels.CSRC / f"{name}.cu").read_text())
        assert found == kernels.ENTRY_POINTS[name], name
        assert all(None not in types for types in found.values())
    launcher = kernels.ENTRY_POINTS["tracer_backward"]["tracer_backward"]
    assert launcher.count(ctypes.c_void_p) == 17     # 16 arrays, the stream
    assert launcher.count(ctypes.c_int) == 5


def test_signature_parser_counts_parameters():
    source = """
    extern "C" int tracer_x(const void* a, void* b,
                            int n, int k, void* stream) {}
    extern "C" const char* tracer_error_string(int code) {}
    extern "C" int tracer_y(int which, int* out, float bad) {}
    """
    p, i = ctypes.c_void_p, ctypes.c_int
    assert _c_signatures(source) == {"tracer_x": [p, p, i, i, p],
                                     "tracer_y": [i, p, None]}


def test_exact_kernels_refuse_unsupported_k():
    """The exact kernels take 1 <= K <= EXACT_MAX_K; a wider tile is
    refused before any launch, on any device (nothing falls back).  A
    TraceConfig asking for exact order at such a K routes to the torch
    engine from the config alone, as the reference's routes to its jax
    engine."""
    big = 2 * kernels.EXACT_MAX_K
    inputs = _case(big, 0, "cpu")
    kernels.reset_launches()
    with pytest.raises(ValueError, match="exact"):
        kernels.tracer_forward(*inputs, exact=True)
    chans, _ = cuda_tracer.forward_tiles_reference(*inputs)
    with pytest.raises(ValueError, match="exact"):
        kernels.tracer_backward(*inputs, chans, chans, exact=True)
    wide = t_tracer.TraceConfig(tile=TileConfig(max_per_tile=big),
                                exact_order=True)
    assert wide.resolve_engine() == "torch"
    assert kernels.forward_exact_launches == 0
    assert kernels.backward_exact_launches == 0
    kernels.check_exact_k(128)
    kernels.check_exact_k(kernels.EXACT_MAX_K)


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


def _launches(exact):
    return ((kernels.forward_exact_launches, kernels.backward_exact_launches)
            if exact else (kernels.forward_launches,
                           kernels.backward_launches))


# Ragged: 192 rays per tile, K not a chunk multiple.
FWD_CASES = [pytest.param(*c, id="-".join(map(str, c[:3]))
                          + ("-exact" if c[3] else ""))
             for c in [(128, 8, 128, False), (256, 8, 128, False),
                       (512, 8, 128, False),
                       (200, 4, 48, False), (128, 8, 128, True),
                       (256, 8, 128, True), (200, 4, 48, True)]]


@pytest.mark.cuda
@pytest.mark.parametrize("k,tile_h,tile_w,exact", FWD_CASES)
def test_kernel_matches_twin_on_card(cuda_device, k, tile_h, tile_w, exact):
    inputs = _case(k, k, cuda_device, tile_h, tile_w)
    before = _launches(exact)[0]
    with torch.no_grad():
        chans, accum = cuda_tracer.forward_tiles(inputs, exact)
        torch.cuda.synchronize()
        assert _launches(exact)[0] == before + 1
        _assert_bars(chans, accum, *cuda_tracer.forward_tiles_reference(
            *inputs, exact=exact))
    assert float(chans[:, 4].max()) > 0.5


BWD_CASES = [pytest.param(*c, id="-".join(map(str, c[:4]))
                          + ("-exact" if c[4] else ""))
             for c in [(128, 8, 128, 1.0, False), (256, 8, 128, 1.0, False),
                       (200, 4, 48, 1.0, False), (128, 8, 128, 0.05, False),
                       (256, 8, 128, 0.05, False), (200, 4, 48, 0.05, False),
                       # The rehearsal's warm-up budget.
                       (512, 8, 128, 1.0, False), (512, 8, 128, 0.05, False),
                       (128, 8, 128, 1.0, True), (256, 8, 128, 1.0, True),
                       (128, 8, 128, 0.05, True), (256, 8, 128, 0.05, True),
                       # Rays per tile not a multiple of the blocks' ray
                       # counts (192; 480 = 256 + 224 = 3 x 128 + 96).
                       (200, 4, 48, 1.0, True), (256, 5, 96, 1.0, False),
                       (256, 5, 96, 1.0, True)]]


@pytest.mark.cuda
@pytest.mark.parametrize("k,tile_h,tile_w,fac,exact", BWD_CASES)
def test_backward_kernel_matches_twin_on_card(cuda_device, k, tile_h,
                                              tile_w, fac, exact):
    """Ragged shapes, an empty first tile and a 5-candidate second one.
    At 1/20 of the opacity no ray reaches T_MIN, so the kernel's raw T is
    the twin's full product and row 9 gets an upstream gradient too."""
    inputs = _case(k, k + 1, cuda_device, tile_h, tile_w)
    inputs = inputs._replace(opac=inputs.opac * fac)
    raw_t = fac < 1.0
    with torch.no_grad():
        chans, _ = kernels.tracer_forward(*inputs, exact=exact)
        if raw_t:
            ref_chans, _ = cuda_tracer.forward_tiles_reference(*inputs,
                                                               exact=exact)
            assert float(ref_chans[:, 9].min()) >= geometry.T_MIN
        g = _upstream(chans, k, raw_t)
        before = _launches(exact)[1]
        got = kernels.tracer_backward(*inputs, chans, g, exact=exact)
        torch.cuda.synchronize()
        assert _launches(exact)[1] == before + 1
        ref = cuda_tracer.backward_tiles_reference(*inputs, chans, g,
                                                   exact=exact)
    _assert_grad_bars(got, ref)
    for x in got:
        assert bool(x[0].eq(0).all())          # the empty tile
    assert float(got[3].abs().max()) > 0.0


def _dense_case(device):
    """Flagship tile shape (8 x 128 = 1024 rays, K = 256) on 8 tiles, four
    of them full, with a cluster of large surfels 6 m ahead: each candidate
    of a full tile is hit by ~100 of its rays, so every sum gathers the
    partial sums of many warps and of every block of its tile."""
    rng = np.random.default_rng(1)
    bundle = _bundle(1500, 5, device)
    means = rng.normal(scale=1.5, size=(1500, 3)) + np.array([6.0, 0, 0])
    bundle = bundle._replace(
        means=torch.tensor(means, dtype=torch.float32, device=device),
        scales=bundle.scales * 2.0)
    grid = t_rays.SensorGrid.from_bounds(16, (-0.3, 0.1), device=device)
    tile = TileConfig(tile_h=8, tile_w=128, max_per_tile=256, binner="hier")
    inputs, _ = cuda_tracer.tile_inputs(bundle, grid, 512,
                                        torch.eye(4, device=device), 3, tile)
    return inputs


def test_dense_case_shares_candidates():
    """The dense card case below is what it claims, checked on the twin."""
    inputs = _dense_case("cpu")
    f = cuda_tracer._pairs(*inputs[:8])
    assert tuple(f.w.shape) == (8, 1024, 256)
    assert int((inputs.cnt == 256).sum()) >= 4
    valid = torch.arange(256) < inputs.cnt[:, None]
    assert float((f.w > 0).sum(1).float()[valid].mean()) > 64.0


def _far_small_case(device="cpu"):
    """Small surfels (1-5 cm) 30-60 m away, many seen edge-on: the cone
    test's slack for rounding matters most where |U| / |n.d| is large."""
    rng = np.random.default_rng(3)
    n = 400
    bundle = _bundle(n, 3, device)
    dist = rng.uniform(30.0, 60.0, n)
    az = rng.uniform(-0.3, 0.3, n)
    means = np.stack([dist * np.cos(az), dist * np.sin(az),
                      rng.uniform(-8.0, 3.0, n)], 1)
    bundle = bundle._replace(
        means=torch.tensor(means, dtype=torch.float32,
                           device=device),
        scales=torch.tensor(rng.uniform(0.01, 0.05, (n, 2)),
                            dtype=torch.float32, device=device))
    grid = t_rays.SensorGrid.from_bounds(32, (-0.3, 0.1), device=device)
    tile = TileConfig(tile_h=8, tile_w=128, max_per_tile=256, binner="hier")
    inputs, _ = cuda_tracer.tile_inputs(bundle, grid, 4096,
                                        torch.eye(4, device=device), 3, tile)
    return inputs


def _second_pass_case(device="cpu"):
    """The dense case as a second return or a tail pass sees it: each ray
    that returned starts 1 m past its first return's depth, and every ray
    starts from the first pass's raw transmittance (below 1 for most rays,
    below T_MIN for some)."""
    inputs = _dense_case(device)
    chans, _ = cuda_tracer.forward_tiles_reference(*inputs)
    acc_w = chans[:, 4]
    depth = chans[:, 3] / acc_w.clamp_min(1e-6)
    return inputs._replace(
        mind=torch.where(acc_w > 0.5, depth + 1.0,
                         torch.full_like(depth, geometry.DEPTH_MIN)),
        t0=chans[:, 9].contiguous())


def test_second_pass_case_is_what_it_claims():
    inputs = _second_pass_case()
    assert float(inputs.mind.max()) > 2.0
    assert float((inputs.t0 < 1.0).float().mean()) > 0.5
    assert float(inputs.t0.min()) < geometry.T_MIN


@pytest.mark.parametrize("case", ["dense", "random", "ragged", "far_small",
                                  "second_pass"])
def test_cone_test_never_skips_a_hit(case):
    """The kernels' cone test (its plain float32 version) skips a (warp,
    candidate) only where no ray of the warp passes the gates, so a walk
    that would pass over such a pair unchanged gives the same result; and
    it does skip.  Per-ray min depths and initial transmittances below 1
    (second returns, tail passes) included."""
    inputs = {"dense": lambda: _dense_case("cpu"),
              "random": lambda: _case(256, 257, "cpu"),
              "ragged": lambda: _case(200, 201, "cpu", 4, 48),
              "far_small": _far_small_case,
              "second_pass": _second_pass_case}[case]()
    skip = cuda_tracer.cone_skips(inputs.cnt, inputs.dirs, inputs.axes,
                                  inputs.plane, inputs.inv_scale,
                                  inputs.opac)
    f = cuda_tracer._pairs(*inputs[:8])
    t, r, k = f.alpha.shape
    nw = skip.shape[1]
    hit = torch.nn.functional.pad(f.alpha > 0, (0, 0, 0, nw * 32 - r))
    hit = hit.view(t, nw, 32, k).any(2)
    assert int(hit.sum()) > 0
    assert not bool((skip & hit).any())
    assert int(skip.sum()) > 0


@pytest.mark.parametrize("exact", [False, True], ids=["tile", "exact"])
def _tile_per_warp(inputs):
    """The same tiles with each 32-ray warp made a tile of its own that
    holds its tile's candidates: tile w of the result is warp w % (R / 32)
    of tile w // (R / 32), and each ray sees the same candidates."""
    t, r = inputs.dirs.shape[:2]
    assert r % 32 == 0
    nw = r // 32

    def split(x):
        return x.reshape(t * nw, 32, *x.shape[2:])

    def share(x):
        return x.repeat_interleave(nw, dim=0)

    return cuda_tracer.TileInputs(share(inputs.cnt), split(inputs.dirs),
                                  split(inputs.mind), split(inputs.t0),
                                  *(share(x) for x in inputs[4:]))


@pytest.mark.parametrize("exact", [False, True], ids=["tile", "exact"])
@pytest.mark.parametrize("case", ["dense", "second_pass"])
def test_twin_is_unchanged_by_the_cull(case, exact):
    """The forward twin with every pair that the cone test skips forced to
    alpha = 0, as the culled kernels pass it over, gives the same bits in
    both orders: with each warp a tile of its own, a skipped candidate of
    a warp gets opacity 0 there.  The dense case holds exact range ties,
    so the exact order's (t, index) tie order is exercised."""
    inputs = {"dense": _dense_case, "second_pass": _second_pass_case}[
        case]("cpu")
    skip = cuda_tracer.cone_skips(inputs.cnt, inputs.dirs, inputs.axes,
                                  inputs.plane, inputs.inv_scale,
                                  inputs.opac)
    assert int(skip.sum()) > 0
    warps = _tile_per_warp(inputs)
    culled = warps._replace(opac=torch.where(skip.flatten(0, 1), 0.0,
                                             warps.opac))
    want = cuda_tracer.forward_tiles_reference(*warps, exact=exact)
    got = cuda_tracer.forward_tiles_reference(*culled, exact=exact)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert float(want[0][:, 4].max()) > 0.0


CULL_CASES = {"dense": _dense_case,
              "random": lambda device: _case(256, 257, device),
              "ragged": lambda device: _case(200, 201, device, 4, 48),
              "far_small": _far_small_case}


def _skips(inputs) -> int:
    return int(cuda_tracer.cone_skips(inputs.cnt, inputs.dirs, inputs.axes,
                                      inputs.plane, inputs.inv_scale,
                                      inputs.opac).sum())


@pytest.mark.parametrize("case", sorted(CULL_CASES))
def test_permuted_rays_defeat_the_cone_test(case):
    """The premise of the card test below, on the cone test's twin."""
    inputs = CULL_CASES[case]("cpu")
    assert _skips(permuted_rays(inputs)[0]) * 10 < _skips(inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True], ids=["tile", "exact"])
@pytest.mark.parametrize("case", ["dense", "random", "far_small"])
def test_backward_cull_drops_no_pair_on_card(cuda_device, case, exact):
    """The kernel's own cone test skips no pair.  With an upstream gradient
    on channel 1 only, d_sh[1][0] of a candidate is b_0 times the sum of
    its rays' weights, a sum of positive terms; the same tiles with their
    rays permuted, where the cone test rules out almost nothing, must give
    every candidate the same sum to float rounding, so a dropped pair would
    show as its candidate's missing weight."""
    inputs = CULL_CASES[case](cuda_device)
    sums = []
    with torch.no_grad():
        for x in (inputs, permuted_rays(inputs)[0]):
            chans, _ = kernels.tracer_forward(*x, exact=exact)
            g = torch.zeros_like(chans)
            g[:, 1] = 1.0
            sums.append(kernels.tracer_backward(*x, chans, g,
                                                exact=exact)[4][:, 1, 0])
        torch.cuda.synchronize()
    assert int((sums[0] > 0).sum()) > 0
    assert torch.equal(sums[0] > 0, sums[1] > 0)
    torch.testing.assert_close(sums[0], sums[1], rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True], ids=["tile", "exact"])
@pytest.mark.parametrize("case", ["dense", "random", "far_small"])
def test_forward_cull_drops_no_pair_on_card(cuda_device, case, exact):
    """The forward kernels' own cull drops no pair: on the same tiles with
    their rays permuted, where the cone test rules out almost nothing, each
    ray's channels are the same bits, and each candidate's accum the same
    sum over rays to float rounding (atomics in another order)."""
    inputs = CULL_CASES[case](cuda_device)
    permuted, order = permuted_rays(inputs)
    with torch.no_grad():
        chans, accum = kernels.tracer_forward(*inputs, exact=exact)
        chans_p, accum_p = kernels.tracer_forward(*permuted, exact=exact)
        torch.cuda.synchronize()
    unpermuted = torch.empty_like(chans_p)
    unpermuted[:, :, order] = chans_p
    assert float(chans[:, 4].max()) > 0.5
    assert torch.equal(chans, unpermuted)
    torch.testing.assert_close(accum, accum_p, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True], ids=["tile", "exact"])
def test_backward_kernel_dense_flagship_tiles_on_card(cuda_device, exact):
    inputs = _dense_case(cuda_device)
    with torch.no_grad():
        chans, _ = kernels.tracer_forward(*inputs, exact=exact)
        g = _upstream(chans, 11)
        got = kernels.tracer_backward(*inputs, chans, g, exact=exact)
        torch.cuda.synchronize()
        ref = cuda_tracer.backward_tiles_reference(*inputs, chans, g,
                                                   exact=exact)
    _assert_grad_bars(got, ref)


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
@pytest.mark.parametrize("exact,tail", [
    pytest.param(False, 0, id="tile"), pytest.param(True, 0, id="exact"),
    pytest.param(False, 1, id="tail"), pytest.param(True, 1, id="tail-exact")])
def test_render_on_card_matches_torch_engine(cuda_device, exact, tail):
    """A render through the kernels against the plain torch engine in the
    same mode.  900 surfels truncate K = 128, so the tail renders take two
    launches; where a ray stops, both carry raw T below T_MIN and the
    second pass composites nothing for it."""
    grid = t_rays.SensorGrid.from_bounds(16, (-0.3, 0.1), device=cuda_device)
    pose = torch.eye(4, device=cuda_device)
    bundle = _bundle(900 if tail else 300, 9, cuda_device)
    background = torch.tensor([0.0, 0.0, 1.0], device=cuda_device)
    tile = TileConfig(tile_h=8, tile_w=128, max_per_tile=128, binner="hier")
    kernels.reset_launches()
    outs = [t_tracer.trace(bundle, grid, 256, pose, background, 3,
                           t_tracer.TraceConfig(tile=tile, engine=engine,
                                                exact_order=exact,
                                                tail_passes=tail))
            for engine in ("cuda", "torch")]
    assert _launches(exact)[0] == tail + 1
    assert _launches(not exact)[0] == 0
    _assert_bars(outs[0].channels, outs[0].accum_weights,
                 outs[1].channels, outs[1].accum_weights)


def _tied_depth_case(device):
    """Two stacks of 40 coplanar surfels facing the sensor, 10 m and 10.5 m
    ahead, their indices interleaved: every ray through them meets 40 hits
    at one exact t, then 40 at another, more than the exact walk's
    16-entry buffer holds (the planes of surfels assembled from one flat
    range-image patch tie the same way)."""
    n = 80
    rng = np.random.default_rng(3)
    means = np.zeros((n, 3), np.float32)
    means[:, 0] = np.where(np.arange(n) % 2 == 0, 10.0, 10.5)
    rotations = np.tile(np.float32([np.sqrt(0.5), 0.0, np.sqrt(0.5), 0.0]),
                        (n, 1))                  # normal along x
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0, :] = rng.uniform(-0.5, 1.0, (n, 3))
    bundle = SurfelBundle(**{k: torch.tensor(v, device=device) for k, v in dict(
        means=means, rotations=rotations,
        scales=rng.uniform(2.0, 4.0, (n, 2)).astype(np.float32),
        opacities=rng.uniform(0.01, 0.04, n).astype(np.float32),
        sh=sh).items()})
    grid = t_rays.SensorGrid.from_bounds(16, (-0.2, 0.2), device=device)
    tile = TileConfig(tile_h=8, tile_w=128, max_per_tile=128, binner="hier")
    inputs, _ = cuda_tracer.tile_inputs(bundle, grid, 2048,
                                        torch.eye(4, device=device), 3, tile)
    return inputs


def test_tied_depth_case_is_what_it_claims():
    """Checked on the twin: rays with more tied hits than the buffer."""
    inputs = _tied_depth_case("cpu")
    f = cuda_tracer._pairs(*inputs[:8], exact=True)
    hits = f.ok.sum(-1)
    assert int(hits.max()) == 80
    tile, ray = torch.nonzero(hits == 80)[0]
    assert len(set(f.t[tile, ray][f.ok[tile, ray]].tolist())) == 2
    assert int((f.live & f.ok)[tile, ray].sum()) == 80


@pytest.mark.cuda
def test_exact_kernels_with_tied_depths_on_card(cuda_device):
    """The exact walk keeps tied hits in index order across its passes:
    both exact kernels against their twins where 40 hits share each t."""
    inputs = _tied_depth_case(cuda_device)
    with torch.no_grad():
        chans, accum = kernels.tracer_forward(*inputs, exact=True)
        _assert_bars(chans, accum, *cuda_tracer.forward_tiles_reference(
            *inputs, exact=True))
        g = _upstream(chans, 3)
        got = kernels.tracer_backward(*inputs, chans, g, exact=True)
        _assert_grad_bars(got, cuda_tracer.backward_tiles_reference(
            *inputs, chans, g, exact=True))


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True], ids=["tile", "exact"])
def test_band_kernels_match_twins_on_card(cuda_device, exact):
    """The column bands of a rays = 2 mesh on the flagship shape: a 64 x
    2650 scan in 8 x 128 tiles at K = 256, so each band of 1325 columns is
    8 x 11 = 88 tiles, its last tile tracing 83 columns of the next band.
    Both kernels against their twins on each band's tile inputs."""
    soup = street_soup(32_768, seed=2)
    bundle = SurfelBundle(**{k: torch.tensor(v, device=cuda_device)
                             for k, v in soup.items()})
    grid = t_rays.SensorGrid.from_bounds(64, (-0.31, 0.04), pixel_offset=0.5,
                                         device=cuda_device)
    pose = torch.eye(4, device=cuda_device)
    pose[2, 3] = 2.0
    for band in range(2):
        inputs, _ = cuda_tracer.tile_inputs(
            bundle, grid, 2650, pose, 3, t_tracer.FLAGSHIP_TILE,
            col_offset=1325 * band, render_width=1325)
        assert tuple(inputs.dirs.shape[:2]) == (88, 1024)
        with torch.no_grad():
            chans, accum = kernels.tracer_forward(*inputs, exact=exact)
            _assert_bars(chans, accum, *cuda_tracer.forward_tiles_reference(
                *inputs, exact=exact))
            g = _upstream(chans, band)
            got = kernels.tracer_backward(*inputs, chans, g, exact=exact)
            _assert_grad_bars(got, cuda_tracer.backward_tiles_reference(
                *inputs, chans, g, exact=exact))
        assert float(chans[:, 4].max()) > 0.5


@pytest.mark.cuda
def test_padded_normals_on_card(cuda_device):
    """The assembly's padded PCA normals on the card, for a frame larger
    than one batch of the eigensolver (`knn.EIGH_BATCH`): the same
    neighbour covariances as on the CPU, each normal a unit vector facing
    the sensor and orthogonal to its neighbourhood's principal axis."""
    from lidar_rt_tpu_torch.data import build
    from lidar_rt_tpu_torch.ops import knn

    rng = np.random.default_rng(0)
    pts = rng.uniform(-50, 50, (40_000, 3)).astype(np.float32)
    pts[:, 2] *= 0.05
    center = torch.tensor([0.0, 0.0, 2.0])
    got = build._estimate_normals_padded(torch.tensor(pts, device=cuda_device),
                                         center.to(cuda_device)).cpu()
    padded = torch.cat([torch.tensor(pts), 1e7 + torch.arange(
        25_536, dtype=torch.float32)[:, None].expand(-1, 3)])
    cov = knn.neighbour_covariance(padded, k=6)[:40_000].double()
    cov_card = knn.neighbour_covariance(padded.to(cuda_device),
                                        k=6)[:40_000].cpu().double()
    scale = cov.abs().amax((1, 2), keepdim=True)
    assert bool(((cov_card - cov).abs() <= 1e-5 * scale + 1e-30).all())
    principal = torch.linalg.eigh(cov)[1][:, :, 2].float()
    torch.testing.assert_close(torch.linalg.vector_norm(got, dim=1),
                               torch.ones(40_000), rtol=0, atol=1e-5)
    assert bool(((center - torch.tensor(pts)) * got).sum(1).ge(0).all())
    assert float((got * principal).sum(1).abs().max()) < 1e-3


def test_cache_refused_with_exact_order():
    """The forward caches its residuals in tile order only: a cache with
    exact order is refused at the kernel boundary, by the kernels' wrappers
    and by their twins, before any launch (nothing falls back)."""
    inputs = _case(128, 0, "cpu")
    kernels.reset_launches()
    chans, _, cache = cuda_tracer.forward_tiles_reference(*inputs,
                                                          cache=True)
    for call in (
            lambda: kernels.tracer_forward(*inputs, exact=True, cache=True),
            lambda: kernels.tracer_backward(*inputs, chans, chans,
                                            exact=True, cache=cache),
            lambda: cuda_tracer.forward_tiles_reference(*inputs, exact=True,
                                                        cache=True),
            lambda: cuda_tracer.backward_tiles_reference(
                *inputs, chans, chans, exact=True, cache=cache),
            lambda: cuda_tracer.forward_tiles(inputs, exact=True,
                                              cache=True)):
        with pytest.raises(ValueError, match="tile-order"):
            call()
    assert (kernels.forward_exact_launches, kernels.backward_exact_launches,
            kernels.forward_cache_launches) == (0, 0, 0)


def test_cache_check_counts():
    """`cache_check` (the card checks' judge of the forward's cache)
    passes the twin's own encoding cut to the steps its rays reach, and
    counts a stray write, a missed step and a flipped sign."""
    inputs = _case(128, 4, "cpu")
    inputs = inputs._replace(opac=inputs.opac.clamp_min(0.9),
                             t0=inputs.t0 * 0.01)
    _, _, (cache, last) = cuda_tracer.forward_tiles_reference(*inputs,
                                                              cache=True)
    assert int(inputs.cnt[0]) == 0 and bool((last[0] == -1).all())
    f = cuda_tracer._pairs(*inputs[:8])
    live = f.live.transpose(1, 2)
    reached = torch.cat([torch.ones_like(live[:, :1]),
                         torch.cumprod(live.int(), 1)[:, :-1].bool()], 1)
    assert bool((~reached).any())            # some rays stop
    got = torch.where(reached[..., None], cache, float("nan")).to(
        torch.bfloat16)
    clean = cache_check(inputs, got)
    assert clean["written"] == int(reached.sum())
    assert (clean["stray"], clean["missed"], clean["magnitude"],
            clean["sign"]) == (0, 0, 0, 0)
    t, j, r = torch.nonzero(~reached)[0].tolist()
    bad = got.clone()
    bad[t, j, r] = cache[t, j, r]            # written past a stop
    t2, j2, r2 = torch.nonzero(reached & (cache[..., 0].float() > 0)
                               & (cache[..., 1].float() > 0))[0].tolist()
    bad[t2, j2, r2, 1] = -bad[t2, j2, r2, 1]   # the live bit flipped
    hit = torch.nonzero(reached & (cache[..., 0].float() != 0))[-1]
    bad[tuple(hit.tolist())] = float("nan")    # a composited step dropped
    counts = cache_check(inputs, bad)
    assert (counts["stray"], counts["missed"], counts["sign"]) == (1, 1, 1)


@pytest.mark.parametrize("fault", [None, "sign", "channels", "last"])
def test_check_cached_pair_passes_twins_and_catches_faults(monkeypatch,
                                                           fault):
    """`check_cached_pair` (the card checks' run of the cached pair) on
    the CPU, with the kernels stood in for by the twins: the forward
    writes the twin's encoding at the steps its rays reach into the
    caller's NaN-filled buffer.  It passes them, and raises on a flipped
    live bit, on channels a bit off the uncached forward's, or on one
    stopped ray's last index a candidate past its stop."""
    inputs = _case(128, 4, "cpu")
    inputs = inputs._replace(opac=inputs.opac.clamp_min(0.9),
                             t0=inputs.t0 * 0.01)

    def forward(*args, exact=False, cache=False, cache_out=None):
        if not cache:
            return cuda_tracer.forward_tiles_reference(*args)
        chans, accum, twin = cuda_tracer.forward_tiles_reference(*args,
                                                                 cache=True)
        live = cuda_tracer._pairs(*args[:8]).live.transpose(1, 2)
        reached = torch.cat([torch.ones_like(live[:, :1]),
                             torch.cumprod(live.int(), 1)[:, :-1].bool()], 1)
        cache_out.copy_(torch.where(reached[..., None], twin.pairs,
                                    cache_out))
        if fault == "sign":
            t, j, r = torch.nonzero(reached & (twin.pairs[..., 1] > 0))[0]
            cache_out[t, j, r, 1] = -cache_out[t, j, r, 1]
        if fault == "channels":
            chans = chans.clone()
            chans[2, 0, 0] = torch.nextafter(chans[2, 0, 0],
                                             torch.tensor(1e9))
        last = twin.last
        if fault == "last":
            t, r = torch.nonzero(last < args[0][:, None] - 1)[0]
            last = last.clone()
            last[t, r] += 1
        return chans, accum, kernels.TracerCache(cache_out, last)

    def backward(*args, exact=False, cache=None, fast=False):
        if cache is not None:           # unwritten steps: past every stop
            cache = kernels.TracerCache(cache.pairs.nan_to_num(0.0),
                                        cache.last)
        return cuda_tracer.backward_tiles_reference(*args, exact=exact,
                                                    cache=cache)

    monkeypatch.setattr(kernels, "tracer_forward", forward)
    monkeypatch.setattr(kernels, "tracer_backward", backward)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    chans, accum = cuda_tracer.forward_tiles_reference(*inputs)
    g = _upstream(chans, 128)
    lines = []
    if fault is None:
        out = check_cached_pair(inputs, chans, accum, g, "a small case",
                                lines.append)
        assert len(lines) == 4
        assert out["fwd_err"] == 0.0 and out["bwd_err"] <= 1e-6
    else:
        with pytest.raises(RuntimeError, match="a small case"):
            check_cached_pair(inputs, chans, accum, g, "a small case",
                              lines.append)
        assert lines               # reported before the check


def _poisoned_cache(inputs, fill) -> torch.Tensor:
    t, r = inputs.dirs.shape[:2]
    return torch.full(kernels.cache_shape(t, inputs.axes.shape[-1], r), fill,
                      dtype=torch.bfloat16, device=inputs.dirs.device)


def _assert_fast_bars(got, ref):
    for name, (cos, rel) in grad_errors(got, ref).items():
        assert cos >= FAST_COS and rel <= FAST_REL, (name, cos, rel)


CACHE_CASES = [pytest.param(*c, id="-".join(map(str, c)))
               for c in [(128, 8, 128, 1.0), (256, 8, 128, 1.0),
                         (512, 8, 128, 1.0), (200, 4, 48, 1.0),
                         (256, 5, 96, 1.0), (256, 8, 128, 0.05)]]


@pytest.mark.cuda
@pytest.mark.parametrize("k,tile_h,tile_w,fac", CACHE_CASES)
def test_cached_kernels_match_twins_on_card(cuda_device, k, tile_h, tile_w,
                                            fac):
    """The forward writes its cache into a NaN-filled buffer at exactly the
    steps the twin's rays reach that its box test leaves, with the twin's
    encoding, and its channels are the uncached forward's bits.  The
    backward decoding it (3xTF32) holds the twin's decode of the same
    cache, its unwritten steps filled from the twin's, at the float32
    gradient bars; with the fast sums, the twin's decode of the twin's own
    cache (their bf16 values may be an ulp apart) and the float32 replay
    at the cache bars.  Its last index is the twin's at every ray.  At
    1/20 of the opacity no ray stops and row 9 gets an upstream
    gradient."""
    inputs = _case(k, k + 2, cuda_device, tile_h, tile_w)
    inputs = inputs._replace(opac=inputs.opac * fac)
    with torch.no_grad():
        chans, accum = kernels.tracer_forward(*inputs)
        before = (kernels.forward_cache_launches, kernels.forward_launches)
        poison = _poisoned_cache(inputs, float("nan"))
        c_chans, c_accum, cache = kernels.tracer_forward(
            *inputs, cache=True, cache_out=poison)
        torch.cuda.synchronize()
        assert cache.pairs is poison
        assert (kernels.forward_cache_launches,
                kernels.forward_launches) == (before[0] + 1, before[1])
        assert torch.equal(c_chans, chans)
        torch.testing.assert_close(c_accum, accum, rtol=1e-5, atol=0.0)
        counts = cache_check(inputs, cache.pairs)
        assert counts["written"] > 0, counts
        assert (counts["stray"], counts["missed"], counts["magnitude"],
                counts["sign"]) == (0, 0, 0, 0), counts
        g = _upstream(chans, k, raw_t=fac < 1.0)
        replay = kernels.tracer_backward(*inputs, chans, g)
        before = kernels.backward_cache_launches
        exact32 = kernels.tracer_backward(*inputs, chans, g, cache=cache)
        fast = kernels.tracer_backward(*inputs, chans, g, cache=cache,
                                       fast=True)
        torch.cuda.synchronize()
        assert kernels.backward_cache_launches == before + 2
        _, _, twin_cache = cuda_tracer.forward_tiles_reference(*inputs,
                                                               cache=True)
        last = last_index_check(inputs, cache.last)
        assert last["differ"] == 0, last
        twin = cuda_tracer.backward_tiles_reference(*inputs, chans, g,
                                                    cache=twin_cache)
        same = cuda_tracer.backward_tiles_reference(
            *inputs, chans, g, cache=kernels.TracerCache(
                torch.where(cache.pairs.isnan(), twin_cache.pairs,
                            cache.pairs), cache.last))
    _assert_grad_bars(exact32, same)
    _assert_fast_bars(fast, twin)
    _assert_fast_bars(fast, replay)
    for x in fast:
        assert bool(torch.isfinite(x).all()) and bool(x[0].eq(0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "k256", "k512"])
def test_cached_backward_reads_only_written_steps_on_card(cuda_device, case):
    """The backward reads only the steps the forward wrote: the same
    forward's cache in a buffer filled with NaN (a read decodes as a stop)
    and in one filled with a live, composited pair (a read would add a
    pair) gives the same gradients.  The sums are taken with atomics in no
    fixed order, so two runs on one buffer part in the last bits: the bar
    is four times that spread or 1e-5 of the field's largest magnitude,
    where a read of the filled pair would move a candidate's sum by a
    whole pair's term.  A buffer filled with zeros would decode as a stop,
    as NaN does, and could not tell the two apart."""
    inputs = (_dense_case(cuda_device) if case == "dense"
              else _case(int(case[1:]), 9, cuda_device))
    grads = {}
    with torch.no_grad():
        chans, _ = kernels.tracer_forward(*inputs)
        g = _upstream(chans, 5)
        for fill in ("nan", 0.5):
            poison = _poisoned_cache(inputs, float(fill))
            _, _, cache = kernels.tracer_forward(*inputs, cache=True,
                                                 cache_out=poison)
            grads[fill] = [kernels.tracer_backward(
                *inputs, chans, g, cache=cache, fast=True) for _ in range(2)]
        torch.cuda.synchronize()
    for a, b, c in zip(grads["nan"][0], grads["nan"][1], grads[0.5][0]):
        spread = float((a - b).abs().max())
        bar = max(4.0 * spread, 1e-5 * float(a.abs().max()))
        assert bool(torch.isfinite(a).all())
        assert float((a - c).abs().max()) <= bar, (spread, bar)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [128, 256])
def test_exact_fast_sums_on_card(cuda_device, k):
    """The exact order's sums at one TF32 product per term against the
    twin and the 3xTF32 sums, at the cache bars."""
    inputs = _case(k, k + 3, cuda_device)
    with torch.no_grad():
        chans, _ = kernels.tracer_forward(*inputs, exact=True)
        g = _upstream(chans, k)
        before = (kernels.backward_exact_fast_launches,
                  kernels.backward_exact_launches)
        fast = kernels.tracer_backward(*inputs, chans, g, exact=True,
                                       fast=True)
        full = kernels.tracer_backward(*inputs, chans, g, exact=True)
        torch.cuda.synchronize()
        assert (kernels.backward_exact_fast_launches,
                kernels.backward_exact_launches) == (before[0] + 1,
                                                     before[1] + 1)
        twin = cuda_tracer.backward_tiles_reference(*inputs, chans, g,
                                                    exact=True)
    _assert_grad_bars(full, twin)
    _assert_fast_bars(fast, twin)
    _assert_fast_bars(fast, full)


@pytest.mark.cuda
def test_cached_training_step_on_card(cuda_device):
    """Autograd through the kernel boundary in the training modes: the
    cached forward and the decoding backward launch once each, the cache
    is allocated only under grad, and the gradients hold the float32
    replay's at the cache bars."""
    inputs = _case(256, 12, cuda_device)
    kernels.reset_launches()
    with torch.no_grad():
        cuda_tracer.forward_tiles(inputs, fast=True, cache=True)
    assert (kernels.forward_launches, kernels.forward_cache_launches) == (
        1, 0)
    got = {}
    for cache in (True, False):
        diff = [x.clone().requires_grad_(x.is_floating_point())
                for x in inputs]
        chans, _ = cuda_tracer.forward_tiles(cuda_tracer.TileInputs(*diff),
                                             fast=cache, cache=cache)
        (chans * _upstream(chans, 3)).sum().backward()
        got[cache] = [diff[i].grad for i in (4, 5, 6, 7, 9)]
    torch.cuda.synchronize()
    assert (kernels.forward_cache_launches, kernels.backward_cache_launches,
            kernels.forward_launches, kernels.backward_launches) == (
        1, 1, 2, 1)
    _assert_fast_bars(got[True], got[False])


@pytest.mark.cuda
@pytest.mark.parametrize("k", (128, 2, 896))
@pytest.mark.parametrize("level", kernel_microbench.LEVELS)
def test_ablation_probe_matches_plain_on_card(cuda_device, level, k):
    """Each level of the forward body's ablation probe against its plain
    version, at a reduced reference shape (4 tiles of 1024 rays) and with
    a ragged last block (R = 1000), at the reference's K=128 (one staged
    chunk), the least K=2 and the most K=896 (seven chunks)."""
    for r in (1024, 1000):
        inputs = kernel_microbench.make_inputs(0, 4, r, k, cuda_device)
        before = kernel_microbench.launches[level]
        got = kernel_microbench.ablation(level, inputs)
        torch.cuda.synchronize()
        assert kernel_microbench.launches[level] == before + 1
        want = kernel_microbench.ablation_reference(level, inputs)
        err, ratio = kernel_microbench.error(got, want)
        assert ratio <= 1.0, (level, k, r, err)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,lanes", ((64, 1024), (3, 1030), (512, 1024)))
@pytest.mark.parametrize("dtype,with_exp", bf16_microbench.MODES)
def test_bf16_probe_matches_plain_on_card(cuda_device, dtype, with_exp,
                                          rows, lanes):
    """Each mode of the gate body against its plain version: 64 x 1024,
    3 x 1,030 (an even count that is not a multiple of 16 bytes' worth of
    elements) and the reference's 512 x 1024."""
    a, b = bf16_microbench.make_inputs(dtype, 0, rows, lanes, cuda_device)
    name = bf16_microbench.mode_name(dtype, with_exp)
    before = bf16_microbench.launches[name]
    got = bf16_microbench.probe(a, b, with_exp)
    torch.cuda.synchronize()
    assert bf16_microbench.launches[name] == before + 1
    want = bf16_microbench.probe_reference(a, b, with_exp)
    err, ratio = bf16_microbench.error(got, want)
    assert got.dtype == a.dtype and ratio <= 1.0, (name, err, ratio)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,with_exp", bf16_microbench.MODES)
def test_bf16_probe_takes_unaligned_arrays_on_card(cuda_device, dtype,
                                                   with_exp):
    """Arrays that start 4 or 8 bytes past a 16-byte boundary (one pair
    into a buffer), as a slice of a larger tensor gives them."""
    a, b = (x.reshape(-1)[2:] for x in bf16_microbench.make_inputs(
        dtype, 0, 8, 130, cuda_device))
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    got = bf16_microbench.probe(a, b, with_exp)
    torch.cuda.synchronize()
    want = bf16_microbench.probe_reference(a, b, with_exp)
    err, ratio = bf16_microbench.error(got, want)
    assert got.dtype == a.dtype and ratio <= 1.0, (dtype, err, ratio)
