"""The port's binning and compositing design probes (`scripts.survivor_stats`,
`overcount_probe`, `subtile_demand`, `occlusion_stats`,
`selection_probe`) against the reference's scripts of the same names, on
the CPU at a small size: the bench's street soup of 8,192 surfels scanned
at 16 x 512 (8 flagship tiles, 16 tiles of 16 x 32).

The reference's scripts are run as `_torch_probes.reference_probe` runs
them (compiled from their files with `ast`, a stub `bench` of this size)
and their printed lines are held to the lines the port's functions'
dicts give, to the printed digit: every count, histogram percentile and
share here is equal in both packages (the gate's depth ties, which the
binner and the depth order would break by slot, do not occur on this
soup).  `selection_probe`'s weight captures are held to the
reference's own arrays, taken before its printing, within 1e-5, its
per-ray depth errors end to end at DEPTH_BAR and, on the reference's own
frames, gate and compositing arithmetic, within 1e-5 (its selection).

The occlusion probe needs rays that latch (transmittance below T_MIN).
On the soup none does at any size a CPU test can run (a tile's K=256
truncates before T falls that low; the reference's percentile of no
latched rays then raises), so its test adds a two-layer wall of opaque
surfels 4 m ahead, scans it at 8 x 2560 (128-column tiles of the bench's
width) and lists K=1024 a tile, where a fifth of the tiles latch.
"""

import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_rt_tpu.ops.binning import TileConfig as JTileConfig
from lidar_rt_tpu.ops.composite import SurfelBundle as JSurfelBundle
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import (occlusion_stats, overcount_probe,
                                        selection_probe, street,
                                        subtile_demand, survivor_stats)
from _torch_probes import numbers, reference_probe

torch.set_num_threads(1)

H, W, N = 16, 512, 8192
# Per-ray depth errors, metres, end to end: each package's own float32
# gate (measured 3.3e-3 at most; see test_selection_probe_is_the_references).
DEPTH_BAR = 6e-3
SELECTION_BAR = 1e-5          # the issue's bar, on the same pair arithmetic


def _printed(out: str, drop=("computed in", "latch pass")) -> list[str]:
    """The reference's printed lines, stripped, less its timing lines."""
    return [ln.strip() for ln in out.splitlines()
            if ln.strip() and not ln.strip().startswith(drop)]


def _stripped(lines: list[str]) -> list[str]:
    return [ln.strip() for ln in lines]


@pytest.fixture(scope="module")
def scene():
    grid, s2w = street.sensor(H, "cpu")
    return street.street_scene_bundle(N, 0, "cpu"), grid, s2w


def test_survivor_stats_is_the_references(scene):
    bundle, grid, s2w = scene
    s = survivor_stats.stats(bundle, grid, W, s2w, survivor_stats.TILE,
                             "cpu")
    want = _printed(reference_probe("survivor_stats.py", H, W, N))
    assert _stripped(survivor_stats.lines(s)) == want
    # Every ray of the 8 tiles counted once; the histograms hold K + 1
    # bins.
    assert s["n_alpha"].sum() == H * W and len(s["n_alpha"]) == 257
    assert s["tiles_snap_on"].sum() < s["tiles_snap_off"].sum()


def test_overcount_probe_is_the_references(scene):
    bundle, grid, s2w = scene
    got = []
    for th, tw, k in overcount_probe.SHAPES:
        tile = overcount_probe.tile_config(th, tw, k)
        c = overcount_probe.probe(bundle, grid, W, s2w, tile, "cpu")
        assert c["truncated"] == 0 and c["gate_not_int"] == 0
        assert 0 < c["gate"] < c["int"] <= c["binned"]
        got += overcount_probe.lines(th, tw, k, N, (H // th) * (W // tw), c)
    out = reference_probe("overcount_probe.py", H, W, N)
    # The reference's header also prints its seconds.
    assert _stripped(got) == [re.sub(r", \d+s\)$", ")", ln)
                              for ln in _printed(out)]


@pytest.mark.parametrize("th, tw, k", overcount_probe.SHAPES)
def test_overcount_probe_topk_lists_the_hier_pairs(scene, th, tw, k):
    """The probe's untruncated reading: where neither binner truncates,
    the topk binner gives the hier binner's counts, and at a K cut below
    the most a tile overlaps, `untruncated_k` (from the truncating hier
    counts) gives a K at which topk truncates nothing and lists them
    all again."""
    bundle, grid, s2w = scene
    hier, topk = (overcount_probe.probe(
        bundle, grid, W, s2w, overcount_probe.tile_config(th, tw, k, b),
        "cpu") for b in ("hier", "topk"))
    assert hier["truncated"] == topk["truncated"] == 0
    assert hier == topk
    assert overcount_probe.untruncated_k(k, hier) == k
    t_total = (H // th) * (W // tw)
    got = overcount_probe.lines(th, tw, k, N, t_total, topk, "topk")
    want = overcount_probe.lines(th, tw, k, N, t_total, hier)
    assert got[0] == (f"--- tile {th}x{tw} K={k} topk binner, every "
                      f"candidate (N={N}, {t_total} tiles)")
    assert got[1:] == want[1:]
    cut = overcount_probe.probe(
        bundle, grid, W, s2w,
        overcount_probe.tile_config(th, tw, 128, "hier"), "cpu")
    assert cut["truncated"] > 0
    k_all = overcount_probe.untruncated_k(128, cut)
    assert 128 < k_all <= k
    again = overcount_probe.probe(
        bundle, grid, W, s2w,
        overcount_probe.tile_config(th, tw, k_all, "topk"), "cpu")
    assert again["truncated"] == 0
    assert again["binned"] == hier["binned"]


def test_subtile_demand_is_the_references(scene):
    bundle, grid, s2w = scene
    hists = subtile_demand.demand(bundle, grid, W, s2w, subtile_demand.TILE,
                                  "cpu")
    assert list(hists) == subtile_demand.SHAPES
    for (h2, w2), h in hists.items():
        assert h.sum() == (H // h2) * (W // w2)
    want = _printed(reference_probe("subtile_demand.py", H, W, N))
    assert _stripped(subtile_demand.lines(hists)) == want


def _walled_soup(n: int, seed: int = 0) -> dict[str, np.ndarray]:
    """The street soup and a two-layer wall of opaque surfels 4 m ahead
    (x = 4.0 and 4.2 m, |y| < 6 m, 0.5 < z < 2.5 m, 0.1 m apart)."""
    soup = street.street_soup(n, seed)
    rng = np.random.default_rng(seed + 1)
    xx, yy, zz = np.meshgrid([4.0, 4.2], np.arange(-6, 6, 0.1),
                             np.arange(0.5, 2.5, 0.1))
    m = xx.size
    wall = {
        "means": np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
        + rng.normal(0, 0.02, (m, 3)),
        "rotations": np.tile([np.sqrt(0.5), 0.0, np.sqrt(0.5), 0.0], (m, 1))
        + rng.normal(0, 0.02, (m, 4)),
        "scales": rng.uniform(0.15, 0.2, (m, 2)),
        "opacities": rng.uniform(0.8, 0.95, m),
        "sh": np.zeros((m, 16, 3))}
    return {k: np.concatenate([soup[k], wall[k].astype(np.float32)])
            for k in soup}


def test_occlusion_stats_is_the_references():
    h, w, n = 8, 2560, 16384
    arrays = _walled_soup(n)
    bundle = SurfelBundle(*(torch.as_tensor(arrays[f])
                            for f in SurfelBundle._fields))
    grid, s2w = street.sensor(h, "cpu")
    tile = TileConfig(tile_h=8, tile_w=128, max_per_tile=1024,
                      binner="hier")
    s = occlusion_stats.stats(bundle, grid, w, s2w, tile, "cpu")
    assert 0.0 < s["finite"] < 1.0
    assert all(b["post"].sum() < b["pre"].sum()
               for b in s["binned"].values())
    out = reference_probe(
        "occlusion_stats.py", h, w, n,
        scene=lambda n_, seed=0: JSurfelBundle(
            **{f: jnp.asarray(v) for f, v in _walled_soup(n_, seed).items()}),
        TILE=JTileConfig(tile_h=8, tile_w=128, max_per_tile=1024,
                         binner="hier", approx_topk=True))
    assert _stripped(occlusion_stats.lines(s)) == _printed(out)


def test_occlusion_stats_without_a_latched_ray(scene):
    """The soup alone latches no ray: the port says so where the
    reference's percentile of nothing raises."""
    bundle, grid, s2w = scene
    s = occlusion_stats.stats(bundle, grid, W, s2w, occlusion_stats.TILE,
                              "cpu")
    lines = occlusion_stats.lines(s)
    assert lines[0] == ("saturated rays: 0.000  latch depth: no ray "
                        "reaches T_MIN")
    assert s["finite"] == 0.0
    assert (s["demand_post"] == s["demand_pre"]).all()


def _recording_numpy(arrays: list):
    """numpy with `asarray` recording what it returns."""
    def asarray(*args, **kw):
        a = np.asarray(*args, **kw)
        arrays.append(a)
        return a

    return types.SimpleNamespace(**{**{k: getattr(np, k) for k in dir(np)
                                       if not k.startswith("__")},
                                    "asarray": asarray})


@pytest.fixture(scope="module")
def reference_selection():
    """The reference's selection_probe at this size: its stdout and the
    arrays it converts (per rule: depth errors, their mask, weight
    captures)."""
    arrays = []
    out = reference_probe("selection_probe.py", H, W, N,
                          np=_recording_numpy(arrays))
    # Per rule the reference converts its depth errors, their mask and
    # its weight captures, in that order.
    assert len(arrays) == 3 * len(selection_probe.RULES)
    return out, arrays


def _reference_pair_math(n: int):
    """The reference's float32 pair arithmetic, run by XLA as its
    `scripts/selection_probe.py` runs it: the frames and rays
    (`build_frames`, `to_rotation_matrix`, `range_rays` under jit, as its
    `run`), the per-tile gate (its `tile_fn`, :127-147) and the
    compositing (its `composite`, :113-122).  Returns (frames, tiled
    rays, gate, composite) in the port's types, to stand in for
    `street.tile_rays`, `street.tile_gate` and `selection_probe._composite`."""
    import jax

    from lidar_rt_tpu.core import quaternions as j_quat
    from lidar_rt_tpu.core import rays as j_rays
    from lidar_rt_tpu.ops import geometry as j_geom
    from lidar_rt_tpu_torch.ops import cuda_tracer, geometry
    from _torch_probes import reference_bench

    jb = reference_bench().street_scene_bundle(n)
    j_grid = j_rays.SensorGrid.from_bounds(H, (-0.31, 0.04),
                                           pixel_offset=0.5)

    @jax.jit
    def frames_and_rays(b):
        origin, dirs = j_rays.range_rays(j_grid, W,
                                         jnp.eye(4).at[2, 3].set(2.0))
        return j_geom.build_frames(
            b.means, j_quat.to_rotation_matrix(b.rotations), origin), dirs

    fr, dirs = frames_and_rays(jb)

    @jax.jit
    @jax.vmap
    def gate(dirs_tile, idx, valid):
        hp = jax.lax.Precision.HIGHEST
        axes = jnp.stack([fr.n[idx], fr.w1[idx], fr.w2[idx]], axis=0)
        prods = jnp.einsum("rc,akc->ark", dirs_tile, axes, precision=hp)
        qd, b_u, b_v = prods[0], prods[1], prods[2]
        safe_qd = jnp.where(jnp.abs(qd) > j_geom.DENOM_EPS, qd,
                            j_geom.DENOM_EPS)
        p = fr.p[idx]
        t = p[None, :] / safe_qd
        scales_k = jb.scales[idx]
        u = (fr.a_u[idx][None, :] + t * b_u) / scales_k[None, :, 0]
        v = (fr.a_v[idx][None, :] + t * b_v) / scales_k[None, :, 1]
        g = jnp.exp(-0.5 * (u * u + v * v))
        alpha_raw = jnp.minimum(j_geom.ALPHA_MAX,
                                jb.opacities[idx][None, :] * g)
        ok = ((t >= j_geom.DEPTH_MIN)
              & (jnp.abs(qd) > j_geom.DENOM_EPS)
              & (p[None, :] != 0.0)
              & (alpha_raw >= j_geom.ALPHA_MIN)
              & valid[None, :])
        return ok, alpha_raw, t

    @jax.jit
    @jax.vmap
    def composite(alpha, t, sel):
        a = jnp.where(sel[None, :], alpha, 0.0)
        one_m = 1.0 - a
        t_excl = jnp.cumprod(one_m, axis=1) / one_m
        live = (t_excl * one_m >= j_geom.T_MIN)
        w = a * t_excl * live
        return (jnp.sum(w * t, axis=1), jnp.sum(w, axis=1))

    def port(*xs):
        return tuple(torch.as_tensor(np.array(x)) for x in xs)

    frames = geometry.SurfelFrames(*port(*fr))
    dirs_t = cuda_tracer.to_tiles(port(dirs)[0], selection_probe.TILE)
    return (frames, dirs_t,
            lambda frames_, bundle_, d, idx, valid: port(*gate(
                d.numpy(), idx.numpy(), valid.numpy())),
            lambda alpha, t, sel: port(*composite(
                alpha.numpy(), t.numpy(), sel.numpy())))


def test_selection_probe_selects_as_the_reference(scene, reference_selection,
                                                  monkeypatch):
    """The witness for DEPTH_BAR.  On the reference's own frames and rays
    the port's gate takes exactly the reference's pairs (its `ok` equals
    the reference's everywhere) while its t and alpha part from the
    reference's in the last bits (t = p / qd at grazing incidence
    amplifies the dot products' rounding order); and on the reference's
    frames, gate and compositing arithmetic, the port's selection (binning,
    integer-sample test, each rule's K=128 cut) gives the reference's
    per-ray depth errors and weight captures within 1e-5."""
    from lidar_rt_tpu_torch.core import transforms
    from lidar_rt_tpu_torch.ops.binning import bin_surfels

    bundle, grid, s2w = scene
    frames, dirs_t, gate, composite = _reference_pair_math(N)
    tile = selection_probe.TILE
    asn = bin_surfels(grid, W, transforms.invert_se3(s2w), bundle.means,
                      bundle.scales, bundle.opacities, tile,
                      rotations=bundle.rotations)
    idx = asn.index.clamp(0, N - 1)
    ok, alpha, t = street.tile_gate(frames, bundle, dirs_t, idx, asn.valid)
    ok_r, alpha_r, t_r = gate(frames, bundle, dirs_t, idx, asn.valid)
    assert ok.any() and torch.equal(ok, ok_r)
    assert (alpha != alpha_r).any() and (t[ok] != t_r[ok]).any()

    monkeypatch.setattr(street, "tile_rays", lambda *a: (frames, dirs_t))
    monkeypatch.setattr(street, "tile_gate", gate)
    monkeypatch.setattr(selection_probe, "_composite", composite)
    r = selection_probe.probe(bundle, grid, W, s2w, tile, "cpu")
    _, arrays = reference_selection
    for i, rule in enumerate(selection_probe.RULES):
        derr, m, wcap = (a.reshape(-1) for a in arrays[3 * i:3 * i + 3])
        np.testing.assert_allclose(r["derr"][rule], derr[m], rtol=0,
                                   atol=SELECTION_BAR, err_msg=rule)
        np.testing.assert_allclose(r["wcap"][rule], wcap, rtol=0,
                                   atol=SELECTION_BAR, err_msg=rule)


def test_selection_probe_is_the_references(scene, reference_selection):
    """Weight captures per tile within 1e-5 of the reference's own arrays;
    depth errors per ray within DEPTH_BAR and their mean within 1e-5
    relative.  Each package computes its pairs in its own float32: the
    frames differ in the last bit (XLA rounds the rotation matrix and the
    plane offsets with fused multiply-adds) and so do the gate's dot
    products, and t = p / qd at grazing incidence amplifies both, so a
    pair's t and alpha part by up to ~4e-5 and a ray's depth error, a
    difference of two weighted depths of up to 60 m, by up to 3.3e-3 m
    (measured; 1e-4 at the 90th percentile, the mean 6e-6 apart on 8.6 m;
    4.9e-4 on the reference's frames, 0 on its frames, gate and
    compositing: test_selection_probe_selects_as_the_reference)."""
    bundle, grid, s2w = scene
    r = selection_probe.probe(bundle, grid, W, s2w, selection_probe.TILE,
                              "cpu")
    out, arrays = reference_selection
    for i, rule in enumerate(selection_probe.RULES):
        derr, m, wcap = (a.reshape(-1) for a in arrays[3 * i:3 * i + 3])
        np.testing.assert_allclose(r["wcap"][rule], wcap, rtol=0, atol=1e-5,
                                   err_msg=rule)
        got = r["derr"][rule]
        assert got.shape == derr[m].shape
        np.testing.assert_allclose(got, derr[m], rtol=0, atol=DEPTH_BAR,
                                   err_msg=rule)
        np.testing.assert_allclose(got.mean(dtype=np.float64),
                                   derr[m].mean(dtype=np.float64), rtol=1e-5,
                                   err_msg=rule)
    want = _printed(out)
    got = selection_probe.lines(r, N)
    assert got[0] == re.sub(r" \(\d+s, truth", " (truth", want[0])
    for g, w_ in zip(got[1:], want[1:]):
        assert g.split(":")[0] == w_.split(":")[0]
        # mean, p90, p99, max of the depth errors; weight capture mean, min.
        gn, wn = numbers(g), numbers(w_)
        np.testing.assert_allclose(gn[:4], wn[:4], rtol=0, atol=DEPTH_BAR)
        np.testing.assert_allclose(gn[4:], wn[4:], rtol=0, atol=1e-4 + 1e-5)
    # The oracle C captures at least what the binner's cut A does.
    assert r["wcap"]["C gate-oracle"].mean() >= \
        r["wcap"]["A nearest-binned"].mean()
