"""The hier binner's macro-column level (`TileConfig.macro_cols`) held to
`lidar_rt_tpu.ops.binning` on the same numpy inputs: index, valid and
truncated bit for bit, with the level on and off (either side of the
`macro_factor * K_c < N` gate), with and without int_overlap, with macro
truncation, with a tile count that g does not divide, in a column band,
under the `min_range` floors of a tail chain and with tied ranges.  Then
the reference's two properties in the port alone
(`tests/test_tracer.py`): with no macro truncation the lists are plain
hier's, and a macro truncation is counted.  Last, the CLI reads
`macro_cols` from a `tracer:` block as the reference's does."""

import numpy as np
import pytest
import torch

from test_torch_binning import (H, W, _assert_same, _both, _grids, _pose,
                                _scene, f32)

from lidar_rt_tpu.core import transforms as j_tf
from lidar_rt_tpu.ops import binning as j_bin
from lidar_rt_tpu_torch.ops import binning as t_bin
from lidar_rt_tpu_torch.ops import tracer as t_tracer
from lidar_rt_tpu_torch.ops.composite import SurfelBundle as TBundle

torch.set_num_threads(1)

N = 300
# K = 16, coarse_factor 2: K_c = 32, K_a = 32 x macro_factor.
BASE = dict(binner="hier", tile_h=8, tile_w=64, max_per_tile=16,
            coarse_factor=2)
CASES = {
    # 4 tile columns, sectors of g = 2: K_a = 96 < N, every sector
    # truncates.
    "on": dict(macro_cols=128, macro_factor=3),
    "on, one per sector": dict(macro_cols=128, macro_factor=1),
    "on, float overlap": dict(macro_cols=128, macro_factor=3,
                              int_overlap=False),
    # K_a = 320 >= N: the gate leaves the level off.
    "off by the gate": dict(macro_cols=128, macro_factor=10),
    # K_a = 288 < N: on, and no sector holds more than K_a.
    "on, no macro truncation": dict(macro_cols=128, macro_factor=9),
    # g = 3 over 4 tile columns: the last sector is a single column.
    "g does not divide tiles_x": dict(macro_cols=192, macro_factor=2),
    "macro_cols <= tile_w": dict(macro_cols=64, macro_factor=2),
    "topk ignores it": dict(binner="topk", macro_cols=128, macro_factor=2),
    "sort ignores it": dict(binner="sort", macro_cols=128, macro_factor=2),
}


def _cfg(**extra):
    return {**BASE, **extra}


def _tied(n, seed):
    """`_scene` with every other surfel at its neighbour's center: their
    ranges tie exactly, their footprints differ."""
    s = _scene(n, seed)
    s["means"][1::2] = s["means"][0::2]
    return s


@pytest.mark.parametrize("case,scene", [(c, "distinct") for c in CASES]
                         + [("on", "tied"), ("on, float overlap", "tied")])
def test_matches_reference(case, scene):
    s = (_scene if scene == "distinct" else _tied)(N, seed=31)
    ja, ta = _both(s, _pose(31), True, **_cfg(**CASES[case]))
    _assert_same(ja, ta)
    assert ta.valid.any()


@pytest.mark.parametrize("col_offset,num_cols", [(200, 192)])
def test_column_band_matches_reference(col_offset, num_cols):
    """A band's tile columns, the second across the azimuth seam."""
    s = _scene(N, seed=32)
    pose = _pose(32)
    w2s = np.asarray(j_tf.invert_se3(pose))
    jg, tg = _grids()
    cfg = _cfg(macro_cols=128, macro_factor=2)
    ja = j_bin.bin_surfels(jg, W, w2s, s["means"], s["scales"],
                           s["opacities"], j_bin.TileConfig(**cfg),
                           rotations=s["rotations"], col_offset=col_offset,
                           num_cols=num_cols)
    ta = t_bin.bin_surfels(
        tg, W, torch.tensor(w2s), torch.tensor(s["means"]),
        torch.tensor(s["scales"]), torch.tensor(s["opacities"]),
        t_bin.TileConfig(**cfg), rotations=torch.tensor(s["rotations"]),
        col_offset=col_offset, num_cols=num_cols)
    _assert_same(ja, ta)
    assert ta.valid.any()


@pytest.mark.parametrize("int_overlap", [True, False])
def test_tail_chain_matches_reference(int_overlap):
    """`bin_tail_chain` with the macro level on (g = 3 over 4 tile
    columns, so the macro minimum pads with +inf): each pass equals the
    reference's binner at the same cut.  The port's floors are its K-th
    candidates' ranges in its own arithmetic; the two packages' float32
    ranges of one surfel may part by an ulp, so the reference is given
    the same candidates' ranges in its arithmetic (its footprint bounds,
    the ranges its binner compares)."""
    s = _scene(N, seed=33)
    sh = np.zeros((N, 16, 3), np.float32)
    w2s = np.asarray(j_tf.invert_se3(_pose(33)))
    jg, tg = _grids()
    kw = _cfg(macro_cols=192, macro_factor=2, int_overlap=int_overlap)
    chain = t_tracer.bin_tail_chain(
        TBundle(**{k: torch.tensor(v) for k, v in s.items()},
                sh=torch.tensor(sh)),
        tg, W, torch.tensor(w2s), t_bin.TileConfig(**kw), 2)
    j_rng = np.asarray(j_bin.footprint_bounds(
        jg, W, w2s, s["means"], s["scales"], s["opacities"],
        j_bin.TileConfig(**kw), s["rotations"])[4])
    floor = None
    for ta in chain:
        ja = j_bin.bin_surfels(jg, W, w2s, s["means"], s["scales"],
                               s["opacities"], j_bin.TileConfig(**kw),
                               rotations=s["rotations"], min_range=floor)
        _assert_same(ja, ta)
        valid, index = ta.valid.numpy(), ta.index.numpy().clip(0, N - 1)
        cut = np.where(ta.truncated.numpy() > 0,
                       np.where(valid, j_rng[index], -np.inf).max(-1),
                       np.inf).astype(np.float32)
        floor = cut if floor is None else np.maximum(cut, floor)
    assert chain[2].valid.any() and int(chain[0].truncated.sum()) > 0


def _port(s, pose, **cfg):
    _, tg = _grids()
    return t_bin.bin_surfels(
        tg, W, torch.linalg.inv(torch.tensor(pose)),
        torch.tensor(s["means"]), torch.tensor(s["scales"]),
        torch.tensor(s["opacities"]), t_bin.TileConfig(**cfg),
        rotations=torch.tensor(s["rotations"]))


def _ring(n, seed):
    """Surfels on an azimuth ring 8-15 m out: each of two macro sectors
    holds about half of them (the reference's property scene)."""
    rng = np.random.default_rng(seed)
    s = _scene(n, seed)
    ang = rng.uniform(-np.pi, np.pi, n)
    rad = rng.uniform(8.0, 15.0, n)
    s["means"] = f32(np.stack([rad * np.cos(ang), rad * np.sin(ang),
                               rng.uniform(0.0, 3.0, n)], -1))
    return s


@pytest.mark.parametrize("seed", [0, 4])
def test_no_macro_truncation_is_plain_hier(seed):
    """K_a = 96 < N = 120 keeps the level on; no sector overlaps more
    than K_a, so every list is plain hier's (the macro margin telescopes:
    a footprint meeting a tile column meets its parent sector)."""
    s = _ring(120, seed)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 2.0
    plain = _port(s, pose, **BASE)
    macro = _port(s, pose, **BASE, macro_cols=128, macro_factor=3)
    for a, b in zip(plain, macro):
        assert torch.equal(a, b)
    assert plain.valid.any()


def test_macro_truncation_counted():
    s = _ring(120, 2)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 2.0
    cfg = dict(BASE, max_per_tile=8, macro_cols=128, macro_factor=1)
    a = _port(s, pose, **cfg)
    plain = _port(s, pose, **dict(cfg, macro_cols=0))
    assert int(a.truncated.sum()) > int(plain.truncated.sum())
    assert int(a.valid.sum(1).max()) <= 8


def test_cli_reads_macro_cols(tmp_path):
    """A `tracer:` block's `macro_cols` reaches the port's TileConfig (and
    the warm-up budget's) as `lidar_rt_tpu/cli.py` reads it; no key sets
    macro_factor there, so it keeps its default."""
    from lidar_rt_tpu import cli as j_cli
    from lidar_rt_tpu import config as j_config
    from lidar_rt_tpu_torch import cli as t_cli
    from lidar_rt_tpu_torch import config as t_config
    from lidar_rt_tpu_torch.train import options

    ec = tmp_path / "exp.yaml"
    ec.write_text("parent_config: configs/rehearsal/exp.yaml\n"
                  "tracer:\n  macro_cols: 256\n")
    cfg, warm, _ = t_cli.trace_configs(t_config.parse(str(ec)), "cpu")
    ref = j_cli._trace_cfg(j_config.parse(str(ec)))[0].tile
    assert cfg.tile.macro_cols == warm.tile.macro_cols == ref.macro_cols \
        == 256
    assert cfg.tile.macro_factor == ref.macro_factor == 4
    assert "macro_cols" not in options.TPU_ONLY


def test_exact_macro_probe_holds_plain_hiers_lists():
    """`profile_binner.exact_macro`, which phase 21 of chip_smoke.py runs
    at the full scan, on the street soup at 16 x 2650 with 32,768
    surfels: a macro_factor whose sectors truncate nothing, and there the
    lists of plain hier."""
    from lidar_rt_tpu_torch.scripts import profile_binner, street

    grid, s2w = street.sensor(16, "cpu")
    ex = profile_binner.exact_macro(street.street_scene_bundle(32768, 0,
                                                               "cpu"),
                                    grid, street.W, s2w, "cpu", iters=1)
    assert ex["equal"] and ex["factor"] * 2048 < ex["surfels"]
