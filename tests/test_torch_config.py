"""The port's yaml-free config reader (`lidar_rt_tpu_torch.config`) against
the reference's `lidar_rt_tpu.config` (which reads with `yaml.safe_load`):
every file under configs/, the merge precedence, the chain errors, PyYAML's
YAML 1.1 scalars, and the refusal of what the reader does not read.
Values are compared exactly (==, NaN to NaN)."""

import glob
import math
import os

import pytest
import torch
import yaml

from lidar_rt_tpu import config as ref_config
from lidar_rt_tpu_torch import config
from lidar_rt_tpu_torch.train import options

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))


@pytest.fixture
def at_repo(monkeypatch):
    monkeypatch.chdir(REPO)


def _same(a, b) -> bool:
    """Equal values of equal types, NaN equal to NaN."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def test_every_config_file_is_found():
    assert len(CONFIGS) == 37


@pytest.mark.parametrize("path", CONFIGS)
def test_config_file_matches_yaml(path, at_repo):
    """The file alone (as yaml.safe_load reads it) and its resolved
    parent chain (as the reference's load_config_dict resolves it)."""
    with open(path) as f:
        text = f.read()
    assert _same(config.load_yaml(text, path), yaml.safe_load(text) or {})
    assert _same(config.load_config_dict(path),
                 ref_config.load_config_dict(path))


@pytest.mark.parametrize("path", [p for p in CONFIGS
                                  if "/waymo/" in p or "/kitti360/" in p
                                  or "/rehearsal/" in p])
def test_parse_over_experiment_matches(path, at_repo):
    """The CLI's merge: parse(data, parse(exp)), the experiment config's
    values winning, for each data config over configs/exp.yaml and the
    rehearsal's experiment config."""
    for exp in ("configs/exp.yaml", "configs/rehearsal/exp.yaml"):
        got = config.parse(path, config.parse(exp)).to_dict()
        want = ref_config.parse(path, ref_config.parse(exp)).to_dict()
        assert _same(got, want), (path, exp)


def test_experiment_config_wins_over_data_chain(tmp_path):
    parent = tmp_path / "parent.yaml"
    parent.write_text("model:\n  voxel_size: 0.15\n  obj_pt_num: 10000\n")
    data = tmp_path / "data.yaml"
    data.write_text(f"parent_config: \"{parent}\"\n"
                    "source_dir: /data/x\nscene_id: s1\n")
    exp = tmp_path / "exp.yaml"
    exp.write_text("model:\n  voxel_size: 0.35\ntask_name: t\n")
    args = config.parse(str(data), config.parse(str(exp)))
    assert args.model.voxel_size == 0.35
    assert args.model.obj_pt_num == 10000
    assert args.source_dir == "/data/x"
    assert _same(args.to_dict(), ref_config.parse(
        str(data), ref_config.parse(str(exp))).to_dict())


def test_parent_config_resolution_and_errors(tmp_path, monkeypatch):
    """Relative to the file, then each ancestor, then the CWD; a cycle and
    a missing parent raise as the reference's do."""
    (tmp_path / "a" / "b").mkdir(parents=True)
    (tmp_path / "base.yaml").write_text("x: 1\ny: [1, 2]\n")
    child = tmp_path / "a" / "b" / "child.yaml"
    child.write_text("parent_config: base.yaml\ny: 3\n")
    assert config.load_config_dict(str(child)) == {"x": 1, "y": 3}
    (tmp_path / "cwd").mkdir()
    (tmp_path / "cwd" / "only_here.yaml").write_text("z: on\n")
    child.write_text("parent_config: only_here.yaml\n")
    monkeypatch.chdir(tmp_path / "cwd")
    assert config.load_config_dict(str(child)) == {"z": True}

    one, two = tmp_path / "one.yaml", tmp_path / "two.yaml"
    one.write_text(f"parent_config: {two}\n")
    two.write_text(f"parent_config: {one}\n")
    for lib in (config, ref_config):
        with pytest.raises(ValueError, match="cycle"):
            lib.load_config_dict(str(one))
    one.write_text("parent_config: nowhere/missing.yaml\n")
    for lib in (config, ref_config):
        with pytest.raises(FileNotFoundError, match="missing.yaml"):
            lib.load_config_dict(str(one))


SCALARS = [
    "1e-3", "1.0e-3", "1.0e3", "1.0E+5", "6.5e+03", ".5", "1.", "0.0002",
    "0.0000016", "30_000", "1_0.5", "010", "08", "0x1F", "0b101", "1:30",
    "1:30.5", "-1", "+1", "-0", "0", ".inf", "-.inf", ".NaN", "inf",
    "yes", "Yes", "NO", "on", "Off", "true", "True", "FALSE", "y", "Y",
    "~", "null", "Null", "NULL", "none", "it's", "b#c", "a b c", "x:y",
    "0o17", "1e5",
]


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_11_scalars(text):
    """Plain scalars resolve as PyYAML's SafeLoader resolves them."""
    doc = f"k: {text}\n"
    assert _same(config.load_yaml(doc), yaml.safe_load(doc))


def test_pyyaml_quirks():
    got = config.load_yaml("a: 1e-3\nb: yes\nc: 30_000\nd: on\ne: ~\n")
    assert got == {"a": "1e-3", "b": True, "c": 30000, "d": True,
                   "e": None}


DOCS = [
    "a:\n",
    "a: ''\nb: \"\"\n",
    "a: 'x' # c\nb: \"q\\\"x\"\nc: 'it''s'\n",
    "a: [1, 'b', c d]\nb: [1, [2, 3], []]\nc: [a, b, ]\n",
    "yes: 1\n1: a\n'yes': 2\n",
    "a:   # a comment\n  b: 1\n  c:\n    d: 2\n  e: 3\nf: 4\n",
    "# head\n\na: 1 # c\n   # indented comment\nb: [x] # c\n",
    "a: true\na: false\n",
    "key with space: v\n\"quoted: key\": 1\n",
    "a: ['#', \" a \"]\n",
    "",
]


@pytest.mark.parametrize("doc", DOCS)
def test_documents_match_yaml(doc):
    assert _same(config.load_yaml(doc), yaml.safe_load(doc) or {})


REFUSED = [
    "a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n  x\n", "a: >\n  x\n",
    "- a\n", "a:\n  - b\n", "---\na: 1\n", "a: {b: 1}\n", "a:\t1\n",
    "\ta: 1\n", "a: 2001-12-14\n", "a: [1,\n 2]\n", "a: b: c\n", "a: \"x\n",
    "a: =\n", "<<: 1\n", "a: 1\n  b: 2\n", "a: [a: b]\n",
    "%YAML 1.1\na: 1\n", "a: @x\n", "a: `x\n", "a:\n    b: 1\n  c: 2\n",
    "just a scalar\n",
]


@pytest.mark.parametrize("doc", REFUSED)
def test_outside_the_subset_raises_with_file_and_line(doc):
    with pytest.raises(config.ConfigError, match=r"^cfg\.yaml:\d+: "):
        config.load_yaml(doc, "cfg.yaml")


def test_anchor_names_its_line(tmp_path):
    path = tmp_path / "anchored.yaml"
    path.write_text("a: 1\nb: &anchor 2\n")
    with pytest.raises(config.ConfigError,
                       match=r"anchored\.yaml:2: a value starting with '&'"):
        config.load_config_dict(str(path))


def test_args_view_and_default_experiment():
    args = config.Args({"opt": {"lr": 0.1}, "seed": 1})
    assert args.opt.lr == 0.1 and args["seed"] == 1 and "opt" in args
    assert args.get("missing", 7) == 7
    with pytest.raises(AttributeError, match="no key"):
        args.nothing
    assert _same(config.default_experiment().to_dict(),
                 ref_config.default_experiment().to_dict())


@pytest.mark.parametrize("fork,key,value", [
    ("full_nodensify8k", "densify_until_iter", 8000),
    ("full_noreset8k", "opacity_reset_interval", 8000)])
@pytest.mark.parametrize("data", ["waymo", "kitti"])
def test_fork_configs_resolve_alike(fork, key, value, data, at_repo):
    """The two forks of configs/rehearsal/full.yaml at 8,000 steps, over
    each rehearsal data config: both readers give the same values, and
    each differs from full.yaml in its one `opt` key."""
    dc, ec = f"configs/rehearsal/{data}.yaml", f"configs/rehearsal/{fork}.yaml"
    got = config.parse(dc, config.parse(ec)).to_dict()
    assert _same(got, ref_config.parse(dc, ref_config.parse(ec)).to_dict())
    full = config.parse(dc, config.parse("configs/rehearsal/full.yaml"))
    full = full.to_dict()
    assert got["opt"].pop(key) == value
    assert got["opt"] == {k: v for k, v in full["opt"].items() if k != key}
    del full["opt"], got["opt"]
    assert _same(got, full)


@pytest.mark.parametrize("path", ["configs/exp.yaml",
                                  "configs/rehearsal/exp.yaml",
                                  "configs/rehearsal/waymo_16x32.yaml"])
def test_trace_configs_from_files(path, at_repo):
    """The tracer block read from the files gives the budgets the
    reference's `_trace_cfg` gives (K, tiles, binner, order, tail passes,
    warm-up), with a missing block falling back to the flagship.  On a
    CUDA device the training modes (fast_math, cache_fwd, and the cache
    in effect) are those the reference's kernel engine resolves
    (`lidar_rt_tpu/ops/tracer.py:252-256`)."""
    from lidar_rt_tpu import cli as ref_cli

    cfg, warm, until = options.trace_configs(config.parse(path), "cuda")
    rcfg, rwarm, runtil = ref_cli._trace_cfg(ref_config.parse(path))
    for got, want in ((cfg, rcfg), (warm, rwarm)):
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.tile.tile_h, got.tile.tile_w, got.tile.max_per_tile,
                    got.tile.binner, got.tile.coarse_factor, got.exact_order,
                    got.tail_passes) == (
                want.tile.tile_h, want.tile.tile_w, want.tile.max_per_tile,
                want.tile.binner, want.tile.coarse_factor, want.exact_order,
                want.tail_passes)
            assert (got.fast_math, got.cache_fwd, got.use_cache) == (
                want.fast_math, want.cache_fwd,
                want.cache_fwd and want.fast_math and not want.exact_order)
    assert until == runtil
    flagship, _, _ = options.trace_configs(config.Args({}))
    assert flagship.tile == options.tracer_lib.FLAGSHIP_TILE
