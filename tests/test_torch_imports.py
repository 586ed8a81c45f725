"""The port stays jax-free, and `chip_smoke.py` refuses to run off the card.

Each check runs in a fresh interpreter, since the test process itself has
jax loaded."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _python(code: str, cwd: Path = ROOT, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **env})


def test_port_imports_no_jax():
    """No jax anywhere in the port, no module of the reference package
    `lidar_rt_tpu` (not even one free of jax: the port keeps its own
    copies), and no yaml on the training path (the card's machine has
    neither jax nor yaml)."""
    proc = _python(
        "import sys\n"
        "import chip_smoke\n"
        "import lidar_rt_tpu_torch.sim\n"
        "import lidar_rt_tpu_torch.ops.cuda_tracer\n"
        "import lidar_rt_tpu_torch.ops.kernels\n"
        "import lidar_rt_tpu_torch.scene.convert\n"
        "import lidar_rt_tpu_torch.ops.composite\n"
        "import lidar_rt_tpu_torch.train.loop\n"
        "import lidar_rt_tpu_torch.train.options\n"
        "import lidar_rt_tpu_torch.data.frames\n"
        "import lidar_rt_tpu_torch.data.build\n"
        "import lidar_rt_tpu_torch.data.kitti\n"
        "import lidar_rt_tpu_torch.data.proto_wire\n"
        "import lidar_rt_tpu_torch.data.synthetic\n"
        "import lidar_rt_tpu_torch.data.waymo\n"
        "import lidar_rt_tpu_torch.data.writers\n"
        "import lidar_rt_tpu_torch.native\n"
        "import lidar_rt_tpu_torch.ops.knn\n"
        "import lidar_rt_tpu_torch.scene.asset\n"
        "import lidar_rt_tpu_torch.scene.tracks\n"
        "import lidar_rt_tpu_torch.parallel\n"
        "import lidar_rt_tpu_torch.parallel.sharding\n"
        "import lidar_rt_tpu_torch.parallel.train_step\n"
        "import lidar_rt_tpu_torch.parallel.trainer\n"
        "import lidar_rt_tpu_torch.parallel.world\n"
        "import lidar_rt_tpu_torch.core.camera\n"
        "import lidar_rt_tpu_torch.viewer\n"
        "import lidar_rt_tpu_torch.scripts.e2e_rehearsal\n"
        "import lidar_rt_tpu_torch.scripts.kernel_microbench\n"
        "import lidar_rt_tpu_torch.scripts.bf16_microbench\n"
        "import lidar_rt_tpu_torch.scripts.sass_floor\n"
        "from lidar_rt_tpu_torch.ops.tracer import (bin_tail_chain,\n"
        "                                           render_multi_return)\n"
        "from lidar_rt_tpu_torch.ops.kernels import check_exact_k\n"
        "from lidar_rt_tpu_torch.native import available\n"
        "assert available()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m in ('jax', 'yaml', 'lidar_rt_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'lidar_rt_tpu.')))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_spawned_ranks_import_only_the_port():
    """A rank that `parallel.run_world` spawns imports the module of its
    function: the test worlds' (tests/torch_parallel_workers.py) and
    chip_smoke.py's phase 15 ranks load no jax and no module of
    `lidar_rt_tpu`."""
    proc = _python(
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_parallel_workers, chip_smoke\n"
        "from lidar_rt_tpu_torch.parallel import run_world\n"
        "assert callable(chip_smoke.band_rank)\n"
        "assert callable(chip_smoke.train_rank)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'lidar_rt_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_cli_imports_no_jax_yaml_flax_optax():
    """The CLI and everything it pulls in (config reader, checkpoints,
    eval, refine, U-Net, LPIPS, the utilities) load no jax, yaml, flax,
    optax or module of `lidar_rt_tpu`."""
    proc = _python(
        "import sys\n"
        "import lidar_rt_tpu_torch.cli\n"
        "import lidar_rt_tpu_torch.config\n"
        "import lidar_rt_tpu_torch.eval.lpips\n"
        "import lidar_rt_tpu_torch.eval.metrics\n"
        "import lidar_rt_tpu_torch.eval.runner\n"
        "import lidar_rt_tpu_torch.models.unet\n"
        "import lidar_rt_tpu_torch.train.refine\n"
        "import lidar_rt_tpu_torch.utils.checkpoint\n"
        "import lidar_rt_tpu_torch.utils.console\n"
        "import lidar_rt_tpu_torch.utils.export\n"
        "import lidar_rt_tpu_torch.utils.import_torch\n"
        "import lidar_rt_tpu_torch.utils.profiling\n"
        "import lidar_rt_tpu_torch.utils.record\n"
        "from lidar_rt_tpu_torch import cli\n"
        "cli._train_parser(); cli._eval_parser()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'yaml', 'flax',\n"
        "                                    'optax', 'lidar_rt_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_scripts_import_no_jax():
    """The commands of `lidar_rt_tpu_torch.scripts` (the
    reference-checkpoint commands, the rehearsal runner, the two probes,
    the densify and refine diagnostics, the two user tools, the street
    scene and its eight design probes, the JAX checkpoints' import, and
    the bench's six stage profilers) and the bench
    (`lidar_rt_tpu_torch.bench`) load no jax, yaml or module of
    `lidar_rt_tpu`, and each answers --help as a `python -m` entry
    point."""
    proc = _python(
        "import sys\n"
        "import lidar_rt_tpu_torch.scripts\n"
        "import lidar_rt_tpu_torch.scripts.import_reference_ckpt\n"
        "import lidar_rt_tpu_torch.scripts.import_roundtrip\n"
        "import lidar_rt_tpu_torch.scripts.e2e_rehearsal\n"
        "import lidar_rt_tpu_torch.scripts.kernel_microbench\n"
        "import lidar_rt_tpu_torch.scripts.bf16_microbench\n"
        "import lidar_rt_tpu_torch.scripts.sass_floor\n"
        "import lidar_rt_tpu_torch.scripts.densify_stats\n"
        "import lidar_rt_tpu_torch.scripts.refine_spread\n"
        "import lidar_rt_tpu_torch.scripts.quality_check\n"
        "import lidar_rt_tpu_torch.scripts.nan_forensics\n"
        "import lidar_rt_tpu_torch.scripts.street\n"
        "import lidar_rt_tpu_torch.scripts.survivor_stats\n"
        "import lidar_rt_tpu_torch.scripts.overcount_probe\n"
        "import lidar_rt_tpu_torch.scripts.subtile_demand\n"
        "import lidar_rt_tpu_torch.scripts.occlusion_stats\n"
        "import lidar_rt_tpu_torch.scripts.selection_probe\n"
        "import lidar_rt_tpu_torch.scripts.profile_binner\n"
        "import lidar_rt_tpu_torch.scripts.sweep_perf\n"
        "import lidar_rt_tpu_torch.scripts.compact_probe\n"
        "import lidar_rt_tpu_torch.scripts.import_jax_ckpt\n"
        "import lidar_rt_tpu_torch.bench\n"
        "import lidar_rt_tpu_torch.scripts.profile_stages\n"
        "import lidar_rt_tpu_torch.scripts.profile_amortized\n"
        "import lidar_rt_tpu_torch.scripts.stage_bench\n"
        "import lidar_rt_tpu_torch.scripts.prep_bench\n"
        "import lidar_rt_tpu_torch.scripts.intercept_probe\n"
        "import lidar_rt_tpu_torch.scripts.grid_overhead_probe\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'yaml',\n"
        "                                    'lidar_rt_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
    # Every command's --help at once, each its own process.
    helps = {(module, option): subprocess.Popen(
        [sys.executable, "-m", module if "." in module
         else f"lidar_rt_tpu_torch.scripts.{module}",
         "--help"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for module, option in (
            ("import_reference_ckpt", "--device"),
            ("import_roundtrip", "--device"),
            ("e2e_rehearsal", "--device"),
            ("kernel_microbench", "--seed"),
            ("bf16_microbench", "--seed"),
            ("densify_stats", "--repeats"),
            ("refine_spread", "--seeds"),
            ("quality_check", "--device"),
            ("nan_forensics", "--device"),
            ("survivor_stats", "--device"),
            ("overcount_probe", "--device"),
            ("subtile_demand", "--device"),
            ("occlusion_stats", "--device"),
            ("selection_probe", "--device"),
            ("profile_binner", "--device"),
            ("sweep_perf", "--fast"),
            ("compact_probe", "--device"),
            ("import_jax_ckpt", "--models_dir"),
            ("lidar_rt_tpu_torch.bench", "--device"),
            ("profile_stages", "--fast"),
            ("profile_amortized", "--device"),
            ("stage_bench", "--device"),
            ("prep_bench", "--device"),
            ("intercept_probe", "--device"),
            ("grid_overhead_probe", "--device"))}
    for (module, option), help_ in helps.items():
        out, err = help_.communicate(timeout=300)
        assert help_.returncode == 0, (module, err)
        assert option in out, module


def test_chip_smoke_scene_is_bench_scene():
    """chip_smoke.py draws bench.py's street soup without importing jax."""
    proc = _python(
        "import numpy as np, bench, chip_smoke\n"
        "ref = bench.street_scene_bundle(512, seed=3)\n"
        "got = chip_smoke.street_soup(512, seed=3)\n"
        "for k in ('means', 'rotations', 'scales', 'opacities', 'sh'):\n"
        "    want = np.asarray(getattr(ref, k))\n"
        "    np.testing.assert_array_equal(got[k], want)\n"
        "print('same')\n", JAX_PLATFORMS="cpu")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("same")


def test_jax_checkpoint_export_imports_no_port():
    """`export_jax_ckpt.py` reads the JAX package's checkpoints: it loads
    that package and jax, and nothing of the port, nor torch."""
    proc = _python(
        "import sys\n"
        "import export_jax_ckpt\n"
        "assert 'lidar_rt_tpu.utils.checkpoint' in sys.modules\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'lidar_rt_tpu_torch'))\n"
        "assert not bad, bad\n"
        "print('clean')\n", JAX_PLATFORMS="cpu")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("clean")


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    runs = [(ROOT, {"CUDA_VISIBLE_DEVICES": ""})]
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs.append((tmp_path, {}))
    for cwd, env in runs:
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=300,
                              env={**os.environ, **env})
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
