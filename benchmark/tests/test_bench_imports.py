"""No process of the benchmark loads JAX or the JAX package (top-level
module names compared whole), and the plain reference imports nothing of
the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "lidar_rt_tpu"}


def test_fresh_interpreter_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run, benchmark.control, benchmark.trace\n"
        "import benchmark.drivers.fwdbwd, benchmark.drivers.train\n"
        "import lidar_rt_tpu_torch.train.loop, lidar_rt_tpu_torch.bench\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'lidar_rt_tpu_torch' in tops\n"
        "print(sorted(tops & %r))\n" % (ROOT, FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "benchmark", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            got = _imports(os.path.join(ref, name))
            assert not got & (FORBIDDEN | {"lidar_rt_tpu_torch"}), name


def test_no_benchmark_file_imports_jax():
    for dp, _, fs in os.walk(os.path.join(ROOT, "benchmark")):
        for name in fs:
            if name.endswith(".py"):
                assert not _imports(os.path.join(dp, name)) & FORBIDDEN
