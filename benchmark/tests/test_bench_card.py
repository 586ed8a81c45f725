"""Runs on the card (marked `cuda`; they skip without one): a short run of
every cell is correct, and a second run of a cell in the same checkout
finds the kernels' libraries built."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(workload: str, seed: int) -> dict:
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _cells() -> list[str]:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _cells())
def test_cell_is_correct_on_the_card(card, workload):
    first = _run(workload, 2 ** 31 + 11)
    second = _run(workload, 2 ** 31 + 12)
    assert first["correct"] and second["correct"]
    assert first["device"]["platform"] == "gpu"
    # The second run loads the libraries the first one built.
    assert second["metrics"]["setup_s"]["value"] < 60.0
