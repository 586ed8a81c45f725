"""The probe kernels' plain versions held to the reference's Pallas probes.

`lidar_rt_tpu_torch/scripts/kernel_microbench.py` (the forward body's
ablation ladder) and `bf16_microbench.py` (a gate-shaped body in float32
and bfloat16) each keep a plain PyTorch version beside their CUDA kernel;
on CPU tensors the wrappers run it.  Here each is held to the reference
kernel (`scripts/kernel_microbench.py` `kernel`, `scripts/bf16_microbench.py`
`_kernel`) run through `pl.pallas_call(..., interpret=True)` on the same
numpy inputs, at a small size.  The card tests of the kernels themselves
are in tests/test_torch_kernels.py (`-m cuda`).

Bars: float32 levels within 2e-4 (the tracer kernels' bar,
tests/test_pallas_tracer.py:52) plus 1e-5 of the level's largest
magnitude: the sums of K terms of magnitude up to ~60 (broadcasts) are
taken in another order.  The bfloat16 body within 1 bfloat16 ulp of the
reference's value: both round every operation to bfloat16 (measured: the
same bits).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lidar_rt_tpu_torch.scripts import bf16_microbench as t_bf16
from lidar_rt_tpu_torch.scripts import kernel_microbench as t_abl

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ATOL, REL_OF_MAX = 2e-4, 1e-5
T, R, K, RB = 2, 128, 128, 64


def _load_reference(name: str):
    """Import scripts/<name>.py, restoring the jax settings it changes at
    import (a persistent compilation cache)."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


j_abl = _load_reference("kernel_microbench")
j_bf16 = _load_reference("bf16_microbench")


def _reference_ablation(level: str, inputs) -> np.ndarray:
    """The reference kernel at (T, R, K) in interpret mode, its blocks of
    RB rays (its module's K and RB set to this size)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_abl, "K", K)
    mp.setattr(j_abl, "RB", RB)
    try:
        f = pl.pallas_call(
            functools.partial(j_abl.kernel, level),
            grid=(T, R // RB),
            in_specs=[
                pl.BlockSpec((1, RB, 3), lambda t, r: (t, r, 0)),
                pl.BlockSpec((1, RB, 16), lambda t, r: (t, r, 0)),
                pl.BlockSpec((1, 3, 3, K), lambda t, r: (t, 0, 0, 0)),
                pl.BlockSpec((1, 3, K), lambda t, r: (t, 0, 0)),
                pl.BlockSpec((1, 2, K), lambda t, r: (t, 0, 0)),
                pl.BlockSpec((1, 1, K), lambda t, r: (t, 0, 0)),
                pl.BlockSpec((1, 3, 16, K), lambda t, r: (t, 0, 0, 0)),
            ],
            out_specs=[pl.BlockSpec((1, 16, RB), lambda t, r: (t, 0, r))],
            out_shape=[jax.ShapeDtypeStruct((T, 16, R), jnp.float32)],
            scratch_shapes=[pltpu.VMEM((RB, 1), jnp.float32)],
            interpret=True)
        return np.asarray(f(*(jnp.asarray(x.numpy()) for x in inputs))[0])
    finally:
        mp.undo()


@pytest.mark.parametrize("level", t_abl.LEVELS)
def test_ablation_level_matches_reference(level):
    inputs = t_abl.make_inputs(0, T, R, K, device="cpu")
    t_abl.reset_launches()
    got = t_abl.ablation(level, inputs).numpy()
    want = _reference_ablation(level, inputs)
    assert got.shape == want.shape == (T, 16, R)
    err = np.abs(got - want).max()
    assert err <= ATOL + REL_OF_MAX * np.abs(want).max(), (level, err)
    if level in ("full", "nodiv", "noexp"):
        assert np.abs(want[:, :8]).max() > 0 and not want[:, 8:].any()
    elif level not in ("minimal", "chain", "chain_bf16", "broadcasts"):
        assert 0 < np.abs(want).max() < K     # some pairs pass the gates
    assert not any(t_abl.launches.values())  # the CPU runs no kernel


@pytest.mark.parametrize("dtype,with_exp", t_bf16.MODES,
                         ids=[t_bf16.mode_name(*m) for m in t_bf16.MODES])
def test_bf16_probe_matches_reference(dtype, with_exp):
    rows, lanes = 16, 256
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    rng = np.random.default_rng(0)
    a, b = (jnp.asarray(rng.uniform(0.1, 0.9, (rows, lanes)), jdt)
            for _ in range(2))
    ta, tb = t_bf16.make_inputs(dtype, 0, rows, lanes, device="cpu")
    for j, t in ((a, ta), (b, tb)):       # the same inputs, to the bit
        np.testing.assert_array_equal(np.asarray(j.astype(jnp.float32)),
                                      t.float().numpy())
    f = pl.pallas_call(
        functools.partial(j_bf16._kernel, dtype=jdt, reps=t_bf16.REPS,
                          with_exp=with_exp),
        out_shape=jax.ShapeDtypeStruct((rows, lanes), jdt), interpret=True)
    want = np.asarray(f(a, b).astype(jnp.float32))
    t_bf16.reset_launches()
    got = t_bf16.probe(ta, tb, with_exp)
    assert got.dtype == ta.dtype
    got = got.float().numpy()
    err = np.abs(got - want)
    if dtype == "bf16":
        # One bfloat16 ulp at each value: 2^(exponent - 7).
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
        assert (err <= ulp).all(), (err / ulp).max()
    else:
        assert err.max() <= ATOL + REL_OF_MAX * np.abs(want).max()
    assert np.abs(want).max() > 1.0
    assert not any(t_bf16.launches.values())


def test_probe_wrappers_refuse_what_the_kernels_do_not_take():
    inputs = t_abl.make_inputs(0, 1, 32, 8, device="cpu")
    with pytest.raises(ValueError, match="unknown level"):
        t_abl.ablation("fused", inputs)
    odd = t_abl.make_inputs(0, 1, 32, 7, device="cpu")
    with pytest.raises(ValueError, match="even K"):
        t_abl.ablation("minimal", odd)
    with pytest.raises(ValueError, match="dirs"):
        t_abl.ablation("minimal", inputs._replace(dirs=inputs.dirs.double()))
    a, b = t_bf16.make_inputs("f32", 0, 1, 3, device="cpu")
    with pytest.raises(ValueError, match="even number"):
        t_bf16.probe(a, b, False)
    a, b = t_bf16.make_inputs("f32", 0, 2, 4, device="cpu")
    with pytest.raises(ValueError):
        t_bf16.probe(a, b.to(torch.bfloat16), False)
    with pytest.raises(ValueError):
        t_bf16.probe(a.double(), b.double(), False)


def test_probe_bounds_at_the_reference_shape():
    """The bounds the card's numbers stand beside, from the reference's
    shapes: `minimal` moves more bytes than it computes, the other levels
    and the gate body are bound by their operations; a level reads only
    its inputs."""
    meta = t_abl.make_inputs(0, t_abl.T, t_abl.R, t_abl.K, device="meta")
    full = t_abl.work("full", meta)
    assert full["pairs"] == 42 * 4096 * 128
    assert full["ops"] == full["pairs"] * 159 and full["bf16_ops"] == 0
    assert full["bytes"] == 4 * (42 * 4096 * (3 + 16 + 16)
                                 + 42 * 128 * (9 + 3 + 2 + 1 + 48))
    assert t_abl.work("minimal", meta)["bytes"] == 4 * (
        42 * 4096 * (3 + 16) + 42 * 9 * 128)
    assert t_abl.bound("minimal", meta)[1] == "bytes"
    for level in t_abl.LEVELS[1:]:
        assert t_abl.bound(level, meta)[1] == "operations", level
    bf = t_abl.work("chain_bf16", meta)
    assert bf["bf16_ops"] == bf["pairs"] * 40
    a = torch.empty((t_bf16.ROWS, t_bf16.LANES), device="meta")
    ms, by = t_bf16.bound(a, True)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 512 * 1024 * 64 * 18 / 67e12)
    ms_bf, _ = t_bf16.bound(a.to(torch.bfloat16), True)
    assert ms_bf == pytest.approx(ms / 2)
