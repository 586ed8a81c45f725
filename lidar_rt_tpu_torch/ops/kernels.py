"""Build, binding and launch counters of the hand-written CUDA kernels.

Each kernel source under `csrc/` (`tracer_forward.cu`, `tracer_backward.cu`;
both include `tracer_common.cuh`) is compiled with nvcc for sm_90a into its
own shared library with a plain C entry point, loaded with ctypes, at first
use.  The nvcc processes of all missing libraries start together.  The
libraries go to `lidar_rt_tpu_torch/_build/`, keyed by a hash of every file
under `csrc/` and the flags, so an edited source or header rebuilds and an
unchanged tree does not.  Nothing here runs at import: the module imports
on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
KERNELS = ("tracer_forward", "tracer_backward")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GRAD_ROWS = 64     # rows of the backward kernel's (T, 64, K) output

# Launches of each kernel: raised by one per launch in `tracer_forward` and
# `tracer_backward`, nowhere else.  Callers reset them to count a run's
# launches.
forward_launches = 0
backward_launches = 0

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built on a machine with the "
                       "CUDA toolkit")


def source_digest() -> str:
    """Hash of every file under `csrc/` (names and contents) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(path.relative_to(CSRC).as_posix().encode() + b"\0")
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where the built library of kernel `name` for the current sources and
    flags lives."""
    return BUILD_DIR / f"{name}_{source_digest()}.so"


def build() -> dict[str, Path]:
    """Compile every kernel library not built for the current sources, one
    nvcc process per source, all started together; returns {name: path}.
    Each compiler's output (the ptxas register and spill report) is kept
    beside its library as a `.log`.  Raises if any nvcc fails."""
    paths = {name: library_path(name) for name in KERNELS}
    missing = {name: p for name, p in paths.items() if not p.exists()}
    if not missing:
        return paths
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, lib_path in missing.items():
        tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        missing[name].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}:\n"
                          f"{out[-4000:]}")
        else:
            os.replace(tmp, missing[name])
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return paths


def _library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        lib = ctypes.CDLL(str(build()[name]))
        n_ptr = 12 if name == "tracer_forward" else 13
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.tracer_error_string.argtypes = [ctypes.c_int]
        lib.tracer_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def _tile_shapes(cnt, dirs, mind, t0, axes, plane, inv_scale, opac, sign,
                 sh) -> dict:
    """The forward boundary's tensors with their expected shapes/dtypes."""
    t, r = dirs.shape[0], dirs.shape[1]
    k = axes.shape[-1]
    f32 = torch.float32
    return {
        "cnt": (cnt, (t,), torch.int32),
        "dirs": (dirs, (t, r, 3), f32),
        "mind": (mind, (t, r), f32),
        "t0": (t0, (t, r), f32),
        "axes": (axes, (t, 3, 3, k), f32),
        "plane": (plane, (t, 3, k), f32),
        "inv_scale": (inv_scale, (t, 2, k), f32),
        "opac": (opac, (t, k), f32),
        "sign": (sign, (t, k), f32),
        "sh": (sh, (t, 3, 16, k), f32),
    }


def _check(kernel: str, expected: dict) -> torch.device:
    """Raise on any input the kernel does not take; returns the device."""
    dev = expected["dirs"][0].device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {dev}")
    for name, (x, shape, dtype) in expected.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, dirs on {dev}")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if expected["dirs"][0].shape[0] > 65535:
        raise ValueError("more tiles than the kernel's grid limit 65535")
    return dev


def _launch(name: str, dev: torch.device, pointers, dims) -> None:
    lib = _library(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(*pointers, *dims, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.tracer_error_string(rc).decode())


def tracer_forward(cnt, dirs, mind, t0, axes, plane, inv_scale, opac, sign,
                   sh) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward tracer kernel on the current stream.

    Inputs as `ops.cuda_tracer.TileInputs`, all contiguous CUDA tensors on
    one device.  Returns (chans (T, 16, R), accum (T, K)).  Raises on any
    input the kernel does not take and on a failed launch."""
    global forward_launches
    expected = _tile_shapes(cnt, dirs, mind, t0, axes, plane, inv_scale,
                            opac, sign, sh)
    dev = _check("tracer_forward", expected)
    t, r, k = dirs.shape[0], dirs.shape[1], axes.shape[-1]
    chans = torch.empty((t, 16, r), dtype=torch.float32, device=dev)
    accum = torch.zeros((t, k), dtype=torch.float32, device=dev)
    _launch("tracer_forward", dev,
            [x.data_ptr() for x, _, _ in expected.values()]
            + [chans.data_ptr(), accum.data_ptr()], (t, r, k))
    forward_launches += 1
    return chans, accum


def tracer_backward(cnt, dirs, mind, t0, axes, plane, inv_scale, opac, sign,
                    sh, fwd_chans, g_chans) -> tuple[torch.Tensor, ...]:
    """Launch the backward tracer kernel on the current stream.

    Inputs: the forward's, plus its channels `fwd_chans` and their upstream
    gradients `g_chans`, both (T, 16, R); all contiguous CUDA tensors on
    one device.  Returns (d_axes (T, 3, 3, K), d_plane (T, 3, K),
    d_inv_scale (T, 2, K), d_opac (T, K), d_sh (T, 3, 16, K)), each summed
    over the tile's rays, as views of one (T, 64, K) buffer.  Raises on any
    input the kernel does not take and on a failed launch."""
    global backward_launches
    expected = _tile_shapes(cnt, dirs, mind, t0, axes, plane, inv_scale,
                            opac, sign, sh)
    t, r, k = dirs.shape[0], dirs.shape[1], axes.shape[-1]
    expected["fwd_chans"] = (fwd_chans, (t, 16, r), torch.float32)
    expected["g_chans"] = (g_chans, (t, 16, r), torch.float32)
    dev = _check("tracer_backward", expected)
    grads = torch.zeros((t, GRAD_ROWS, k), dtype=torch.float32, device=dev)
    _launch("tracer_backward", dev,
            [x.data_ptr() for x, _, _ in expected.values()]
            + [grads.data_ptr()], (t, r, k))
    backward_launches += 1
    return (grads[:, 0:9].view(t, 3, 3, k), grads[:, 9:12],
            grads[:, 12:14], grads[:, 14], grads[:, 16:].view(t, 3, 16, k))
