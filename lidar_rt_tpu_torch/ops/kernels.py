"""Build, binding and launch counter of the hand-written CUDA kernels.

`csrc/tracer_forward.cu` is compiled with nvcc for sm_90a into a shared
library with a plain C entry point, loaded with ctypes, at first use.  The
library goes to `lidar_rt_tpu_torch/_build/`, keyed by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is not.
Nothing here runs at import: the module imports on machines without nvcc.
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
SOURCE = _PKG / "csrc" / "tracer_forward.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches of the forward tracer kernel: raised by one per launch in
# `tracer_forward`, nowhere else.  Callers reset it to count a run's launches.
forward_launches = 0

_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built on a machine with the "
                       "CUDA toolkit")


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"tracer_forward_{digest[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless this source is built already;
    returns its path.  The compiler's output (ptxas register and spill
    report) is kept beside it as a `.log`.  Raises if nvcc fails."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.tracer_forward.argtypes = ([ctypes.c_void_p] * 12
                                       + [ctypes.c_int] * 3
                                       + [ctypes.c_void_p])
        lib.tracer_forward.restype = ctypes.c_int
        lib.tracer_error_string.argtypes = [ctypes.c_int]
        lib.tracer_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def tracer_forward(cnt, dirs, mind, t0, axes, plane, inv_scale, opac, sign,
                   sh) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward tracer kernel on the current stream.

    Inputs as `ops.cuda_tracer.TileInputs`, all contiguous CUDA tensors on
    one device.  Returns (chans (T, 16, R), accum (T, K)).  Raises on any
    input the kernel does not take and on a failed launch."""
    global forward_launches
    t, r = dirs.shape[0], dirs.shape[1]
    k = axes.shape[-1]
    f32 = torch.float32
    expected = {
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
    dev = dirs.device
    if dev.type != "cuda":
        raise ValueError(f"tracer_forward needs CUDA tensors, got {dev}")
    for name, (x, shape, dtype) in expected.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, dirs on {dev}")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if t > 65535:
        raise ValueError(f"{t} tiles exceed the kernel's grid limit 65535")

    lib = _library()
    chans = torch.empty((t, 16, r), dtype=f32, device=dev)
    accum = torch.zeros((t, k), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tracer_forward(
            *(x.data_ptr() for x, _, _ in expected.values()),
            chans.data_ptr(), accum.data_ptr(), t, r, k, stream)
    if rc != 0:
        raise RuntimeError("tracer_forward kernel launch failed: "
                           + lib.tracer_error_string(rc).decode())
    forward_launches += 1
    return chans, accum
