"""Build, binding and launch counters of the hand-written CUDA kernels.

Each kernel source under `csrc/` (`tracer_forward.cu`, `tracer_backward.cu`;
both include `tracer_common.cuh`; and the two probes of
`lidar_rt_tpu_torch/scripts/`, `kernel_microbench.cu` and
`bf16_microbench.cu`) is compiled with nvcc for sm_90a into its own shared
library with a plain C entry point, loaded with ctypes, at first use.
Each tracer library holds every mode of its kernel, chosen per launch:
tile order and exact (per-ray depth) order; in tile order the forward may
also write its per-pair residuals (the cache) and the backward decode
them in place of a replay; the backward may take its d_sh sums in one
TF32 product per term (fast) where float32 takes three.  `build()` starts
the nvcc processes of all missing libraries together; a first launch
builds only its own library.  The libraries go to
`lidar_rt_tpu_torch/_build/`, keyed by a hash of every file under `csrc/`
and the flags, so an edited source or header rebuilds and an unchanged
tree does not.  Nothing here runs at import: the module imports
on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
_P, _I = ctypes.c_void_p, ctypes.c_int
# Each kernel library's C entry points (`extern "C" int ...` in
# `csrc/<library>.cu`) and their ctypes argument types, in order: a pointer
# (c_void_p) for each tensor, output array and the stream, an int for each
# size, flag and index.  A C signature that disagrees segfaults instead of
# raising: tests/test_torch_kernels.py holds this table to the sources.
ENTRY_POINTS = {
    "tracer_forward": {
        "tracer_forward": [_P] * 14 + [_I] * 4 + [_P],
        "tracer_forward_occupancy": [_I, _I, _P],
    },
    "tracer_backward": {
        "tracer_backward": [_P] * 16 + [_I] * 5 + [_P],
        "tracer_backward_occupancy": [_I, _I, _P],
    },
    "kernel_microbench": {
        "kernel_microbench": [_P] * 8 + [_I] * 4 + [_P],
    },
    "bf16_microbench": {
        "bf16_microbench": [_P] * 3 + [_I] * 4 + [_P],
    },
}
KERNELS = tuple(ENTRY_POINTS)
# Each library's `const char* (int)` entry point naming a CUDA error.
ERROR_STRINGS = {"tracer_forward": "tracer_error_string",
                 "tracer_backward": "tracer_error_string",
                 "kernel_microbench": "probe_error_string",
                 "bf16_microbench": "probe_error_string"}
# The device kernels of each library, in the index order of its
# `<library>_occupancy` entry point.  tracer_forward_kernel<cache>;
# tracer_backward_kernel<source, fast>, source 0 the tile-order replay, 1
# the exact walk's pairs; tracer_backward_cache_kernel<fast>, the cache
# decode.
DEVICE_KERNELS = {
    "tracer_forward": ("tracer_forward_kernel<false>",
                       "tracer_forward_exact_kernel",
                       "tracer_forward_kernel<true>"),
    "tracer_backward": ("tracer_backward_kernel<0,false>",
                        "tracer_backward_exact_kernel",
                        "tracer_backward_kernel<1,false>",
                        "tracer_backward_cache_kernel<true>",
                        "tracer_backward_kernel<1,true>",
                        "tracer_backward_kernel<0,true>",
                        "tracer_backward_cache_kernel<false>"),
}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GRAD_ROWS = 64     # rows of the backward kernel's (T, 64, K) output
# The exact-order kernels stage all K candidates of a tile in shared memory
# (64 floats each; the forward adds one accumulator row and each of its 8
# warps' list of K 16-bit candidate indices): 69 KB at K = 256 of the
# 227 KB a block may use.  The exact backward also holds a (T, K, R)
# float2 buffer of per-pair (dL/dalpha, w) in device memory.
EXACT_MAX_K = 256

# Launches of each kernel in each mode: raised by one per launch in
# `tracer_forward` and `tracer_backward`, nowhere else; each launch raises
# exactly one.  Callers reset them to count a run's launches.
forward_launches = 0           # tile order
backward_launches = 0          # tile order, replayed (float32 or fast sums)
forward_cache_launches = 0     # tile order, writing the cache
backward_cache_launches = 0    # tile order, decoding the cache
forward_exact_launches = 0     # exact (per-ray depth) order
backward_exact_launches = 0    # exact order, 3xTF32 sums
backward_exact_fast_launches = 0   # exact order, 1xTF32 sums


LAUNCH_COUNTS = ("forward_launches", "backward_launches",
                 "forward_cache_launches", "backward_cache_launches",
                 "forward_exact_launches", "backward_exact_launches",
                 "backward_exact_fast_launches")


def launch_counts() -> dict[str, int]:
    """Every launch count by name; a run's launches are the difference of
    two of these (`launches_since`)."""
    return {name: globals()[name] for name in LAUNCH_COUNTS}


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """The launches made since `before` (a `launch_counts()`)."""
    return {name: n - before[name] for name, n in launch_counts().items()}


def reset_launches() -> None:
    """Set every launch count to 0."""
    global forward_launches, backward_launches
    global forward_cache_launches, backward_cache_launches
    global forward_exact_launches, backward_exact_launches
    global backward_exact_fast_launches
    forward_launches = backward_launches = 0
    forward_cache_launches = backward_cache_launches = 0
    forward_exact_launches = backward_exact_launches = 0
    backward_exact_fast_launches = 0


def check_cache_order(exact: bool, cache) -> None:
    """Raise ValueError for a cache with exact order: the forward caches
    its residuals in tile order only (the exact backward walks each ray's
    depth order again)."""
    if exact and cache is not None and cache is not False:
        raise ValueError("the forward's cache requires tile-order "
                         "compositing (exact=False)")


def check_exact_k(k: int) -> None:
    """Raise ValueError unless the exact-order kernels take K candidates
    per tile (1 <= K <= EXACT_MAX_K)."""
    if not 1 <= k <= EXACT_MAX_K:
        raise ValueError(f"exact order supports 1 <= K <= {EXACT_MAX_K} "
                         f"candidates per tile, got K = {k}")

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


def build(names: tuple[str, ...] = KERNELS) -> dict[str, Path]:
    """Compile every kernel library of `names` (default: all) not built for
    the current sources, one nvcc process per source, all started
    together; returns {name: path}.  Each compiler's output (the ptxas
    register and spill report) is kept beside its library as a `.log`.
    Raises if any nvcc fails."""
    paths = {name: library_path(name) for name in names}
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


def load_library(path: Path, name: str) -> ctypes.CDLL:
    """Load a built library of kernel `name` with every entry point's
    argtypes set from ENTRY_POINTS."""
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in ENTRY_POINTS[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    errors = getattr(lib, ERROR_STRINGS[name])
    errors.argtypes = [ctypes.c_int]
    errors.restype = ctypes.c_char_p
    lib.error_string = errors
    return lib


def _library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        _libs[name] = load_library(build((name,))[name], name)
    return _libs[name]


def occupancy(k: int) -> dict[str, tuple[int, int]]:
    """(resident blocks per SM, threads per block) of every device kernel
    at K = k candidates per tile, from cudaOccupancyMaxActiveBlocksPer
    Multiprocessor with each kernel's shared memory, on the current
    device."""
    out = {}
    for name, device_kernels in DEVICE_KERNELS.items():
        lib = _library(name)
        for which, kernel in enumerate(device_kernels):
            res = (ctypes.c_int * 2)()
            rc = getattr(lib, f"{name}_occupancy")(which, k,
                                                   ctypes.addressof(res))
            if rc != 0:
                raise RuntimeError(f"{kernel} occupancy query failed: "
                                   + lib.error_string(rc).decode())
            out[kernel] = (res[0], res[1])
    return out


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


def launch(name: str, dev: torch.device, pointers, dims) -> None:
    """Call library `name`'s entry point of the same name with the
    pointers, then the ints `dims`, then the current stream of `dev`;
    raises if it returns a CUDA error (a refused launch)."""
    lib = _library(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(*pointers, *dims, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.error_string(rc).decode())


class TracerCache(NamedTuple):
    """What the forward keeps for the backward in the cache mode.

    pairs: (T, K, R, 2) bfloat16 (`cache_shape`), each (tile, candidate,
      ray) step's signed gated alpha (negative where the ALPHA_MAX clamp
      held, zero where a gate failed) and signed exclusive transmittance
      (negative where the T_MIN test failed), written only at the steps
      the forward kernel visits.
    last: (T, R) int32, each ray's last index: the candidate at which the
      T_MIN test stopped it, else the tile's last candidate (count - 1; -1
      in an empty tile).  The backward walks each ray from it down to
      candidate 0 and reads no step above it.
    """

    pairs: torch.Tensor
    last: torch.Tensor


def cache_shape(t: int, k: int, r: int) -> tuple[int, int, int, int]:
    """The shape of a `TracerCache`'s pairs: (T, K, R, 2)."""
    return (t, k, r, 2)


def tracer_forward(cnt, dirs, mind, t0, axes, plane, inv_scale, opac, sign,
                   sh, exact: bool = False, cache: bool = False,
                   cache_out: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, ...]:
    """Launch the forward tracer kernel on the current stream, in tile order
    or (exact) in each ray's depth order.

    Inputs as `ops.cuda_tracer.TileInputs`, all contiguous CUDA tensors on
    one device.  Returns (chans (T, 16, R), accum (T, K)), and with
    `cache` (tile order only) a `TracerCache` for the backward, its pairs
    written only at the (ray, candidate) steps the kernel visits, into a
    new uninitialised tensor.  `cache_out` is there for the tests and
    `chip_smoke.py` alone: a pairs buffer they fill with poison first,
    to show that the backward reads only the steps written.
    Raises on any input the kernel does not take (exact: K outside [1,
    EXACT_MAX_K], or a cache) and on a failed launch."""
    global forward_launches, forward_cache_launches, forward_exact_launches
    check_cache_order(exact, cache)
    if exact:
        check_exact_k(axes.shape[-1])
    expected = _tile_shapes(cnt, dirs, mind, t0, axes, plane, inv_scale,
                            opac, sign, sh)
    dev = _check("tracer_forward", expected)
    t, r, k = dirs.shape[0], dirs.shape[1], axes.shape[-1]
    chans = torch.empty((t, 16, r), dtype=torch.float32, device=dev)
    accum = torch.zeros((t, k), dtype=torch.float32, device=dev)
    res = None
    if cache:
        pairs = cache_out
        if pairs is None:
            pairs = torch.empty(cache_shape(t, k, r), dtype=torch.bfloat16,
                                device=dev)
        _check("tracer_forward", {"dirs": expected["dirs"], "cache": (
            pairs, cache_shape(t, k, r), torch.bfloat16)})
        res = TracerCache(pairs, torch.empty((t, r), dtype=torch.int32,
                                             device=dev))
    launch("tracer_forward", dev,
           [x.data_ptr() for x, _, _ in expected.values()]
           + [chans.data_ptr(), accum.data_ptr()]
           + ([None, None] if res is None
              else [res.pairs.data_ptr(), res.last.data_ptr()]),
           (t, r, k, int(exact)))
    if exact:
        forward_exact_launches += 1
    elif cache:
        forward_cache_launches += 1
        return chans, accum, res
    else:
        forward_launches += 1
    return chans, accum


def tracer_backward(cnt, dirs, mind, t0, axes, plane, inv_scale, opac, sign,
                    sh, fwd_chans, g_chans, exact: bool = False,
                    cache: TracerCache | None = None, fast: bool = False
                    ) -> tuple[torch.Tensor, ...]:
    """Launch the backward tracer kernel on the current stream, in the
    forward's order (tile, or exact per-ray depth order: a walk kernel,
    then the sums kernel, sharing a (T, K, R) float2 buffer).

    Inputs: the forward's, plus its channels `fwd_chans` and their upstream
    gradients `g_chans`, both (T, 16, R); all contiguous CUDA tensors on
    one device.  cache: the `TracerCache` that `tracer_forward(...,
    cache=True)` made for these inputs (tile order only), decoded in place
    of a replay.  fast: the d_sh sums in one TF32 product per term.  Returns
    (d_axes (T, 3, 3, K), d_plane (T, 3, K), d_inv_scale (T, 2, K), d_opac
    (T, K), d_sh (T, 3, 16, K)), each summed over the tile's rays, as
    views of one (T, 64, K) buffer.  Raises on any input the kernel does
    not take (a cache with exact order) and on a failed launch."""
    global backward_launches, backward_cache_launches
    global backward_exact_launches, backward_exact_fast_launches
    check_cache_order(exact, cache)
    if exact:
        check_exact_k(axes.shape[-1])
    expected = _tile_shapes(cnt, dirs, mind, t0, axes, plane, inv_scale,
                            opac, sign, sh)
    t, r, k = dirs.shape[0], dirs.shape[1], axes.shape[-1]
    expected["fwd_chans"] = (fwd_chans, (t, 16, r), torch.float32)
    expected["g_chans"] = (g_chans, (t, 16, r), torch.float32)
    if cache is not None:
        expected["cache"] = (cache.pairs, cache_shape(t, k, r),
                             torch.bfloat16)
        expected["last"] = (cache.last, (t, r), torch.int32)
    dev = _check("tracer_backward", expected)
    grads = torch.zeros((t, GRAD_ROWS, k), dtype=torch.float32, device=dev)
    pairs = (torch.empty((t, k, r, 2), dtype=torch.float32, device=dev)
             if exact else None)
    arrays = [x.data_ptr() for name, (x, _, _) in expected.items()
              if name not in ("cache", "last")]
    launch("tracer_backward", dev,
           arrays + [None if pairs is None else pairs.data_ptr()]
           + ([None, None] if cache is None
              else [cache.pairs.data_ptr(), cache.last.data_ptr()])
           + [grads.data_ptr()], (t, r, k, int(exact), int(fast)))
    if exact and fast:
        backward_exact_fast_launches += 1
    elif exact:
        backward_exact_launches += 1
    elif cache is not None:
        backward_cache_launches += 1
    else:
        backward_launches += 1
    return (grads[:, 0:9].view(t, 3, 3, k), grads[:, 9:12],
            grads[:, 12:14], grads[:, 14], grads[:, 16:].view(t, 3, 16, k))
