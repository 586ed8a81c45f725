"""lidar_rt_tpu_torch — the PyTorch/CUDA port of `lidar_rt_tpu`.

The module tree mirrors `lidar_rt_tpu` (core/, ops/, scene/, data/, train/,
sim.py) so each module's counterpart is found by name.  Plain tensor code
is PyTorch; the Pallas forward and backward tracer kernels are hand-written
CUDA C++ kernels for Hopper (`csrc/tracer_forward.cu`,
`csrc/tracer_backward.cu`, built and bound by `ops/kernels.py`), each with
a plain PyTorch twin that CPU tensors take (`ops/cuda_tracer.py`).

This package never imports jax, nor any module of `lidar_rt_tpu`, not even
one free of jax (it keeps its own copies: `data/proto_wire.py`, `native/`,
`data/writers.py`); `lidar_rt_tpu` stays the reference that the tests hold
it to.
"""
