"""Pure-math core: quaternions, spherical harmonics, ray grids, transforms.

Torch counterparts of `lidar_rt_tpu.core`: batched functions on tensors that
keep the reference's numerical conventions (wxyz quaternions, SH basis
order, range-image pixel mapping).
"""
