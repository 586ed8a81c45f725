// Forward surfel tracer kernel for Hopper (sm_90a).
//
// Replaces: lidar_rt_tpu/ops/pallas_tracer.py::_forward_kernel, the Pallas
// TPU forward kernel launched by _core_fwd_call, together with the in-kernel
// helpers it calls from lidar_rt_tpu/ops/pallas_common.py: sh_basis_rows
// becomes `sh_basis` in tracer_common.cuh, and lane_cumprod_excl becomes
// the sequential per-ray transmittance walk.  The boundary is the Pallas
// kernel's (see lidar_rt_tpu_torch/ops/cuda_tracer.py): the same inputs
// with an int32 count, the same channel-major (T, 16, R) output and a
// (T, K) accum.
//
// What bounds it on this card: per (ray, candidate) pair the intersection
// and gates cost ~25 flops and one exp; a pair that passes the gates adds
// ~60 flops of SH shading and channel sums.  Candidate parameters are read
// from shared memory as warp-wide broadcasts; device memory sees each
// tile's candidates once per 128-ray block (64 floats each) and each ray's
// 16 output rows once.  At the flagship shapes (168 tiles x 1024 rays x 256
// candidates = 44 M pairs) that is ~1-2 GFLOP against ~15 MB of traffic:
// compute- and latency-bound, not bandwidth-bound.
//
// Design: one thread per ray walks its tile's candidates front to back in
// tile order (the binner's nearest-first order) and keeps the transmittance
// in a register.  The first hit whose T*(1-alpha) falls below T_MIN stops
// the ray and is not composited: the live-prefix rule of
// lidar_rt_tpu/ops/geometry.py composite_weights.  A block of 128 rays
// stages 128 candidates at a time in shared memory (64 floats each, 32 KB,
// inside the static 48 KB limit) and stops staging once none of its rays is
// alive.  The SH basis lives in 16 registers, and shading runs only for
// pairs that pass the gates.  Per-candidate sums over rays go through a warp
// reduction and one atomicAdd per warp into a zero-initialised (T, K)
// output: CUDA blocks run in no order, where the TPU kernel carried these
// sums across its sequential grid.  The intersection, gates and shading are
// shared with the backward kernel (tracer_common.cuh), written with
// explicitly rounded operations so both kernels decide every gate alike.
// Making it fast (occupancy, splitting K) is later work.

#include "tracer_common.cuh"

namespace {

using namespace tracer;

__global__ void __launch_bounds__(kThreads) tracer_forward_kernel(
    const int* __restrict__ cnt, const float* __restrict__ dirs,
    const float* __restrict__ mind, const float* __restrict__ t0,
    const float* __restrict__ axes, const float* __restrict__ plane,
    const float* __restrict__ inv_scale, const float* __restrict__ opac,
    const float* __restrict__ sign, const float* __restrict__ sh,
    float* __restrict__ chans, float* __restrict__ accum, int rays, int k) {
  __shared__ float s_geo[kGeo][kChunk];
  __shared__ float s_sh[kSh][kChunk];

  const long long tile = blockIdx.y;
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool has_ray = ray < rays;
  const int lane = threadIdx.x & 31;
  const long long ray_at = tile * rays + ray;

  float dx = 0.0f, dy = 0.0f, dz = 0.0f, min_t = 0.0f, trans0 = 0.0f;
  if (has_ray) {
    dx = dirs[ray_at * 3 + 0];
    dy = dirs[ray_at * 3 + 1];
    dz = dirs[ray_at * 3 + 2];
    min_t = mind[ray_at];
    trans0 = t0[ray_at];
  }
  float basis[16];
  sh_basis(dx, dy, dz, basis);

  float trans = trans0;
  bool alive = has_ray;
  float acc_c0 = 0.0f, acc_c1 = 0.0f, acc_c2 = 0.0f, acc_t = 0.0f;
  float acc_w = 0.0f, acc_n0 = 0.0f, acc_n1 = 0.0f, acc_n2 = 0.0f;

  const int count = min(max(cnt[tile], 0), k);
  for (int base = 0; base < count; base += kChunk) {
    // Barrier before shared memory is overwritten; the whole block stops
    // once none of its rays is alive.
    if (!__syncthreads_or(alive)) break;
    const int n = min(kChunk, count - base);
    stage_chunk(s_geo, s_sh, tile, k, base, n, axes, plane, inv_scale, opac,
                sign, sh);
    __syncthreads();
    if (!__any_sync(0xffffffffu, alive)) continue;  // warp-uniform skip

    for (int j = 0; j < n; ++j) {
      float w = 0.0f;
      if (alive) {
        const Hit h = intersect(s_geo, j, dx, dy, dz, min_t);
        const float next = next_trans(trans, h.alpha);
        if (next < kTMin) {
          alive = false;  // the live prefix ends before this hit
          trans = next;
        } else if (h.alpha > 0.0f) {
          w = h.alpha * trans;
          trans = next;
          float c0, c1, c2;
          shade(basis, s_sh, j, c0, c1, c2);
          const float sw = w * s_geo[kSign][j];
          acc_c0 += w * fmaxf(c0 + 0.5f, 0.0f);
          acc_c1 += w * c1;
          acc_c2 += w * c2;
          acc_t += w * h.t;
          acc_w += w;
          acc_n0 += sw * s_geo[kNx][j];
          acc_n1 += sw * s_geo[kNy][j];
          acc_n2 += sw * s_geo[kNz][j];
        }
      }
      if (__any_sync(0xffffffffu, w != 0.0f)) {
        const float s = warp_sum(w);
        if (lane == 0) atomicAdd(&accum[tile * k + base + j], s);
      }
    }
  }

  if (has_ray) {
    float* out = chans + tile * kOutRows * rays + ray;
    out[0 * rays] = acc_c0;
    out[1 * rays] = acc_c1 + 0.5f * acc_w;
    out[2 * rays] = acc_c2 + 0.5f * acc_w;
    out[3 * rays] = acc_t;
    out[4 * rays] = acc_w;
    out[5 * rays] = acc_n0;
    out[6 * rays] = acc_n1;
    out[7 * rays] = acc_n2;
    out[8 * rays] = trans0 - acc_w;  // T_out by telescoping
    out[9 * rays] = trans;           // raw T: partial once a ray stopped
#pragma unroll
    for (int r = 10; r < kOutRows; ++r) out[r * rays] = 0.0f;
  }
}

}  // namespace

// Launches the kernel on `stream` over (tiles, rays, k); returns
// cudaGetLastError() of the launch.  chans (tiles, 16, rays) need not be
// initialised; accum (tiles, k) must be zero.
extern "C" int tracer_forward(const void* cnt, const void* dirs,
                              const void* mind, const void* t0,
                              const void* axes, const void* plane,
                              const void* inv_scale, const void* opac,
                              const void* sign, const void* sh, void* chans,
                              void* accum, int tiles, int rays, int k,
                              void* stream) {
  if (tiles == 0 || rays == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((rays + kThreads - 1) / kThreads, tiles);
  tracer_forward_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cnt), static_cast<const float*>(dirs),
      static_cast<const float*>(mind), static_cast<const float*>(t0),
      static_cast<const float*>(axes), static_cast<const float*>(plane),
      static_cast<const float*>(inv_scale), static_cast<const float*>(opac),
      static_cast<const float*>(sign), static_cast<const float*>(sh),
      static_cast<float*>(chans), static_cast<float*>(accum), rays, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tracer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
