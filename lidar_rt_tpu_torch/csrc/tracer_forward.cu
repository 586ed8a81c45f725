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
// What bounds it on this card (H100; numbers and the variants that lost in
// PERF.md, from chip_smoke.py): per (ray, candidate) pair the intersection
// and gates cost ~25 flops and one exp; a pair that passes the gates adds
// ~60 flops of SH shading and channel sums.  Device memory sees each
// tile's candidates once per block (64 floats each) and each ray's 16
// output rows once: at the flagship shapes (168 tiles x 1024 rays x 256
// candidates = 44 M pairs) ~1-2 GFLOP against ~15 MB.  The kernels follow
// the instructions they issue per (warp, candidate) step, not bandwidth:
// skipping steps, and fewer shared-memory loads per step, moved them;
// taking the per-step shuffle sums off a warp's chain, two candidates per
// step, smaller or larger blocks and more blocks per SM at fewer
// registers did not.
//
// Design: one thread per ray walks its tile's candidates front to back in
// tile order (the binner's nearest-first order) and keeps the transmittance
// in a register.  The first hit whose T*(1-alpha) falls below T_MIN stops
// the ray and is not composited: the live-prefix rule of
// lidar_rt_tpu/ops/geometry.py composite_weights.  A block of 128 rays
// stages kChunk candidates at a time in shared memory and stops staging
// once none of its rays is alive.  Each candidate is staged whole, as 16
// float4 groups (QuadCand), so a warp reads a group with one broadcast
// 16-byte load where rows of scalars took four.  Before a warp walks a
// group of 32 staged candidates it tests them at once, one per lane,
// against a box around its rays' directions (warp_cone, cone_misses in
// tracer_common.cuh, the backward's test), and visits only those the test
// cannot rule out: a skipped pair has alpha = 0 for every ray of the warp,
// which leaves T and every sum as they were (T stays at or above T_MIN once
// a ray has passed candidate 0, which is never skipped), so the channels
// are the same bits.  The SH basis lives in 16 registers, and shading runs
// only for pairs that pass the gates.  The per-candidate sums over rays
// go through a warp reduction into the register of the lane that owns the
// candidate in its group, and one coalesced atomicAdd per group into a
// zero-initialised (T, K) output: CUDA blocks run in no order, where the
// TPU kernel carried these sums across its sequential grid.  Registers
// are held to 80 (6 blocks per SM), and blocks take the tiles last-first,
// heavy ground tiles first.  The intersection, gates and shading are
// shared with the backward kernel (tracer_common.cuh), written with
// explicitly rounded operations so both kernels decide every gate alike.
//
// Exact mode (`exact` != 0) also replaces the in-kernel depth sort of the
// Pallas kernel, lidar_rt_tpu/ops/pallas_sort.py (pack_depth_keys,
// sort_lanes, unsort_lanes and their 256-lane _pair forms, called at
// pallas_tracer.py:265-273 and 351-373): each ray composites its
// gate-passing hits in ascending (t, candidate index) order at full float
// precision, the order of the reference's stable argsort, and is exact at
// every K it takes.  The bitonic lane network and key packing are TPU
// scaffolding and are not carried over.  Design: a block of kExactRays
// rays stages all K candidates of its tile at once, whole (64 KB at K =
// 256, in dynamic shared memory); each warp then lists, once and in
// ascending index order, the candidates its box test cannot rule out; and
// each thread walks its ray with the reference's own k-buffer
// (forward.cu:312-356): a pass scans the warp's list and keeps the
// kBuf nearest hits after a cursor in a sorted register buffer
// (tracer_common.cuh nearest_hits), then composites them in order; passes
// repeat until the ray stops or no hit is left.  A candidate off the list
// has alpha = 0 for every ray of the warp and could never enter the
// buffer, so the hits, their order and the channels are the same bits.
// No per-ray key storage is needed.  The lanes of a warp stand on
// different candidates, so the per-candidate sums go to K per-block
// accumulators in shared memory (shared-memory atomics), flushed with one
// global atomic per (block, candidate).  What bounds it: a pass costs a
// range test per listed candidate and the full intersection only for hits
// in the pass's window, so a ray with h hits before it stops pays about
// ceil(h / kBuf) + 1 scans of its warp's list.  The stage is per
// block, so 256-ray blocks stage each tile 4 times where 128-ray blocks
// staged it 8, and registers are held to 80 for 3 blocks (24 warps) per
// SM: the SH basis is made again after each scan rather than held
// through it, and the 16-entry buffer spills a little, which costs less
// than the rescans of a smaller one.  The stop rule, row 8 and the
// partial row 9 are the tile order's.
//
// Cache mode (tile order only; the reference's cache_fwd,
// pallas_tracer.py:286-296): tracer_forward_kernel<true> also writes, for
// every (ray, candidate) step its walk visits while the ray is alive (the
// step that stops the ray included), the two backward residuals the
// reference banks, as one __nv_bfloat162 (x, y) of a (T, K, R) array:
// x the gated alpha, negative where the ALPHA_MAX clamp held and zero
// where a gate failed; y the exclusive transmittance, negative where the
// float32 T_MIN live test failed (the stop).  Both are rounded to
// nearest, as astype(bfloat16) rounds.  Laid out (T, K, R), a visited step
// is one coalesced 128-byte store across the warp (the reference's (T, R,
// K) suits the TPU's lanes).  Steps the walk skips are never written.
// Each ray's last index, (T, R) int32, is the candidate that stopped it,
// or the tile's last candidate (count - 1: -1 for an empty tile) where no
// candidate did: the steps written are exactly those the box test leaves
// at or below it.  The cached backward (tracer_backward.cu) walks each
// ray from its last index down to candidate 0 through the same box test,
// reads only those steps, and sums each pair's suffix of gw w as it goes,
// so nothing else is kept (the reference's backward takes gw_total from
// the float32 channels, whose gap from the decoded weights' sums, about
// 2^-9 gw_total, reaches dL/dalpha divided by 1 - alpha).  A ray's index
// is stored once, at its stop or at the end of its walk, so the cache
// holds no register through the walk but the store's.  What the cache
// costs on this card is the store (its instructions and 47 MB of lines
// through L2 at the flagship training shape; with the store left out the
// instantiation ran as fast as the uncached one): it is a streaming store
// (st.global.cs), and this instantiation stages its candidates in rows of
// kQuads + 1 slots, where each read has a constant offset, in place of
// the swizzled rows (PERF.md; the uncached kernel keeps the layout it was
// measured with).  The channels and accum are the same bits with or
// without the cache.  The reference's
// fast_math relaxes its channel contractions to one bf16 pass; here the
// channel sums are each thread's own float32 FMAs, with no contraction
// to relax, so fast_math leaves the forward as it is.

#include <cuda_bf16.h>

#include "tracer_common.cuh"

namespace {

using namespace tracer;

constexpr int kChunk = 128;      // candidates staged per round (<= kThreads)
constexpr int kWarps = kThreads / 32;
constexpr int kExactRays = 256;  // rays per exact-order block
constexpr int kExactWarps = kExactRays / 32;

static_assert(kChunk <= kThreads && kChunk % 32 == 0,
              "each thread stages at most one candidate; whole groups");
static_assert(kExactRays % 32 == 0, "whole warps");

// The staged candidates, as nearest_hits reads them.
struct QuadStage {
  const float4* cands;
  __device__ __forceinline__ QuadCand operator()(int j) const {
    return quad_cand(cands, j);
  }
};

// The (T, 16, R) output rows of one ray.
__device__ __forceinline__ void store_channels(
    float* __restrict__ out, int rays, float acc_c0, float acc_c1,
    float acc_c2, float acc_t, float acc_w, float acc_n0, float acc_n1,
    float acc_n2, float trans0, float trans) {
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

// kCache: also write the backward's residuals to `cache` (T, K, R) and
// each ray's last index to `last` (T, R), see the file comment.
template <bool kCache>
__global__ void __launch_bounds__(kThreads, 6) tracer_forward_kernel(
    const int* __restrict__ cnt, const float* __restrict__ dirs,
    const float* __restrict__ mind, const float* __restrict__ t0,
    const float* __restrict__ axes, const float* __restrict__ plane,
    const float* __restrict__ inv_scale, const float* __restrict__ opac,
    const float* __restrict__ sign, const float* __restrict__ sh,
    float* __restrict__ chans, float* __restrict__ accum,
    __nv_bfloat162* __restrict__ cache, int* __restrict__ last, int rays,
    int k) {
  // The cache's instantiation stages in padded rows (quad_cand); the
  // other keeps the swizzled rows it was measured with.
  constexpr int kStride = kCache ? kQuads + 1 : kQuads;
  __shared__ float4 s_cand[kChunk * kStride];
  // Each warp's box, kept in shared memory: it is read once per 32
  // candidates, and registers are what limits this kernel's occupancy.
  __shared__ Cone s_cone[kWarps];

  // Tiles run last-first: a scan's tiles go from its top beam down, and
  // the lower ones, on the ground near the sensor, hold the most hits, so
  // they start first and the light ones fill the tail of the grid.
  const long long tile = gridDim.y - 1 - blockIdx.y;
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
  {
    const Cone cone = warp_cone(dx, dy, dz, has_ray);
    if (lane == 0) s_cone[threadIdx.x / 32] = cone;
    __syncwarp();
  }
  const Cone& cone = s_cone[threadIdx.x / 32];

  float trans = trans0;
  bool alive = has_ray;
  float acc_c0 = 0.0f, acc_c1 = 0.0f, acc_c2 = 0.0f, acc_t = 0.0f;
  float acc_w = 0.0f, acc_n0 = 0.0f, acc_n1 = 0.0f, acc_n2 = 0.0f;
  // kCache: this ray's steps of the (T, K, R) cache, candidate c at c rays.
  __nv_bfloat162* const cache_ray =
      kCache ? cache + tile * k * rays + ray : nullptr;

  const int count = min(max(cnt[tile], 0), k);
  for (int base = 0; base < count; base += kChunk) {
    // Barrier before shared memory is overwritten; the whole block stops
    // once none of its rays is alive.
    if (!__syncthreads_or(alive)) break;
    const int n = min(kChunk, count - base);
    if (threadIdx.x < n) {
      stage_quads<kStride>(s_cand, threadIdx.x, tile, k, base + threadIdx.x,
                           axes, plane, inv_scale, opac, sign, sh);
    }
    __syncthreads();

    for (int group = 0; group < n; group += 32) {
      if (!__any_sync(0xffffffffu, alive)) break;  // warp-uniform
      // Candidate 0 is always visited: a ray whose t0 is already below
      // T_MIN stops there.
      const int mine = group + lane;
      const bool visit = mine < n && ((base == 0 && mine == 0)
                                      || !cone_misses_cand(
                                          quad_cand<kStride>(s_cand, mine),
                                          cone));
      unsigned todo = __ballot_sync(0xffffffffu, visit);
      float own = 0.0f;  // lane l: the warp's sum of w on candidate group + l
      while (todo != 0u) {
        const int j = group + __ffs(todo) - 1;
        todo &= todo - 1u;
        float w = 0.0f;
        if (alive) {
          const QuadCand cand = quad_cand<kStride>(s_cand, j);
          const Hit h = intersect_cand(cand, dx, dy, dz, min_t);
          const float next = next_trans(trans, h.alpha);
          if (kCache) {
            const bool clamped = h.alpha > 0.0f && h.alpha_raw >= kAlphaMax;
            const __nv_bfloat162 res = __floats2bfloat162_rn(
                clamped ? -h.alpha : h.alpha, next < kTMin ? -trans : trans);
            __stcs(reinterpret_cast<unsigned*>(
                       cache_ray + static_cast<long long>(base + j) * rays),
                   reinterpret_cast<const unsigned&>(res));
            if (next < kTMin) last[ray_at] = base + j;
          }
          if (next < kTMin) {
            alive = false;  // the live prefix ends before this hit
            trans = next;
          } else if (h.alpha > 0.0f) {
            w = h.alpha * trans;
            trans = next;
            float c0, c1, c2;
            shade_cand(basis, cand, c0, c1, c2);
            const float3 nv = cand.normal();
            const float sw = w * cand.quad(3).w;
            acc_c0 += w * fmaxf(c0 + 0.5f, 0.0f);
            acc_c1 += w * c1;
            acc_c2 += w * c2;
            acc_t += w * h.t;
            acc_w += w;
            acc_n0 += sw * nv.x;
            acc_n1 += sw * nv.y;
            acc_n2 += sw * nv.z;
          }
        }
        if (__any_sync(0xffffffffu, w != 0.0f)) {
          const float sum = warp_all_sum(w);
          if (lane == j - group) own = sum;
        }
      }
      if (own != 0.0f) atomicAdd(&accum[tile * k + base + mine], own);
    }
  }

  if (has_ray) {
    store_channels(chans + tile * kOutRows * rays + ray, rays, acc_c0,
                   acc_c1, acc_c2, acc_t, acc_w, acc_n0, acc_n1, acc_n2,
                   trans0, trans);
    if (kCache && alive) last[ray_at] = count - 1;  // no candidate stopped it
  }
}

// Exact order: the same channels with each ray's hits composited in
// ascending (t, candidate index) order.  Dynamic shared memory: the tile's
// candidates staged whole (kQuads float4 each) and one accumulator row of
// k floats, then each warp's candidate list, k 16-bit indices each.
__global__ void __launch_bounds__(kExactRays, 3) tracer_forward_exact_kernel(
    const int* __restrict__ cnt, const float* __restrict__ dirs,
    const float* __restrict__ mind, const float* __restrict__ t0,
    const float* __restrict__ axes, const float* __restrict__ plane,
    const float* __restrict__ inv_scale, const float* __restrict__ opac,
    const float* __restrict__ sign, const float* __restrict__ sh,
    float* __restrict__ chans, float* __restrict__ accum, int rays, int k) {
  extern __shared__ float4 smem4[];
  float4* s_cand = smem4;
  float* s_acc = reinterpret_cast<float*>(smem4 + k * kQuads);
  unsigned short* list = reinterpret_cast<unsigned short*>(s_acc + k)
                         + (threadIdx.x / 32) * k;

  const long long tile = gridDim.y - 1 - blockIdx.y;  // last-first
  const int ray = blockIdx.x * kExactRays + threadIdx.x;
  const bool has_ray = ray < rays;
  const int lane = threadIdx.x & 31;
  const long long ray_at = tile * rays + ray;
  const int count = min(max(cnt[tile], 0), k);
  for (int c = threadIdx.x; c < count; c += kExactRays) {
    stage_quads(s_cand, c, tile, k, c, axes, plane, inv_scale, opac, sign,
                sh);
    s_acc[c] = 0.0f;
  }

  float dx = 0.0f, dy = 0.0f, dz = 0.0f, min_t = 0.0f;
  if (has_ray) {
    dx = dirs[ray_at * 3 + 0];
    dy = dirs[ray_at * 3 + 1];
    dz = dirs[ray_at * 3 + 2];
    min_t = mind[ray_at];
  }
  __syncthreads();

  // The warp's list, built once: the candidates its box test cannot rule
  // out, in ascending index order (ballot, then each survivor's rank).
  int listed = 0;
  {
    const Cone cone = warp_cone(dx, dy, dz, has_ray);
    for (int group = 0; group < count; group += 32) {
      const int mine = group + lane;
      const bool keep = mine < count
                        && !cone_misses_cand(quad_cand(s_cand, mine), cone);
      const unsigned votes = __ballot_sync(0xffffffffu, keep);
      if (keep) list[listed + __popc(votes & ((1u << lane) - 1u))] = mine;
      listed += __popc(votes);
    }
    __syncwarp();
  }

  float trans = has_ray ? t0[ray_at] : 0.0f;
  bool alive = has_ray;
  float acc_c0 = 0.0f, acc_c1 = 0.0f, acc_c2 = 0.0f, acc_t = 0.0f;
  float acc_w = 0.0f, acc_n0 = 0.0f, acc_n1 = 0.0f, acc_n2 = 0.0f;
  unsigned long long cur = 0;  // the walk's cursor: the last hit's key
  while (alive) {
    unsigned long long bk[kBuf];
    nearest_hits(QuadStage{s_cand}, CandList{list}, listed, dx, dy, dz,
                 min_t, cur, bk);
    // The basis is made again after each scan, from a copy of the
    // direction the compiler may not hoist, so that its 16 registers are
    // not held through the scan.
    float ux = dx, uy = dy, uz = dz;
    asm volatile("" : "+f"(ux), "+f"(uy), "+f"(uz));
    float basis[16];
    sh_basis(ux, uy, uz, basis);
#pragma unroll
    for (int b = 0; b < kBuf; ++b) {
      if (bk[b] == kEmptyKey) break;
      const int j = key_index(bk[b]);
      const QuadCand cand = quad_cand(s_cand, j);
      const Hit h = intersect_cand(cand, dx, dy, dz, min_t);
      const float next = next_trans(trans, h.alpha);
      if (next < kTMin) {
        alive = false;  // the live prefix ends before this hit
        trans = next;
        break;
      }
      const float w = h.alpha * trans;
      trans = next;
      float c0, c1, c2;
      shade_cand(basis, cand, c0, c1, c2);
      const float3 n = cand.normal();
      const float sw = w * cand.quad(3).w;
      acc_c0 += w * fmaxf(c0 + 0.5f, 0.0f);
      acc_c1 += w * c1;
      acc_c2 += w * c2;
      acc_t += w * h.t;
      acc_w += w;
      acc_n0 += sw * n.x;
      acc_n1 += sw * n.y;
      acc_n2 += sw * n.z;
      atomicAdd(&s_acc[j], w);
    }
    if (bk[kBuf - 1] == kEmptyKey) break;  // all composited
    cur = bk[kBuf - 1];
  }

  __syncthreads();
  for (int c = threadIdx.x; c < count; c += kExactRays) {
    if (s_acc[c] != 0.0f) atomicAdd(&accum[tile * k + c], s_acc[c]);
  }
  if (has_ray) {
    store_channels(chans + tile * kOutRows * rays + ray, rays, acc_c0,
                   acc_c1, acc_c2, acc_t, acc_w, acc_n0, acc_n1, acc_n2,
                   t0[ray_at], trans);
  }
}

// Dynamic shared memory of the exact kernel: k candidates staged whole and
// one accumulator row of k floats, and each warp's list of k 16-bit
// indices.
int exact_smem(int k) {
  return static_cast<int>(sizeof(float4)) * kQuads * k
         + static_cast<int>(sizeof(float)) * k
         + static_cast<int>(sizeof(unsigned short)) * kExactWarps * k;
}

}  // namespace

// Launches the kernel on `stream` over (tiles, rays, k), in exact order if
// `exact` is nonzero; returns the first CUDA error of the launch.  chans
// (tiles, 16, rays) need not be initialised; accum (tiles, k) must be zero.
// cache: null, or the (tiles, k, rays) __nv_bfloat162 residuals to write
// (tile order only), uninitialised: only the visited steps are written;
// last then the (tiles, rays) int32 last indices, uninitialised.
extern "C" int tracer_forward(const void* cnt, const void* dirs,
                              const void* mind, const void* t0,
                              const void* axes, const void* plane,
                              const void* inv_scale, const void* opac,
                              const void* sign, const void* sh, void* chans,
                              void* accum, void* cache, void* last,
                              int tiles, int rays, int k, int exact,
                              void* stream) {
  if ((exact && cache != nullptr)
      || ((cache == nullptr) != (last == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0 || rays == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<const int*>(cnt);
  const auto d = static_cast<const float*>(dirs);
  const auto md = static_cast<const float*>(mind);
  const auto tr = static_cast<const float*>(t0);
  const auto ax = static_cast<const float*>(axes);
  const auto pl = static_cast<const float*>(plane);
  const auto is = static_cast<const float*>(inv_scale);
  const auto op = static_cast<const float*>(opac);
  const auto sg = static_cast<const float*>(sign);
  const auto shc = static_cast<const float*>(sh);
  const auto ch = static_cast<float*>(chans);
  const auto ac = static_cast<float*>(accum);
  if (exact) {
    const int smem = exact_smem(k);
    const cudaError_t err = cudaFuncSetAttribute(
        tracer_forward_exact_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((rays + kExactRays - 1) / kExactRays, tiles);
    tracer_forward_exact_kernel<<<grid, kExactRays, smem, s>>>(
        c, d, md, tr, ax, pl, is, op, sg, shc, ch, ac, rays, k);
  } else {
    const dim3 grid((rays + kThreads - 1) / kThreads, tiles);
    const auto cc = static_cast<__nv_bfloat162*>(cache);
    if (cc != nullptr) {
      tracer_forward_kernel<true><<<grid, kThreads, 0, s>>>(
          c, d, md, tr, ax, pl, is, op, sg, shc, ch, ac, cc,
          static_cast<int*>(last), rays, k);
    } else {
      tracer_forward_kernel<false><<<grid, kThreads, 0, s>>>(
          c, d, md, tr, ax, pl, is, op, sg, shc, ch, ac, nullptr, nullptr,
          rays, k);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM (out[0]) and threads per block (out[1]) of device
// kernel `which` at k candidates per tile: 0 tile order, 1 exact order, 2
// tile order writing the cache.  Returns the first CUDA error.
extern "C" int tracer_forward_occupancy(int which, int k, int* out) {
  int blocks = 0;
  cudaError_t err;
  if (which == 1) {
    const int smem = exact_smem(k);
    err = cudaFuncSetAttribute(tracer_forward_exact_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tracer_forward_exact_kernel, kExactRays, smem);
    }
    out[1] = kExactRays;
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks,
        which == 2 ? tracer_forward_kernel<true> : tracer_forward_kernel<false>,
        kThreads, 0);
    out[1] = kThreads;
  }
  out[0] = blocks;
  return static_cast<int>(err);
}

extern "C" const char* tracer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
