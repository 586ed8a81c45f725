// Ablation probe of the forward tracer kernel's body, for Hopper (sm_90a).
//
// Replaces: scripts/kernel_microbench.py::kernel and ::_rowloop_kernel, the
// Pallas TPU probe launched by its run(): synthetic candidates in the
// forward kernel's layout, one (T, R) grid, and ablation levels that stack
// the body's stages (the intersection's dot products, a chain of
// elementwise operations, broadcasts, the divide, the exp, the gates, the
// transmittance scan, the SH shading and the channel sums), each writing a
// (T, 16, R) float32 block.  Every level of the reference is here, with
// its arithmetic: `nodiv` keeps the deliberately wrong p * safe_qd in
// place of the divide, `noexp` the polynomial in place of the exp, and
// `rowloop` computes what `intersect` computes (its 8-row grouping is the
// TPU's vector-register layout and has no counterpart in a thread per ray;
// its question, whether the intermediates stay in registers, is answered
// by the ptxas report of each level's instantiation).  `chain_bf16` runs
// its chain on packed __nv_bfloat162, two candidates a thread a step.
// The plain PyTorch version of every level is
// lidar_rt_tpu_torch/scripts/kernel_microbench.py::ablation_reference.
//
// What bounds it on this card (H100): per (ray, candidate) pair 6 to ~165
// float32 operations by level (kernel_microbench.py OPS_PER_PAIR) over
// 67 TFLOP/s, against ~25 MB of inputs and outputs at the reference's
// shape (T=42, R=4096, K=128: 22 M pairs) over 3.35 TB/s; every level
// from `chain` on is bound by its operations, `minimal` by its bytes.
// The operations count each multiply and add apart; the body as the
// compiler issues it (fused multiply-adds, an exp of ~8 instructions, an
// IEEE divide of ~9, the gates' compares and selects) is the floor that
// lidar_rt_tpu_torch/scripts/sass_floor.py reads from the SASS.
//
// What held the first design back (it staged each candidate field as its
// own row of K scalars): a pair read every field with its own broadcast
// 32-bit shared load at an offset that is a multiple of the runtime K,
// 3 loads a pair at `minimal`, 8 at `broadcasts`, 15 at `intersect` and
// `scan`, 63 at `full`; at 1.2-2.0 SM clocks a load the ladder priced
// those loads, not the body.  The production forward
// (tracer_forward.cu) had already left that layout for whole float4
// candidates.
//
// Design: the forward kernel's own layout and helpers.  A block of kRays
// rays of one tile stages kChunk candidates at a time in the 16 float4
// groups of tracer_common.cuh's QuadCand (stage_quads, in rows of
// kQuads + 1 slots, one of padding, so every read has a constant offset),
// so a pair reads one 16-byte broadcast load at `minimal` and the chains
// (group 0), four at `broadcasts`, `intersect` and `scan`, and sixteen at
// `full`; a level stages only the groups it reads, since every block
// stages its tile's candidates again (staging all 16 at every level cost
// `minimal` 31% and the levels up to `scan` 4-7% at K = 128, PERF.md).  The
// probe's candidate has no sign (the reference takes ones,
// scripts/kernel_microbench.py:136) and no level reads that slot: it is
// staged from the opacities, so the C entry point takes the arrays it
// always took.  One thread per ray walks the candidates in
// order and keeps its sums (and, from `scan` on, the transmittance as a
// running product: the reference's lane_cumprod_excl) in registers;
// `full` and its variants shade through the forward's own shade_cand,
// the same sequential 16-term fused multiply-adds per channel as the
// first design's loop, with the ray's 16 basis values in registers.
// Every pair's expression is the first design's, so each level gives its
// outputs to the bit.  Tensor cores take no part: the forward shades each
// composited hit in SIMT from registers, and this probe prices that body;
// a dense SH pass on mma would price another design.  Each ray's 16
// output rows are written once, adjacent rays to adjacent addresses.  No
// step is skipped: the probe measures the body's cost per pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <utility>

#include "tracer_common.cuh"

namespace {

using tracer::QuadCand;

// The reference's levels, in kernel_microbench.py LEVELS order.
enum Level {
  kMinimal = 0, kChain, kChainBf16, kBroadcasts, kIntersect, kScan, kFull,
  kNoDiv, kNoExp, kRowLoop, kNumLevels
};

// Rays a block.  The reference's 42 tiles of 4096 rays make 5,376
// warps, 40.7 an SM.  The levels up to `scan` hold 32-40 registers a
// thread: blocks of 6 warps (22 a tile, the last of 64 rays) fit seven to
// an SM, 924 places, and take them all in one wave, where blocks of 8
// would take 672 places of 660 at the six to an SM that their shared
// memory allowed, and the last 12 would run as a second wave.  `full` and
// its variants are bound by their sixteen 16-byte shared loads a pair
// (PERF.md), not by occupancy: at 48 registers (five blocks of 8 warps to
// an SM) and at the 80 that ptxas takes uncapped (three) they ran alike;
// capped at 40 for seven blocks of 6 warps they spilled 244 bytes and ran
// 3.4x as long, and capped at 48 by __launch_bounds__ they spilled 164 and
// ran 1.8x.  So they take blocks of 8 warps and no cap.  kChunk candidates
// in rows of 17 slots take 17,408 bytes, so seven blocks fit in an SM's
// shared memory (128 would take 34,816, six).
constexpr int kRays = 192;
constexpr int kFullRays = 256;
constexpr int kChunk = 64;
constexpr int kStride = tracer::kQuads + 1;
constexpr int kOutRows = 16;
static_assert(kChunk <= kRays && kChunk % 2 == 0, "staging");

__host__ __device__ constexpr bool is_full(int level) {
  return level == kFull || level == kNoDiv || level == kNoExp;
}

__host__ __device__ constexpr int level_rays(int level) {
  return is_full(level) ? kFullRays : kRays;
}

// The float4 groups a level reads, staged as a prefix of the candidate:
// group 0 (n, p) up to the chains, the four of the geometry up to `scan`,
// all 16 from `full` on.
__host__ __device__ constexpr int level_groups(int level) {
  return level <= kChainBf16 ? 1 : is_full(level) ? tracer::kQuads : 4;
}

// One (ray, candidate) pair of every level but chain_bf16: the first
// design's expressions, on the candidate's float4 groups.
template <int LEVEL>
__device__ __forceinline__ void pair_body(const QuadCand& c, float d0,
                                          float d1, float d2,
                                          const float (&bas)[16],
                                          float (&sums)[8], float& trans) {
  const float4 q0 = c.quad(0);
  const float n0 = q0.x, n1 = q0.y, n2 = q0.z;
  const float qd = d0 * n0 + d1 * n1 + d2 * n2;
  if constexpr (LEVEL == kMinimal) {
    sums[0] += qd;
  } else if constexpr (LEVEL == kChain) {
    float x = qd;
#pragma unroll
    for (int rep = 0; rep < 8; ++rep) {
      x = x * 1.0001f + 0.1f;
      x = fmaxf(x * 0.9999f, x - 0.1f);
    }
    sums[0] += x;
  } else if constexpr (LEVEL == kBroadcasts) {
    const tracer::GeoBack b = c.back();
    float x = qd;
    x = x + d0 * q0.w + d1 * b.w1.w + d2 * b.w2.w;
    x = x + d0 * b.m.x + d1 * b.m.y + d2 * n0;
    sums[0] += x;
  } else {
    const tracer::GeoBack b = c.back();  // (w1, a_u), (w2, a_v), (1/s, op)
    const float b_u = d0 * b.w1.x + d1 * b.w1.y + d2 * b.w1.z;
    const float b_v = d0 * b.w2.x + d1 * b.w2.y + d2 * b.w2.z;
    const float p = q0.w;
    const bool qd_ok = fabsf(qd) > 1e-8f;
    const float safe_qd = qd_ok ? qd : 1e-8f;
    const float tt = LEVEL == kNoDiv ? p * safe_qd : p / safe_qd;
    const float u = (b.w1.w + tt * b_u) * b.m.x;
    const float v = (b.w2.w + tt * b_v) * b.m.y;
    const float dd = u * u + v * v;
    float g;
    if constexpr (LEVEL == kNoExp) {
      const float q = fmaxf(1.0f - 0.25f * dd, 0.0f);
      g = q * q;
    } else {
      g = expf(-0.5f * dd);
    }
    const float alpha_raw = fminf(0.99f, b.m.z * g);
    const bool ok = tt >= 0.2f && qd_ok && p != 0.0f
                    && alpha_raw >= 0.004f;
    const float alpha = ok ? alpha_raw : 0.0f;
    if constexpr (LEVEL == kIntersect || LEVEL == kRowLoop) {
      sums[0] += alpha;
    } else {
      const float one_m = 1.0f - alpha;
      const float t_incl = trans * one_m;
      const float w = t_incl >= 1e-4f ? alpha * trans : 0.0f;
      trans = t_incl;
      if constexpr (LEVEL == kScan) {
        sums[0] += w;
      } else {
        float c0, c1, c2;
        tracer::shade_cand(bas, c, c0, c1, c2);
        sums[0] += w * fmaxf(c0 + 0.5f, 0.0f);
        sums[1] += w * (c1 + 0.5f);
        sums[2] += w * (c2 + 0.5f);
        sums[3] += w * tt;
        sums[4] += w;
        sums[5] += w * n0;
        sums[6] += w * n1;
        sums[7] += w * n2;
      }
    }
  }
}

// chain_bf16 on candidates a and b (their group 0): two lanes of one
// packed chain.
__device__ __forceinline__ void chain_bf16_body(const QuadCand& ca,
                                                const QuadCand& cb,
                                                float d0, float d1, float d2,
                                                float& sum) {
  const __nv_bfloat162 c_mul = __float2bfloat162_rn(1.0001f);
  const __nv_bfloat162 c_add = __float2bfloat162_rn(0.1f);
  const __nv_bfloat162 c_shrink = __float2bfloat162_rn(0.9999f);
  const float4 a = ca.quad(0), b = cb.quad(0);
  // qd rounded product by product and sum by sum, as the reference takes
  // it: a fused multiply-add would move a float32 ulp, and so sometimes a
  // bfloat16 one in the conversion.
  const float qa = __fadd_rn(__fadd_rn(__fmul_rn(d0, a.x), __fmul_rn(d1, a.y)),
                             __fmul_rn(d2, a.z));
  const float qb = __fadd_rn(__fadd_rn(__fmul_rn(d0, b.x), __fmul_rn(d1, b.y)),
                             __fmul_rn(d2, b.z));
  __nv_bfloat162 x = __floats2bfloat162_rn(qa, qb);
#pragma unroll
  for (int rep = 0; rep < 8; ++rep) {
    // c_mul and c_shrink round to 1.0 in bfloat16, so the multiply-add
    // rounds once where the reference's multiply (exact) and add do.
    x = __hfma2(x, c_mul, c_add);
    x = __hmax2(__hmul2(x, c_shrink), __hsub2(x, c_add));
  }
  sum += __low2float(x);
  sum += __high2float(x);
}

template <int LEVEL>
__global__ void __launch_bounds__(level_rays(LEVEL))
probe_ablation_kernel(const float* __restrict__ dirs,
                      const float* __restrict__ basis,
                      const float* __restrict__ axes,
                      const float* __restrict__ plane,
                      const float* __restrict__ scale,
                      const float* __restrict__ opac,
                      const float* __restrict__ sh,
                      float* __restrict__ out, int rays, int k) {
  constexpr int kBlock = level_rays(LEVEL);
  __shared__ float4 s_cand[kChunk * kStride];
  const int t = blockIdx.y;
  const int r = blockIdx.x * kBlock + threadIdx.x;
  const bool live = r < rays;
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
  float bas[16];
  if (live) {
    const long long at = static_cast<long long>(t) * rays + r;
    d0 = dirs[at * 3 + 0];
    d1 = dirs[at * 3 + 1];
    d2 = dirs[at * 3 + 2];
    if constexpr (is_full(LEVEL)) {
#pragma unroll
      for (int j = 0; j < 16; ++j) bas[j] = basis[at * 16 + j];
    }
  }
  float sums[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float trans = 1.0f;                        // the exclusive running product

  for (int base = 0; base < k; base += kChunk) {
    const int n = min(kChunk, k - base);     // even: K is
    __syncthreads();                         // the last chunk's reads done
    if (threadIdx.x < n) {
      tracer::stage_quads<kStride, level_groups(LEVEL)>(
          s_cand, threadIdx.x, t, k, base + threadIdx.x, axes, plane, scale,
          opac, opac, sh);
    }
    __syncthreads();
    if (!live) continue;
    // Two candidates a trip, in order (chain_bf16 packs them).
#pragma unroll 1
    for (int j = 0; j < n; j += 2) {
      const QuadCand ca = tracer::quad_cand<kStride>(s_cand, j);
      const QuadCand cb = tracer::quad_cand<kStride>(s_cand, j + 1);
      if constexpr (LEVEL == kChainBf16) {
        chain_bf16_body(ca, cb, d0, d1, d2, sums[0]);
      } else {
        pair_body<LEVEL>(ca, d0, d1, d2, bas, sums, trans);
        pair_body<LEVEL>(cb, d0, d1, d2, bas, sums, trans);
      }
    }
  }
  if (!live) return;
  float* o = out + static_cast<size_t>(t) * kOutRows * rays + r;
#pragma unroll
  for (int row = 0; row < kOutRows; ++row) {
    o[static_cast<size_t>(row) * rays] =
        is_full(LEVEL) ? (row < 8 ? sums[row] : 0.0f) : sums[0];
  }
}

template <int LEVEL>
cudaError_t launch(const float* dirs, const float* basis, const float* axes,
                   const float* plane, const float* scale, const float* opac,
                   const float* sh, float* out, int tiles, int rays, int k,
                   cudaStream_t s) {
  // As much of an SM's memory for shared memory as it takes.
  const cudaError_t err = cudaFuncSetAttribute(
      probe_ablation_kernel<LEVEL>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  constexpr int block = level_rays(LEVEL);
  const dim3 grid((rays + block - 1) / block, tiles);
  probe_ablation_kernel<LEVEL><<<grid, block, 0, s>>>(
      dirs, basis, axes, plane, scale, opac, sh, out, rays, k);
  return cudaGetLastError();
}

template <int... L>
cudaError_t dispatch(int level, std::integer_sequence<int, L...>,
                     const float* dirs, const float* basis,
                     const float* axes, const float* plane,
                     const float* scale, const float* opac, const float* sh,
                     float* out, int tiles, int rays, int k,
                     cudaStream_t s) {
  cudaError_t err = cudaErrorInvalidValue;
  ((level == L ? (err = launch<L>(dirs, basis, axes, plane, scale, opac, sh,
                                  out, tiles, rays, k, s), 0) : 0), ...);
  return err;
}

}  // namespace

// Launch level `level` of the probe on `stream`: dirs (T, R, 3), basis
// (T, R, 16), axes (T, 3, 3, K), plane (T, 3, K), scale (T, 2, K), opac
// (T, 1, K), sh (T, 3, 16, K), out (T, 16, R), all float32 and contiguous;
// K even (chain_bf16 packs candidate pairs, every level takes two a step)
// and at most 896, the first design's limit, kept so that both take the
// same inputs.  Returns the first CUDA error.
extern "C" int kernel_microbench(const void* dirs, const void* basis,
                                 const void* axes, const void* plane,
                                 const void* scale, const void* opac,
                                 const void* sh, void* out, int tiles,
                                 int rays, int k, int level, void* stream) {
  if (level < 0 || level >= kNumLevels || k < 2 || k % 2 != 0
      || k > 896) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dispatch(
      level, std::make_integer_sequence<int, kNumLevels>{},
      static_cast<const float*>(dirs), static_cast<const float*>(basis),
      static_cast<const float*>(axes), static_cast<const float*>(plane),
      static_cast<const float*>(scale), static_cast<const float*>(opac),
      static_cast<const float*>(sh), static_cast<float*>(out), tiles, rays,
      k, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
