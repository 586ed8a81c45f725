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
//
// Design: one thread per ray walks its tile's K candidates in order and
// keeps its sums (and, from `scan` on, the transmittance as a running
// product: the reference's lane_cumprod_excl) in registers.  A block of
// 128 rays of one tile first stages the candidate rows its level reads
// (3, 14, 15 or all 63 of a candidate's floats, as rows of K) in shared
// memory, where every thread reads the same candidate at once (a
// broadcast).  `full` and its variants dot each pair's 16 SH coefficients
// per channel with the ray's 16 basis values (held in registers) in the
// kernel's own body.  Each ray's 16 output rows are written once, adjacent
// rays to adjacent addresses.  No step is skipped: the probe measures the
// body's cost per pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <utility>

namespace {

// The reference's levels, in kernel_microbench.py LEVELS order.
enum Level {
  kMinimal = 0, kChain, kChainBf16, kBroadcasts, kIntersect, kScan, kFull,
  kNoDiv, kNoExp, kRowLoop, kNumLevels
};

constexpr int kThreads = 128;
constexpr int kOutRows = 16;
// Candidate rows: axes (n, w1, w2; rows 0-8), plane (p, a_u, a_v; 3), inverse
// scales (2), opacity (1), SH (3 x 16).
constexpr int kPlane = 9, kScale = 12, kOpac = 14, kSh = 15;
constexpr int kRows = 63;

// The candidate rows a level reads, from row 0.
__host__ __device__ constexpr int level_rows(int level) {
  return level <= kChainBf16 ? 3
         : level == kBroadcasts ? kOpac
         : (level == kIntersect || level == kScan || level == kRowLoop)
             ? kSh
             : kRows;
}

__host__ __device__ constexpr bool is_full(int level) {
  return level == kFull || level == kNoDiv || level == kNoExp;
}

template <int LEVEL>
__global__ void __launch_bounds__(kThreads)
probe_ablation_kernel(const float* __restrict__ dirs,
                      const float* __restrict__ basis,
                      const float* __restrict__ axes,
                      const float* __restrict__ plane,
                      const float* __restrict__ scale,
                      const float* __restrict__ opac,
                      const float* __restrict__ sh,
                      float* __restrict__ out, int rays, int k) {
  extern __shared__ float cand[];           // level_rows(LEVEL) rows of k
  constexpr int rows = level_rows(LEVEL);
  const int t = blockIdx.y;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  for (int i = threadIdx.x; i < rows * k; i += kThreads) {
    const int row = i / k, col = i - row * k;
    float v;
    if (row < kPlane) v = axes[(t * 9 + row) * k + col];
    else if (row < kScale) v = plane[(t * 3 + row - kPlane) * k + col];
    else if (row < kOpac) v = scale[(t * 2 + row - kScale) * k + col];
    else if (row < kSh) v = opac[t * k + col];
    else v = sh[(t * 48 + row - kSh) * k + col];
    cand[i] = v;
  }
  __syncthreads();
  if (r >= rays) return;
  const float d0 = dirs[(t * rays + r) * 3 + 0];
  const float d1 = dirs[(t * rays + r) * 3 + 1];
  const float d2 = dirs[(t * rays + r) * 3 + 2];
  float bas[16];
  if constexpr (is_full(LEVEL)) {
#pragma unroll
    for (int j = 0; j < 16; ++j) bas[j] = basis[(t * rays + r) * 16 + j];
  }
  float sums[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float trans = 1.0f;                        // the exclusive running product

  if constexpr (LEVEL == kChainBf16) {
    const __nv_bfloat162 c_mul = __float2bfloat162_rn(1.0001f);
    const __nv_bfloat162 c_add = __float2bfloat162_rn(0.1f);
    const __nv_bfloat162 c_shrink = __float2bfloat162_rn(0.9999f);
    for (int j = 0; j < k; j += 2) {
      // qd rounded product by product and sum by sum, as the reference
      // takes it: a fused multiply-add would move a float32 ulp, and so
      // sometimes a bfloat16 one in the conversion.
      const float* c = cand + j;             // candidate j's row 0
      const float qa = __fadd_rn(__fadd_rn(__fmul_rn(d0, c[0]),
                                           __fmul_rn(d1, c[k])),
                                 __fmul_rn(d2, c[2 * k]));
      const float qb = __fadd_rn(__fadd_rn(__fmul_rn(d0, c[1]),
                                           __fmul_rn(d1, c[k + 1])),
                                 __fmul_rn(d2, c[2 * k + 1]));
      __nv_bfloat162 x = __floats2bfloat162_rn(qa, qb);
#pragma unroll
      for (int rep = 0; rep < 8; ++rep) {
        // c_mul and c_shrink round to 1.0 in bfloat16, so the multiply-add
        // rounds once where the reference's multiply (exact) and add do.
        x = __hfma2(x, c_mul, c_add);
        x = __hmax2(__hmul2(x, c_shrink), __hsub2(x, c_add));
      }
      sums[0] += __low2float(x);
      sums[0] += __high2float(x);
    }
  } else {
    for (int j = 0; j < k; ++j) {
      const float* c = cand + j;             // candidate j's row i: c[i * k]
      const float n0 = c[0], n1 = c[k], n2 = c[2 * k];
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
        float x = qd;
        x = x + d0 * c[kPlane * k] + d1 * c[(kPlane + 1) * k]
            + d2 * c[(kPlane + 2) * k];
        x = x + d0 * c[kScale * k] + d1 * c[(kScale + 1) * k]
            + d2 * n0;
        sums[0] += x;
      } else {
        const float b_u = d0 * c[3 * k] + d1 * c[4 * k]
                          + d2 * c[5 * k];
        const float b_v = d0 * c[6 * k] + d1 * c[7 * k]
                          + d2 * c[8 * k];
        const float p = c[kPlane * k];
        const bool qd_ok = fabsf(qd) > 1e-8f;
        const float safe_qd = qd_ok ? qd : 1e-8f;
        const float tt = LEVEL == kNoDiv ? p * safe_qd : p / safe_qd;
        const float u = (c[(kPlane + 1) * k] + tt * b_u)
                        * c[kScale * k];
        const float v = (c[(kPlane + 2) * k] + tt * b_v)
                        * c[(kScale + 1) * k];
        const float dd = u * u + v * v;
        float g;
        if constexpr (LEVEL == kNoExp) {
          const float q = fmaxf(1.0f - 0.25f * dd, 0.0f);
          g = q * q;
        } else {
          g = expf(-0.5f * dd);
        }
        const float alpha_raw = fminf(0.99f, c[kOpac * k] * g);
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
            float col[3];
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
              float dot = 0.0f;
#pragma unroll
              for (int i = 0; i < 16; ++i) {
                dot += bas[i] * c[(kSh + 16 * ch + i) * k];
              }
              col[ch] = dot + 0.5f;
            }
            sums[0] += w * fmaxf(col[0], 0.0f);
            sums[1] += w * col[1];
            sums[2] += w * col[2];
            sums[3] += w * tt;
            sums[4] += w;
            sums[5] += w * n0;
            sums[6] += w * n1;
            sums[7] += w * n2;
          }
        }
      }
    }
  }
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
  const int smem = level_rows(LEVEL) * k * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      probe_ablation_kernel<LEVEL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rays + kThreads - 1) / kThreads, tiles);
  probe_ablation_kernel<LEVEL><<<grid, kThreads, smem, s>>>(
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
// K even (chain_bf16 packs candidate pairs) and at most 896 (63 rows of K
// floats in a block's shared memory).  Returns the first CUDA error.
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
