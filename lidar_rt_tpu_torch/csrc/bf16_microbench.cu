// Packed-bfloat16 probe of a gate-shaped elementwise body, for Hopper
// (sm_90a).
//
// Replaces: scripts/bf16_microbench.py::_kernel, the Pallas TPU probe that
// asks whether bfloat16 elementwise arithmetic runs twice as fast as
// float32: it repeats a body shaped like the forward kernel's gate phase
// (multiplies and adds, an optional exp, a min and a clamp, a sum into an
// accumulator) `reps` times over a (rows, lanes) block in either type.
// Here the bfloat16 instantiation runs on packed __nv_bfloat162 pairs with
// the bf16x2 instructions (__hmul2_rn, __hadd2_rn, __hsub2_rn, __hmin2,
// __hmax2, __hneg2, h2exp), the float32 one on the same pairs of floats
// (__fmul_rn, __fadd_rn, __fsub_rn, fminf, fmaxf, expf), so the two
// differ only in the type of every operation.  Each multiply and each add
// of the reference's body is its own rounded operation, as on the TPU,
// whose vector unit has no fused multiply-add: a fused one (__hfma2)
// rounds once where the reference rounds twice, and in bfloat16 the
// accumulator's 64 roundings turn that into differences of up to 42 ulps
// from the reference (measured on the CPU), where the body as written
// agrees with it to the bit.  The plain PyTorch version is
// lidar_rt_tpu_torch/scripts/bf16_microbench.py::probe_reference.
//
// What bounds it on this card (H100): 16 operations an element a
// repetition (18 with the exp) over 67 TFLOP/s in float32, or over twice
// that for packed bfloat16 pairs (two results an instruction), against
// three (rows, lanes) arrays read or written once; at the reference's
// shape (512 x 1024, 64 repetitions) the operations bound it.  Since
// every multiply and add is rounded apart, the floor is the instructions
// the body issues, not the fused-multiply-add count behind 67 TFLOP/s:
// ~16 an element a repetition in float32 (0.0160 ms at the reference's
// shape, 132 SMs issuing 128 lanes a clock at 1.98 GHz) and about as many
// a packed pair in bfloat16, plus the exp's MUFU at 16 lanes a clock an
// SM; lidar_rt_tpu_torch/scripts/sass_floor.py counts them in the SASS.
//
// Design: one thread per pair of adjacent elements, in registers for all
// repetitions; the accumulator is written once.  As in the reference, each
// repetition adds 1e-6 to `a`, so no repetition can be hoisted out of the
// loop.  The compiler unrolls the repetitions (by four, two in float32
// with the exp), which gives each warp independent instructions enough:
// a design with 16 bytes a thread (two float32 pairs or four bfloat16
// pairs, one chain each, interleaved), in a grid of one wave with a
// stride loop, issued the same instructions an element and ran 1-8%
// slower in every mode (PERF.md), so it was not kept.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Two elements in float32 or in one packed bfloat16 pair, and the body's
// operations on them.
template <bool BF16>
struct Pair;

template <>
struct Pair<true> {
  using V = __nv_bfloat162;
  static __device__ V splat(float x) { return __float2bfloat162_rn(x); }
  // The _rn forms: ptxas may contract a plain __hmul2 and __hadd2 into
  // one fused multiply-add.
  static __device__ V mul(V a, V b) { return __hmul2_rn(a, b); }
  static __device__ V add(V a, V b) { return __hadd2_rn(a, b); }
  static __device__ V sub(V a, V b) { return __hsub2_rn(a, b); }
  static __device__ V min(V a, V b) { return __hmin2(a, b); }
  static __device__ V max(V a, V b) { return __hmax2(a, b); }
  static __device__ V exp_neg(V a) { return h2exp(__hneg2(a)); }
};

template <>
struct Pair<false> {
  using V = float2;
  static __device__ V splat(float x) { return make_float2(x, x); }
  // Rounded apart, never contracted into a fused multiply-add.
  static __device__ V mul(V a, V b) {
    return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
  }
  static __device__ V add(V a, V b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
  }
  static __device__ V sub(V a, V b) {
    return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
  }
  static __device__ V min(V a, V b) {
    return make_float2(fminf(a.x, b.x), fminf(a.y, b.y));
  }
  static __device__ V max(V a, V b) {
    return make_float2(fmaxf(a.x, b.x), fmaxf(a.y, b.y));
  }
  static __device__ V exp_neg(V a) {
    return make_float2(expf(-a.x), expf(-a.y));
  }
};

template <bool BF16, bool EXP>
__global__ void __launch_bounds__(kThreads)
probe_gate_kernel(const typename Pair<BF16>::V* __restrict__ a_in,
                  const typename Pair<BF16>::V* __restrict__ b_in,
                  typename Pair<BF16>::V* __restrict__ out, int pairs,
                  int reps) {
  using P = Pair<BF16>;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= pairs) return;
  const auto half = P::splat(0.5f);
  const auto amax = P::splat(0.99f), amin = P::splat(1.0f / 255.0f);
  const auto zero = P::splat(0.0f), eps = P::splat(1e-6f);
  auto a = a_in[i];
  const auto b = b_in[i];
  auto acc = zero;
  for (int rep = 0; rep < reps; ++rep) {
    const auto u = P::add(P::mul(a, b), half);
    const auto v = P::sub(P::mul(u, a), half);
    const auto s = P::add(P::mul(u, u), P::mul(v, v));
    auto g = s;
    if constexpr (EXP) g = P::exp_neg(s);
    const auto al = P::min(amax, P::mul(g, b));
    const auto gate = P::max(P::min(P::mul(P::sub(al, amin), amax), amax),
                             zero);
    acc = P::add(acc, P::mul(al, gate));
    a = P::add(a, eps);
  }
  out[i] = acc;
}

template <bool BF16, bool EXP>
cudaError_t launch(const void* a, const void* b, void* out, int elements,
                   int reps, cudaStream_t s) {
  using V = typename Pair<BF16>::V;
  const int pairs = elements / 2;
  probe_gate_kernel<BF16, EXP><<<(pairs + kThreads - 1) / kThreads,
                                 kThreads, 0, s>>>(
      static_cast<const V*>(a), static_cast<const V*>(b),
      static_cast<V*>(out), pairs, reps);
  return cudaGetLastError();
}

}  // namespace

// Launch the probe on `stream` over `elements` (even) contiguous elements
// of a, b and out, in bfloat16 (`bf16` != 0) or float32, with or without
// the exp, `reps` repetitions.  Returns the first CUDA error.
extern "C" int bf16_microbench(const void* a, const void* b, void* out,
                               int elements, int reps, int bf16,
                               int with_exp, void* stream) {
  if (elements < 2 || elements % 2 != 0 || reps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = with_exp ? launch<true, true>(a, b, out, elements, reps, s)
                   : launch<true, false>(a, b, out, elements, reps, s);
  } else {
    err = with_exp ? launch<false, true>(a, b, out, elements, reps, s)
                   : launch<false, false>(a, b, out, elements, reps, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
