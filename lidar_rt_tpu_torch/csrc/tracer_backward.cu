// Backward surfel tracer kernel for Hopper (sm_90a): the hand-derived VJP
// of tracer_forward.cu.
//
// Replaces: lidar_rt_tpu/ops/pallas_backward.py::_backward_kernel, the
// Pallas TPU backward kernel launched by backward_pallas_call, together
// with the in-kernel helper it calls from lidar_rt_tpu/ops/pallas_common.py:
// lane_cumsum, the per-chunk prefix of dL/dw * w, becomes the running
// per-ray prefix in a register.  Mode: tile order, f32, replay (the
// forward's residuals are recomputed, not cached).  The boundary is the
// Pallas kernel's: the forward's inputs plus the forward channels and their
// upstream gradients, both channel-major (T, 16, R); the output is one
// zero-initialised (T, 64, K) buffer whose rows are d_axes (0-8, as
// (3, 3)), d_plane (9-11), d_inv_scale (12-13), d_opac (14), a zero row
// (15) and d_sh (16-63, as (3, 16)), each summed over the tile's rays.
// lidar_rt_tpu_torch/ops/kernels.py splits it into the five gradients.
//
// The math (per ray, per candidate j composited front to back):
//   gw_j     = dL/dw_j = sum_ch g_ch c_ch,j  (channels 0-7 of the forward)
//   A_j      = sum_{k>j} gw_k w_k = gw_total - prefix_j, with gw_total =
//              sum_ch g_ch S_ch from the forward's totals
//   dL/da_j  = gw_j T_j - (A_j + g_8 T_out + g_9 T_raw) / max(1 - a_j, 1e-6)
// zero where a gate failed or the ALPHA_MAX clamp held, then
//   a -> (opacity, G) -> (u, v) -> (a_u, a_v, 1/s, t) -> (p, n.d, w1.d,
//   w2.d) -> axes, plus the direct depth (w t) and normal (w sign n) terms,
// and per-hit colours -> SH: d_sh[ch][s] = sum_rays basis_s x_ch, with
// x_0 = g_0 w gated on c_0 + 0.5 > 0, x_1 = g_1 w, x_2 = g_2 w.
//
// Stop rule: the forward stops a ray at the first hit whose T (1 - a)
// falls below T_MIN and never composites it.  This kernel replays the same
// decisions through the shared tracer_common.cuh and stops at the same hit:
// pairs past it contribute nothing, and the stop hit itself only through
// the raw-transmittance row 9 (g_9 T_raw), whose forward value includes it.
// (The Pallas kernel zeroes past-the-stop pairs per 128-candidate chunk
// only.)  The training loss never reads row 9, so g_9 = 0 on the main
// path; where g_9 != 0 the tests use scenes in which no ray reaches T_MIN,
// since there the plain twin's row 9 is the full product over every pair.
//
// What bounds it on this card: the replay costs what the forward costs
// (~25 flops and an exp per pair, ~60 more per composited pair); the
// gradient chain adds ~60 flops per composited pair.  The sums over rays
// dominate: 63 values per (candidate, ray) pair, where the forward reduces
// one.  A warp reduces them with a transposing butterfly: at each of five
// steps every lane trades half of its values with its partner, so 32
// values cost 31 shuffles in all (instead of 5 each) and lane l ends with
// the warp's total of value l.  One atomicAdd per lane then lands 32 sums
// at once, two rounds per (warp, candidate).  A warp skips a candidate
// where none of its lanes has a nonzero contribution, and a zero sum is not
// added.  Reducing across the block's warps in shared memory before the
// atomics, and splitting K across warps for occupancy, are later work.

#include "tracer_common.cuh"

namespace {

using namespace tracer;

constexpr int kGradRows = 64;  // rows of the (T, 64, K) gradient output
constexpr int kShRow = 16;     // first d_sh row

// One butterfly step: a lane keeps the half of its kHalf * 2 live values
// selected by its lane bit kHalf and adds its partner's copy of that half.
template <int kHalf>
__device__ __forceinline__ void butterfly_step(float (&v)[32], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
}

// Lane l of the warp returns the sum over the warp's lanes of v[l]; v is
// clobbered.  Every index is a compile-time constant, so v stays in
// registers.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32],
                                                    int lane) {
  butterfly_step<16>(v, lane);
  butterfly_step<8>(v, lane);
  butterfly_step<4>(v, lane);
  butterfly_step<2>(v, lane);
  butterfly_step<1>(v, lane);
  return v[0];
}

__device__ __forceinline__ void add_row(float* __restrict__ grads,
                                        long long tile, int row, int k,
                                        int cand, float value) {
  if (value != 0.0f) {
    atomicAdd(&grads[(tile * kGradRows + row) * k + cand], value);
  }
}

__global__ void __launch_bounds__(kThreads) tracer_backward_kernel(
    const int* __restrict__ cnt, const float* __restrict__ dirs,
    const float* __restrict__ mind, const float* __restrict__ t0,
    const float* __restrict__ axes, const float* __restrict__ plane,
    const float* __restrict__ inv_scale, const float* __restrict__ opac,
    const float* __restrict__ sign, const float* __restrict__ sh,
    const float* __restrict__ fwd_chans, const float* __restrict__ g_chans,
    float* __restrict__ grads, int rays, int k) {
  __shared__ float s_geo[kGeo][kChunk];
  __shared__ float s_sh[kSh][kChunk];

  const long long tile = blockIdx.y;
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool has_ray = ray < rays;
  const int lane = threadIdx.x & 31;
  const long long ray_at = tile * rays + ray;

  float dx = 0.0f, dy = 0.0f, dz = 0.0f, min_t = 0.0f, trans0 = 0.0f;
  float g[10] = {};
  float gw_total = 0.0f, t_out = 0.0f, g_raw = 0.0f;
  if (has_ray) {
    dx = dirs[ray_at * 3 + 0];
    dy = dirs[ray_at * 3 + 1];
    dz = dirs[ray_at * 3 + 2];
    min_t = mind[ray_at];
    trans0 = t0[ray_at];
    const float* fwd = fwd_chans + tile * kOutRows * rays + ray;
    const float* up = g_chans + tile * kOutRows * rays + ray;
#pragma unroll
    for (int c = 0; c < 10; ++c) g[c] = up[c * rays];
#pragma unroll
    for (int c = 0; c < 8; ++c) gw_total += g[c] * fwd[c * rays];
    t_out = fwd[8 * rays];
    g_raw = g[9] * fwd[9 * rays];
  }
  float basis[16];
  sh_basis(dx, dy, dz, basis);

  float trans = trans0;
  float prefix = 0.0f;  // running sum of gw * w over composited hits
  bool alive = has_ray;

  const int count = min(max(cnt[tile], 0), k);
  for (int base = 0; base < count; base += kChunk) {
    if (!__syncthreads_or(alive)) break;
    const int n = min(kChunk, count - base);
    stage_chunk(s_geo, s_sh, tile, k, base, n, axes, plane, inv_scale, opac,
                sign, sh);
    __syncthreads();
    if (!__any_sync(0xffffffffu, alive)) continue;  // warp-uniform skip

    for (int j = 0; j < n; ++j) {
      // Replay: the same gates, stop and shading as the forward.
      Hit h = {};
      float d_alpha = 0.0f, w = 0.0f, x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
      if (alive) {
        h = intersect(s_geo, j, dx, dy, dz, min_t);
        const float next = next_trans(trans, h.alpha);
        const float one_m = fmaxf(1.0f - h.alpha, 1e-6f);
        const bool grad_gate = h.alpha > 0.0f && h.alpha_raw < kAlphaMax;
        if (next < kTMin) {
          alive = false;  // the stop hit: seen by the raw-T row only
          if (grad_gate) d_alpha = -g_raw / one_m;
        } else if (h.alpha > 0.0f) {
          w = h.alpha * trans;
          float c0, c1, c2;
          shade(basis, s_sh, j, c0, c1, c2);
          const float col0 = c0 + 0.5f;
          const float sg = s_geo[kSign][j];
          const float gw = g[0] * fmaxf(col0, 0.0f) + g[1] * (c1 + 0.5f)
                           + g[2] * (c2 + 0.5f) + g[3] * h.t + g[4]
                           + sg * (g[5] * s_geo[kNx][j] + g[6] * s_geo[kNy][j]
                                   + g[7] * s_geo[kNz][j]);
          prefix += gw * w;
          if (grad_gate) {
            const float suffix = gw_total - prefix;
            d_alpha = gw * trans - suffix / one_m - g[8] * t_out / one_m
                      - g_raw / one_m;
          }
          x0 = col0 > 0.0f ? g[0] * w : 0.0f;
          x1 = g[1] * w;
          x2 = g[2] * w;
          trans = next;
        }
      }
      const bool active = d_alpha != 0.0f || w != 0.0f;
      if (!__any_sync(0xffffffffu, active)) continue;

      // The chain for this lane's pair (zeros where it has none).
      float v[32];
      float d_qd = 0.0f, d_bu = 0.0f, d_bv = 0.0f, d_t = 0.0f;
      float d_au = 0.0f, d_av = 0.0f, d_is0 = 0.0f, d_is1 = 0.0f;
      float d_op = 0.0f, sw = 0.0f;
      if (active) {
        const float is0 = s_geo[kInvS0][j], is1 = s_geo[kInvS1][j];
        d_op = d_alpha * h.g;
        const float d_gg = d_alpha * s_geo[kOpac][j] * h.g;
        const float d_u = -d_gg * h.u;
        const float d_v = -d_gg * h.v;
        d_t = d_u * is0 * h.bu + d_v * is1 * h.bv + g[3] * w;
        d_qd = -d_t * h.t / h.qd;
        d_au = d_u * is0;
        d_av = d_v * is1;
        d_is0 = d_u * (s_geo[kAu][j] + h.t * h.bu);
        d_is1 = d_v * (s_geo[kAv][j] + h.t * h.bv);
        d_bu = d_au * h.t;
        d_bv = d_av * h.t;
        d_t = d_t / h.qd;  // dL/dp
        sw = s_geo[kSign][j] * w;
      }
      v[0] = dx * d_qd + sw * g[5];
      v[1] = dy * d_qd + sw * g[6];
      v[2] = dz * d_qd + sw * g[7];
      v[3] = dx * d_bu;
      v[4] = dy * d_bu;
      v[5] = dz * d_bu;
      v[6] = dx * d_bv;
      v[7] = dy * d_bv;
      v[8] = dz * d_bv;
      v[9] = d_t;
      v[10] = d_au;
      v[11] = d_av;
      v[12] = d_is0;
      v[13] = d_is1;
      v[14] = d_op;
      v[15] = 0.0f;
#pragma unroll
      for (int s = 0; s < 16; ++s) v[kShRow + s] = basis[s] * x0;
      const int cand = base + j;
      add_row(grads, tile, lane, k, cand, warp_transpose_sum(v, lane));

      if (!__any_sync(0xffffffffu, w != 0.0f)) continue;
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        v[s] = basis[s] * x1;
        v[16 + s] = basis[s] * x2;
      }
      add_row(grads, tile, 32 + lane, k, cand, warp_transpose_sum(v, lane));
    }
  }
}

}  // namespace

// Launches the kernel on `stream` over (tiles, rays, k); returns
// cudaGetLastError() of the launch.  grads (tiles, 64, k) must be zero.
extern "C" int tracer_backward(const void* cnt, const void* dirs,
                               const void* mind, const void* t0,
                               const void* axes, const void* plane,
                               const void* inv_scale, const void* opac,
                               const void* sign, const void* sh,
                               const void* fwd_chans, const void* g_chans,
                               void* grads, int tiles, int rays, int k,
                               void* stream) {
  if (tiles == 0 || rays == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((rays + kThreads - 1) / kThreads, tiles);
  tracer_backward_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cnt), static_cast<const float*>(dirs),
      static_cast<const float*>(mind), static_cast<const float*>(t0),
      static_cast<const float*>(axes), static_cast<const float*>(plane),
      static_cast<const float*>(inv_scale), static_cast<const float*>(opac),
      static_cast<const float*>(sign), static_cast<const float*>(sh),
      static_cast<const float*>(fwd_chans),
      static_cast<const float*>(g_chans), static_cast<float*>(grads), rays,
      k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tracer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
