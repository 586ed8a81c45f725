// Shared by the forward and backward surfel tracer kernels for Hopper
// (tracer_forward.cu, tracer_backward.cu): the gate constants, the SH
// basis, the ray/surfel intersection with every gate, the transmittance
// update, the per-hit shading, candidate staging, and the exact mode's
// depth-order walk (`nearest_hits`).
//
// The backward kernel replays the forward's hit sequence, so each gate it
// decides (ok, the ALPHA_MAX clamp, the T_MIN stop, the channel-0 clamp)
// has to come out bit for bit as it did in the forward.  Both kernels call
// the functions below, and every operation whose rounding decides a gate
// is written with an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn, __fmaf_rn), so the compiler cannot contract it differently
// in the two translation units.  t = p / (n.d) amplifies rounding at
// grazing incidence: the same explicit forms keep the kernels within
// rounding of the plain PyTorch twins.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace tracer {

constexpr int kThreads = 128;  // rays per block, one thread each
constexpr int kChunk = 128;    // candidates staged per round (== kThreads)
constexpr int kGeo = 16;       // n(3) w1(3) w2(3) p a_u a_v 1/s0 1/s1 opac sign
constexpr int kSh = 48;        // 3 channels x 16 SH coefficients
constexpr int kOutRows = 16;   // channel rows of the forward output (10 used)
constexpr int kBuf = 16;       // hits a ray gathers per pass in exact order

static_assert(kThreads == kChunk, "each thread stages one candidate");

// Gates, as lidar_rt_tpu/ops/geometry.py:38-42.
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kTMin = 1e-4f;
constexpr float kDenomEps = 1e-12f;

// Degree-3 real SH basis of a direction (lidar_rt_tpu/core/sh.py basis).
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float b[16]) {
  const float inv = rsqrtf(fmaxf(x * x + y * y + z * z, 1e-24f));
  x *= inv;
  y *= inv;
  z *= inv;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  b[0] = 0.28209479177387814f;
  b[1] = -0.4886025119029199f * y;
  b[2] = 0.4886025119029199f * z;
  b[3] = -0.4886025119029199f * x;
  b[4] = 1.0925484305920792f * xy;
  b[5] = -1.0925484305920792f * yz;
  b[6] = 0.31539156525252005f * (2.0f * zz - xx - yy);
  b[7] = -1.0925484305920792f * xz;
  b[8] = 0.5462742152960396f * (xx - yy);
  b[9] = -0.5900435899266435f * y * (3.0f * xx - yy);
  b[10] = 2.890611442640554f * xy * z;
  b[11] = -0.4570457994644658f * y * (4.0f * zz - xx - yy);
  b[12] = 0.3731763325901154f * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
  b[13] = -0.4570457994644658f * x * (4.0f * zz - xx - yy);
  b[14] = 1.445305721320277f * z * (xx - yy);
  b[15] = -0.5900435899266435f * x * (xx - 3.0f * yy);
}

// d . a with each product and sum rounded separately, left to right.
__device__ __forceinline__ float dot3_rn(float dx, float dy, float dz,
                                         float ax, float ay, float az) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, ax), __fmul_rn(dy, ay)),
                   __fmul_rn(dz, az));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// One candidate's geometry, staged in shared memory as rows of s_geo.
enum GeoRow {
  kNx = 0, kNy, kNz, kW1x, kW1y, kW1z, kW2x, kW2y, kW2z,
  kP, kAu, kAv, kInvS0, kInvS1, kOpac, kSign
};

// Rows of `stride` floats in dynamic shared memory: rows[r][j] reads as
// s_geo[r][j] does for the tile-order kernels' fixed-width arrays, so the
// functions below take either (template parameter Rows).
struct RowView {
  float* base;
  int stride;
  __device__ __forceinline__ float* operator[](int r) const {
    return base + r * stride;
  }
};

// A ray's hit on one candidate.  alpha is 0 unless every gate passes
// (|n.d| > eps, t >= min_t, alpha_raw >= ALPHA_MIN); the fields past
// `qd` are 0 unless |n.d| > eps, and past `t` 0 unless t >= min_t.
struct Hit {
  float alpha;      // gated, clamped opacity * G
  float alpha_raw;  // min(ALPHA_MAX, opacity * G)
  float qd, t;      // n.d and the hit range p / (n.d)
  float bu, bv;     // w1.d, w2.d
  float u, v, g;    // splat coordinates and G = exp(-(u^2 + v^2) / 2)
};

// The intersection and gates of lidar_rt_tpu/ops/geometry.py, for
// candidate j of the staged rows s_geo (kGeo rows).
template <typename Rows>
__device__ __forceinline__ Hit intersect(Rows s_geo, int j, float dx,
                                         float dy, float dz, float min_t) {
  Hit h = {};
  h.qd = dot3_rn(dx, dy, dz, s_geo[kNx][j], s_geo[kNy][j], s_geo[kNz][j]);
  if (fabsf(h.qd) > kDenomEps) {
    h.t = s_geo[kP][j] / h.qd;
    if (h.t >= min_t) {
      h.bu = dot3_rn(dx, dy, dz, s_geo[kW1x][j], s_geo[kW1y][j],
                     s_geo[kW1z][j]);
      h.bv = dot3_rn(dx, dy, dz, s_geo[kW2x][j], s_geo[kW2y][j],
                     s_geo[kW2z][j]);
      h.u = __fmul_rn(__fadd_rn(s_geo[kAu][j], __fmul_rn(h.t, h.bu)),
                      s_geo[kInvS0][j]);
      h.v = __fmul_rn(__fadd_rn(s_geo[kAv][j], __fmul_rn(h.t, h.bv)),
                      s_geo[kInvS1][j]);
      h.g = expf(__fmul_rn(-0.5f, __fadd_rn(__fmul_rn(h.u, h.u),
                                            __fmul_rn(h.v, h.v))));
      h.alpha_raw = fminf(kAlphaMax, __fmul_rn(s_geo[kOpac][j], h.g));
      if (h.alpha_raw >= kAlphaMin) h.alpha = h.alpha_raw;
    }
  }
  return h;
}

// Transmittance after a hit: T * (1 - alpha).  A ray stops at the first
// hit where this falls below T_MIN; that hit is not composited.
__device__ __forceinline__ float next_trans(float trans, float alpha) {
  return __fmul_rn(trans, __fsub_rn(1.0f, alpha));
}

// Per-hit SH values c_ch = basis . sh[ch] of candidate j (before the +0.5
// shift), from the staged rows s_sh (kSh rows).
template <typename Rows>
__device__ __forceinline__ void shade(const float basis[16], Rows s_sh,
                                      int j, float& c0, float& c1,
                                      float& c2) {
  c0 = 0.0f;
  c1 = 0.0f;
  c2 = 0.0f;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    c0 = __fmaf_rn(basis[s], s_sh[s][j], c0);
    c1 = __fmaf_rn(basis[s], s_sh[16 + s][j], c1);
    c2 = __fmaf_rn(basis[s], s_sh[32 + s][j], c2);
  }
}

// Stage candidates [base, base + n) of `tile` into shared memory, rows of
// kN floats (n <= kN): thread i loads candidate base + i.  Inputs are (T,
// rows, K) row-major.
template <int kN>
__device__ __forceinline__ void stage_chunk(
    float (*s_geo)[kN], float (*s_sh)[kN], long long tile, int k,
    int base, int n, const float* __restrict__ axes,
    const float* __restrict__ plane, const float* __restrict__ inv_scale,
    const float* __restrict__ opac, const float* __restrict__ sign,
    const float* __restrict__ sh) {
  if (threadIdx.x >= n) return;
  const long long c = base + threadIdx.x;
  for (int f = 0; f < 9; ++f) {
    s_geo[kNx + f][threadIdx.x] = axes[(tile * 9 + f) * k + c];
  }
  for (int f = 0; f < 3; ++f) {
    s_geo[kP + f][threadIdx.x] = plane[(tile * 3 + f) * k + c];
  }
  for (int f = 0; f < 2; ++f) {
    s_geo[kInvS0 + f][threadIdx.x] = inv_scale[(tile * 2 + f) * k + c];
  }
  s_geo[kOpac][threadIdx.x] = opac[tile * k + c];
  s_geo[kSign][threadIdx.x] = sign[tile * k + c];
  for (int f = 0; f < kSh; ++f) {
    s_sh[f][threadIdx.x] = sh[(tile * kSh + f) * k + c];
  }
}

// Exact order: stage all `count` candidates of `tile` at once, into rows
// of stride k; thread i of a kBlock-thread block loads candidates i,
// i + kBlock, ...
template <int kBlock = kThreads>
__device__ __forceinline__ void stage_all(
    RowView s_geo, RowView s_sh, long long tile, int k, int count,
    const float* __restrict__ axes, const float* __restrict__ plane,
    const float* __restrict__ inv_scale, const float* __restrict__ opac,
    const float* __restrict__ sign, const float* __restrict__ sh) {
  for (int c = threadIdx.x; c < count; c += kBlock) {
    for (int f = 0; f < 9; ++f) {
      s_geo[kNx + f][c] = axes[(tile * 9 + f) * k + c];
    }
    for (int f = 0; f < 3; ++f) {
      s_geo[kP + f][c] = plane[(tile * 3 + f) * k + c];
    }
    for (int f = 0; f < 2; ++f) {
      s_geo[kInvS0 + f][c] = inv_scale[(tile * 2 + f) * k + c];
    }
    s_geo[kOpac][c] = opac[tile * k + c];
    s_geo[kSign][c] = sign[tile * k + c];
    for (int f = 0; f < kSh; ++f) {
      s_sh[f][c] = sh[(tile * kSh + f) * k + c];
    }
  }
}

// One pass of the exact mode's depth-order walk (the reference's k-buffer,
// forward.cu:312-356): fill (bt, bj) with this ray's kBuf nearest
// gate-passing hits strictly after the cursor (cur_t, cur_j) in (t,
// candidate index) order, ascending; empty slots hold t = +inf.  A full
// buffer may leave hits for the next pass, which starts after its last
// entry.  Candidates are scanned in index order, so a hit whose t ties a
// buffered one goes after it, as a stable sort puts it.  The range is
// computed as intersect() computes it, so the key is the hit's exact t;
// hits outside (cursor, last entry) skip the rest of the intersection.
// The buffer's indices are compile-time constants: it stays in registers.
__device__ __forceinline__ void nearest_hits(
    RowView s_geo, int count, float dx, float dy, float dz, float min_t,
    float cur_t, int cur_j, float (&bt)[kBuf], int (&bj)[kBuf]) {
#pragma unroll
  for (int b = 0; b < kBuf; ++b) {
    bt[b] = CUDART_INF_F;
    bj[b] = 0;
  }
  for (int j = 0; j < count; ++j) {
    const float qd = dot3_rn(dx, dy, dz, s_geo[kNx][j], s_geo[kNy][j],
                             s_geo[kNz][j]);
    if (!(fabsf(qd) > kDenomEps)) continue;
    const float t = s_geo[kP][j] / qd;
    if (!(t >= min_t) || t < cur_t || (t == cur_t && j <= cur_j) ||
        !(t < bt[kBuf - 1])) {
      continue;
    }
    if (!(intersect(s_geo, j, dx, dy, dz, min_t).alpha > 0.0f)) continue;
    float kt = t;
    int kj = j;
#pragma unroll
    for (int b = 0; b < kBuf; ++b) {  // insert; the last entry drops out
      const bool before = kt < bt[b];
      const float st = bt[b];
      const int sj = bj[b];
      bt[b] = before ? kt : st;
      bj[b] = before ? kj : sj;
      kt = before ? st : kt;
      kj = before ? sj : kj;
    }
  }
}

}  // namespace tracer
