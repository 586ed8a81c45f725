// Shared by the forward and backward surfel tracer kernels for Hopper
// (tracer_forward.cu, tracer_backward.cu): the gate constants, the SH
// basis, the ray/surfel intersection with every gate, the transmittance
// update, the per-hit shading, candidate staging, the per-warp box test
// that rules out candidates no ray of a warp can hit (`warp_cone`,
// `cone_misses`), and the exact mode's depth-order walk (`nearest_hits`).
//
// The backward kernel replays the forward's hit sequence, so each gate it
// decides (ok, the ALPHA_MAX clamp, the T_MIN stop, the channel-0 clamp)
// has to come out bit for bit as it did in the forward.  Both kernels call
// the functions below, and every operation whose rounding decides a gate
// is written with an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn, __fmaf_rn), so the compiler cannot contract it differently
// in the two translation units.  The box test is written the same way:
// the forward's cache of per-pair residuals holds only the (warp,
// candidate) steps its walk visits, and the backward that decodes it must
// visit exactly those.  t = p / (n.d) amplifies rounding at
// grazing incidence: the same explicit forms keep the kernels within
// rounding of the plain PyTorch twins.  The intersection, the box test
// and the shading read a candidate through an accessor (RowCand and RowSh
// for staged rows of scalars, the forward's QuadCand for candidates staged
// whole): the values, and so every gate and bit, are the same either way.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace tracer {

constexpr int kThreads = 128;  // rays per block, one thread each
constexpr int kGeo = 16;       // n(3) w1(3) w2(3) p a_u a_v 1/s0 1/s1 opac sign
constexpr int kSh = 48;        // 3 channels x 16 SH coefficients
constexpr int kOutRows = 16;   // channel rows of the forward output (10 used)
constexpr int kBuf = 16;       // hits a ray gathers per pass in exact order

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

// One candidate's staged geometry as the intersection and the box test
// read it: normal() = n, p(), and back() = (w1, a_u), (w2, a_v), (1/s0,
// 1/s1, opacity, sign).  RowCand reads candidate j of staged rows (kGeo
// rows, row-major); a kernel that stages candidates whole reads each
// group of four with one 16-byte load.
struct GeoBack {
  float4 w1, w2, m;
};

template <typename Rows>
struct RowCand {
  Rows rows;
  int j;
  __device__ __forceinline__ float3 normal() const {
    return make_float3(rows[kNx][j], rows[kNy][j], rows[kNz][j]);
  }
  __device__ __forceinline__ float p() const { return rows[kP][j]; }
  __device__ __forceinline__ GeoBack back() const {
    return {make_float4(rows[kW1x][j], rows[kW1y][j], rows[kW1z][j],
                        rows[kAu][j]),
            make_float4(rows[kW2x][j], rows[kW2y][j], rows[kW2z][j],
                        rows[kAv][j]),
            make_float4(rows[kInvS0][j], rows[kInvS1][j], rows[kOpac][j],
                        rows[kSign][j])};
  }
};

// Candidate j of staged rows, as a stage hands candidates to nearest_hits.
struct RowStage {
  RowView geo;
  __device__ __forceinline__ RowCand<RowView> operator()(int j) const {
    return {geo, j};
  }
};

// The intersection and gates of lidar_rt_tpu/ops/geometry.py for one
// candidate (back() only where t >= min_t).  kGates = false stops at the
// splat coordinates: no exp, g = alpha = alpha_raw = 0 (the cached
// backward decodes the gates and alpha from the forward's residuals, and
// needs only the locals of the gradient chain).
template <bool kGates = true, typename Cand>
__device__ __forceinline__ Hit intersect_cand(const Cand& cand, float dx,
                                              float dy, float dz,
                                              float min_t) {
  Hit h = {};
  const float3 n = cand.normal();
  h.qd = dot3_rn(dx, dy, dz, n.x, n.y, n.z);
  if (fabsf(h.qd) > kDenomEps) {
    h.t = cand.p() / h.qd;
    if (h.t >= min_t) {
      const GeoBack b = cand.back();
      h.bu = dot3_rn(dx, dy, dz, b.w1.x, b.w1.y, b.w1.z);
      h.bv = dot3_rn(dx, dy, dz, b.w2.x, b.w2.y, b.w2.z);
      h.u = __fmul_rn(__fadd_rn(b.w1.w, __fmul_rn(h.t, h.bu)), b.m.x);
      h.v = __fmul_rn(__fadd_rn(b.w2.w, __fmul_rn(h.t, h.bv)), b.m.y);
      if (kGates) {
        h.g = expf(__fmul_rn(-0.5f, __fadd_rn(__fmul_rn(h.u, h.u),
                                              __fmul_rn(h.v, h.v))));
        h.alpha_raw = fminf(kAlphaMax, __fmul_rn(b.m.z, h.g));
        if (h.alpha_raw >= kAlphaMin) h.alpha = h.alpha_raw;
      }
    }
  }
  return h;
}

// The same for candidate j of the staged rows s_geo (kGeo rows).
template <bool kGates = true, typename Rows>
__device__ __forceinline__ Hit intersect(Rows s_geo, int j, float dx,
                                         float dy, float dz, float min_t) {
  return intersect_cand<kGates>(RowCand<Rows>{s_geo, j}, dx, dy, dz, min_t);
}

// Transmittance after a hit: T * (1 - alpha).  A ray stops at the first
// hit where this falls below T_MIN; that hit is not composited.
__device__ __forceinline__ float next_trans(float trans, float alpha) {
  return __fmul_rn(trans, __fsub_rn(1.0f, alpha));
}

// Per-hit SH values c_ch = basis . sh[ch] of a candidate (before the +0.5
// shift).  cand.sh4(q) reads group q of its 48 SH values, channel-major,
// four coefficients to a group: RowSh from staged rows, the forward's
// QuadCand from a candidate staged whole.  Every multiply-add is rounded
// explicitly, in the same order for both.
template <typename Cand>
__device__ __forceinline__ void shade_cand(const float basis[16],
                                           const Cand& cand, float& c0,
                                           float& c1, float& c2) {
  c0 = 0.0f;
  c1 = 0.0f;
  c2 = 0.0f;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float4 a = cand.sh4(g), b = cand.sh4(4 + g), d = cand.sh4(8 + g);
    const float* bs = basis + 4 * g;
    c0 = __fmaf_rn(bs[0], a.x, c0);
    c1 = __fmaf_rn(bs[0], b.x, c1);
    c2 = __fmaf_rn(bs[0], d.x, c2);
    c0 = __fmaf_rn(bs[1], a.y, c0);
    c1 = __fmaf_rn(bs[1], b.y, c1);
    c2 = __fmaf_rn(bs[1], d.y, c2);
    c0 = __fmaf_rn(bs[2], a.z, c0);
    c1 = __fmaf_rn(bs[2], b.z, c1);
    c2 = __fmaf_rn(bs[2], d.z, c2);
    c0 = __fmaf_rn(bs[3], a.w, c0);
    c1 = __fmaf_rn(bs[3], b.w, c1);
    c2 = __fmaf_rn(bs[3], d.w, c2);
  }
}

// The SH values of candidate j of staged rows s_sh (kSh rows).
template <typename Rows>
struct RowSh {
  Rows rows;
  int j;
  __device__ __forceinline__ float4 sh4(int q) const {
    return make_float4(rows[4 * q][j], rows[4 * q + 1][j],
                       rows[4 * q + 2][j], rows[4 * q + 3][j]);
  }
};

// The same for candidate j of the staged rows s_sh.
template <typename Rows>
__device__ __forceinline__ void shade(const float basis[16], Rows s_sh,
                                      int j, float& c0, float& c1,
                                      float& c2) {
  shade_cand(basis, RowSh<Rows>{s_sh, j}, c0, c1, c2);
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

// A warp's rays as a box of unit directions around an orthonormal frame
// (c, e1, e2): every ray's unit direction d has c.d >= c_min, |e1.d| <=
// a1 and |e2.d| <= a2 (rays past the tile's end left out).  c is the
// rays' mean direction and e1 points along their spread, so a warp of one
// sensor row (a short arc) gets a long, thin box.  A warp with no ray
// gets c_min = -inf, which no test passes.
struct Cone {
  float c[3], e1[3], e2[3];
  float c_min, a1, a2;
};

__device__ __forceinline__ float warp_all_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ float warp_all_max(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// The box test's arithmetic below is rounded explicitly throughout
// (__fmul_rn, __fadd_rn, __fsub_rn; the fast division, log and reciprocal
// square root are fixed instruction sequences), so every kernel that
// includes it skips the same steps: see the file comment.

__device__ __forceinline__ float dot3(const float (&a)[3], float x, float y,
                                      float z) {
  return dot3_rn(a[0], a[1], a[2], x, y, z);
}

__device__ __forceinline__ Cone warp_cone(float dx, float dy, float dz,
                                          bool has) {
  const float inv =
      has ? rsqrtf(fmaxf(dot3_rn(dx, dy, dz, dx, dy, dz), 1e-24f)) : 0.0f;
  const float ux = __fmul_rn(dx, inv), uy = __fmul_rn(dy, inv);
  const float uz = __fmul_rn(dz, inv);
  Cone b;
  float cx = warp_all_sum(ux), cy = warp_all_sum(uy), cz = warp_all_sum(uz);
  const float norm2 = dot3_rn(cx, cy, cz, cx, cy, cz);
  if (!(norm2 > 1e-12f)) {
    b.c_min = -CUDART_INF_F;
    return b;
  }
  const float cinv = rsqrtf(norm2);
  b.c[0] = __fmul_rn(cx, cinv);
  b.c[1] = __fmul_rn(cy, cinv);
  b.c[2] = __fmul_rn(cz, cinv);
  // e1: the spread from the first ray to the last, made orthogonal to c;
  // any unit vector orthogonal to c where that vanishes.
  const int last = 31 - __clz(__ballot_sync(0xffffffffu, has));
  const int first = __ffs(__ballot_sync(0xffffffffu, has)) - 1;
  float sx = __fsub_rn(__shfl_sync(0xffffffffu, ux, last),
                       __shfl_sync(0xffffffffu, ux, first));
  float sy = __fsub_rn(__shfl_sync(0xffffffffu, uy, last),
                       __shfl_sync(0xffffffffu, uy, first));
  float sz = __fsub_rn(__shfl_sync(0xffffffffu, uz, last),
                       __shfl_sync(0xffffffffu, uz, first));
  const float along = dot3(b.c, sx, sy, sz);
  sx = __fsub_rn(sx, __fmul_rn(along, b.c[0]));
  sy = __fsub_rn(sy, __fmul_rn(along, b.c[1]));
  sz = __fsub_rn(sz, __fmul_rn(along, b.c[2]));
  float s2 = dot3_rn(sx, sy, sz, sx, sy, sz);
  if (!(s2 > 1e-20f)) {  // c crossed with the axis it is least along
    const bool use_x = fabsf(b.c[0]) <= fabsf(b.c[1])
                       && fabsf(b.c[0]) <= fabsf(b.c[2]);
    const bool use_y = !use_x && fabsf(b.c[1]) <= fabsf(b.c[2]);
    sx = use_x ? 0.0f : (use_y ? b.c[2] : -b.c[1]);
    sy = use_x ? -b.c[2] : (use_y ? 0.0f : b.c[0]);
    sz = use_x ? b.c[1] : (use_y ? -b.c[0] : 0.0f);
    s2 = dot3_rn(sx, sy, sz, sx, sy, sz);
  }
  const float sinv = rsqrtf(s2);
  b.e1[0] = __fmul_rn(sx, sinv);
  b.e1[1] = __fmul_rn(sy, sinv);
  b.e1[2] = __fmul_rn(sz, sinv);
  b.e2[0] = __fsub_rn(__fmul_rn(b.c[1], b.e1[2]), __fmul_rn(b.c[2], b.e1[1]));
  b.e2[1] = __fsub_rn(__fmul_rn(b.c[2], b.e1[0]), __fmul_rn(b.c[0], b.e1[2]));
  b.e2[2] = __fsub_rn(__fmul_rn(b.c[0], b.e1[1]), __fmul_rn(b.c[1], b.e1[0]));
  // The box's extent over the rays, widened for the rounding of the
  // normalisations and of this frame.
  const float cd = has ? dot3(b.c, ux, uy, uz) : CUDART_INF_F;
  const float a1 = has ? fabsf(dot3(b.e1, ux, uy, uz)) : 0.0f;
  const float a2 = has ? fabsf(dot3(b.e2, ux, uy, uz)) : 0.0f;
  b.c_min = __fsub_rn(-warp_all_max(-cd), 1e-5f);
  b.a1 = __fadd_rn(__fmul_rn(warp_all_max(a1), 1.001f), 1e-5f);
  b.a2 = __fadd_rn(__fmul_rn(warp_all_max(a2), 1.001f), 1e-5f);
  return b;
}

// True only if no direction of the box passes the candidate's gates, so
// that every ray of the warp has alpha = 0 there.  In real arithmetic the
// splat coordinates of a direction d are u = (U.d) / (n.d) and v =
// (V.d) / (n.d), with U = (a_u n + p w1) / s0 and V = (a_v n + p w2) / s1
// (intersect(): t = p / (n.d), u = (a_u + t w1.d) / s0), and a pair
// passes only if opacity * exp(-(u^2 + v^2) / 2) >= ALPHA_MIN, i.e.
// u^2 + v^2 <= 2 ln(opacity / ALPHA_MIN).  With d = (c.d) c + (e1.d) e1 +
// (e2.d) e2 and c_min <= c.d <= 1, |U.d| >= c_min |U.c| - a1 |U.e1| -
// a2 |U.e2| and |n.d| lies within |n.c| +- (a1 |n.e1| + a2 |n.e2|) (and
// c_min |n.c| - ... from below); where n.d may change sign the test gives
// up.  The lower bounds are shrunk by a slack far above the rounding of
// intersect()'s float arithmetic, and the test asks for 5% more than the
// gate's radius squared; so its own divisions and log can be the fast ones
// (__fdividef, __logf: a few ulp).
template <typename Cand>
__device__ __forceinline__ bool cone_misses_cand(const Cand& cand,
                                                 const Cone& b) {
  const float3 n = cand.normal();
  const GeoBack g = cand.back();
  const float nx = n.x, ny = n.y, nz = n.z, p = cand.p();
  const float w1x = g.w1.x, w1y = g.w1.y, w1z = g.w1.z, au = g.w1.w;
  const float w2x = g.w2.x, w2y = g.w2.y, w2z = g.w2.z, av = g.w2.w;
  const float is0 = g.m.x, is1 = g.m.y, opacity = g.m.z;
  // alpha_raw = opacity * G rounds to at most opacity, as G <= 1.
  if (opacity < kAlphaMin) return true;
  const float ux =
      __fmul_rn(is0, __fadd_rn(__fmul_rn(au, nx), __fmul_rn(p, w1x)));
  const float uy =
      __fmul_rn(is0, __fadd_rn(__fmul_rn(au, ny), __fmul_rn(p, w1y)));
  const float uz =
      __fmul_rn(is0, __fadd_rn(__fmul_rn(au, nz), __fmul_rn(p, w1z)));
  const float vx =
      __fmul_rn(is1, __fadd_rn(__fmul_rn(av, nx), __fmul_rn(p, w2x)));
  const float vy =
      __fmul_rn(is1, __fadd_rn(__fmul_rn(av, ny), __fmul_rn(p, w2y)));
  const float vz =
      __fmul_rn(is1, __fadd_rn(__fmul_rn(av, nz), __fmul_rn(p, w2z)));
  const float n_len = sqrtf(dot3_rn(nx, ny, nz, nx, ny, nz));
  const float n_c = fabsf(dot3(b.c, nx, ny, nz));
  const float n_side =
      __fadd_rn(__fmul_rn(b.a1, fabsf(dot3(b.e1, nx, ny, nz))),
                __fmul_rn(b.a2, fabsf(dot3(b.e2, nx, ny, nz))));
  // The least |n.d| over the warp's box.
  const float qd_lo = __fsub_rn(__fmul_rn(b.c_min, n_c), n_side);
  if (!(qd_lo > 0.0f)) return false;
  const float inv_hi = __fdividef(1.0f, __fadd_rn(n_c, n_side));
  const float amp =
      __fdividef(__fadd_rn(1.0f, __fdividef(n_len, qd_lo)), qd_lo);
  const float slack_u = __fmul_rn(
      __fmul_rn(__fmul_rn(1e-4f, fabsf(is0)), amp),
      __fadd_rn(__fmul_rn(fabsf(au), n_len),
                __fmul_rn(fabsf(p),
                          sqrtf(dot3_rn(w1x, w1y, w1z, w1x, w1y, w1z)))));
  const float slack_v = __fmul_rn(
      __fmul_rn(__fmul_rn(1e-4f, fabsf(is1)), amp),
      __fadd_rn(__fmul_rn(fabsf(av), n_len),
                __fmul_rn(fabsf(p),
                          sqrtf(dot3_rn(w2x, w2y, w2z, w2x, w2y, w2z)))));
  const float u_lo = fmaxf(
      __fsub_rn(__fmul_rn(__fsub_rn(
                    __fsub_rn(__fmul_rn(b.c_min, fabsf(dot3(b.c, ux, uy, uz))),
                              __fmul_rn(b.a1, fabsf(dot3(b.e1, ux, uy, uz)))),
                    __fmul_rn(b.a2, fabsf(dot3(b.e2, ux, uy, uz)))),
                          inv_hi),
                slack_u),
      0.0f);
  const float v_lo = fmaxf(
      __fsub_rn(__fmul_rn(__fsub_rn(
                    __fsub_rn(__fmul_rn(b.c_min, fabsf(dot3(b.c, vx, vy, vz))),
                              __fmul_rn(b.a1, fabsf(dot3(b.e1, vx, vy, vz)))),
                    __fmul_rn(b.a2, fabsf(dot3(b.e2, vx, vy, vz)))),
                          inv_hi),
                slack_v),
      0.0f);
  const float r2 = __fmul_rn(2.0f, __logf(__fdividef(opacity, kAlphaMin)));
  return __fadd_rn(__fmul_rn(u_lo, u_lo), __fmul_rn(v_lo, v_lo)) >
         __fadd_rn(__fmul_rn(1.05f, r2), 0.05f);
}

template <typename Rows>
__device__ __forceinline__ bool cone_misses(Rows s_geo, int j,
                                            const Cone& b) {
  return cone_misses_cand(RowCand<Rows>{s_geo, j}, b);
}

// The candidates a depth-order walk scans, in ascending index order:
// every staged candidate (AllCands), or a warp's list of those its box
// test does not rule out (CandList).
struct AllCands {
  __device__ __forceinline__ int operator[](int i) const { return i; }
};

struct CandList {
  const unsigned short* index;
  __device__ __forceinline__ int operator[](int i) const { return index[i]; }
};

// A hit's place in the exact mode's depth order, (t, candidate index), as
// one 64-bit key that orders as the pair does: t's bits made monotone as
// an unsigned integer (sign bit flipped for t >= 0, all bits for t < 0)
// above the index.  kEmptyKey is +inf's key, above every finite hit's.
__device__ __forceinline__ unsigned long long hit_key(float t, int j) {
  const unsigned u = __float_as_uint(t);
  const unsigned m = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(m) << 32)
         | static_cast<unsigned>(j);
}
constexpr unsigned long long kEmptyKey = 0xff80000000000000ull;
__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(key & 0xffffffffull);
}

// One pass of the exact mode's depth-order walk (the reference's k-buffer,
// forward.cu:312-356): fill bk with the keys (`hit_key`) of this ray's kBuf
// nearest gate-passing hits strictly after the cursor key `cur`, in
// ascending (t, candidate index) order; empty slots hold kEmptyKey.  A
// full buffer may leave hits for the next pass, which starts after its
// last entry.  The insertion compares whole keys, so ties in t stay in
// index order as a stable sort keeps them, and the last entry, the next
// pass's cursor, is the largest.  (Comparing t alone, a displaced entry
// would stop behind later entries of its own t, and the next pass would
// composite those again.)  A candidate left out of `cands` must have
// alpha = 0 for this ray, since it could never enter the buffer.
// `stage(j)` reads candidate j (RowStage, or a stage of whole
// candidates).  The range is computed as intersect_cand() computes it, so
// the key holds the hit's exact t; hits outside (cursor, last entry) skip
// the rest of the intersection.  The buffer's indices are compile-time
// constants: it stays in registers.  Its size sets only how many passes a
// ray takes, not its hits.
template <typename Stage, typename Cands>
__device__ __forceinline__ void nearest_hits(
    Stage stage, Cands cands, int n, float dx, float dy, float dz,
    float min_t, unsigned long long cur, unsigned long long (&bk)[kBuf]) {
#pragma unroll
  for (int b = 0; b < kBuf; ++b) bk[b] = kEmptyKey;
  for (int i = 0; i < n; ++i) {
    const int j = cands[i];
    const auto cand = stage(j);
    const float3 nv = cand.normal();
    const float qd = dot3_rn(dx, dy, dz, nv.x, nv.y, nv.z);
    if (!(fabsf(qd) > kDenomEps)) continue;
    const float t = cand.p() / qd;
    if (!(t >= min_t)) continue;
    unsigned long long key = hit_key(t, j);
    if (key <= cur || !(key < bk[kBuf - 1])) continue;
    if (!(intersect_cand(cand, dx, dy, dz, min_t).alpha > 0.0f)) continue;
#pragma unroll
    for (int b = 0; b < kBuf; ++b) {  // insert; the last entry drops out
      const bool before = key < bk[b];
      const unsigned long long kept = bk[b];
      bk[b] = before ? key : kept;
      key = before ? kept : key;
    }
  }
}

}  // namespace tracer
