// Candidate preparation for the tracer kernels on Hopper (sm_90a): the
// gather of each tile's candidates into the kernels' (T, ., K) layout,
// and its VJP, a scatter-add of the tile inputs' gradients into the
// surfels'.
//
// Replaces: the gather and frame math of
// lidar_rt_tpu/ops/pallas_tracer.py::_prepare_tile_inputs, which the
// reference leaves to XLA (it fuses the gather and its transpose, a
// scatter-add, into its own loops; there is no Pallas kernel here), and
// in this port the PyTorch indexing of ops/cuda_tracer.py's plain twin,
// `prepare_tile_inputs_reference`: five advanced-indexing gathers
// (`bundle.means[idx]`, ...), the frame math as some forty elementwise
// launches, and permute copies.  The gathers' backward under autograd is
// `index_put_(accumulate=True)`, which radix-sorts each pass's T x K
// indices and then walks every run of equal indices with one warp,
// serially.  Every slot past a tile's count carries the sentinel N,
// clamped to surfel N - 1, so those slots form one long run, and a surfel
// that many tiles list forms another: on the card that took 28.6 of the
// 31.4 ms of a waymo.fwdbwd step (PERF.md).
//
// candidate_gather_kernel, one thread per slot (t, k): clamp the index,
// read the surfel's mean, quaternion, scales, opacity and 48 SH floats,
// build its frame (to_rotation_matrix of the normalised quaternion, then
// geometry.build_frames against the shared origin) and write the six
// outputs of `_prepare_tile_inputs` in place: axes (T, 3, 3, K) [n, w1,
// w2], plane (T, 3, K) [p, a_u, a_v], inv_scale (T, 2, K), opac (T, K)
// with validity and p != 0 folded in, sign (T, K) and sh (T, 3, 16, K)
// with the SH degree's mask folded in (its first `sh_kept` coefficients
// kept).  The float32 arithmetic is the twin's, op for op and in its
// order, with no contraction into fused multiply-adds (the __f*_rn
// intrinsics), so the frames agree with the twin's to rounding and the
// render's channels stay at the 1e-7 level of the reference's.
//
// candidate_scatter_kernel, one thread per valid slot: re-gather the
// slot's mean, quaternion, scales and opacity, apply the chain rule
// through build_frames, the rotation matrix and the quaternion's
// normalisation (the closed form of core/quaternions.py
// rotation_matrix_vjp), 1 / scale, the opacity fold and the SH mask, and
// add the result into the five surfel gradients with atomics: d_means (N,
// 3), d_rotations (N, 4), d_scales (N, 2), d_opacities (N,) and d_sh (N,
// 16, 3), the quaternion and each SH row's 48 floats as float4 vector
// atomics (red.global.add.v4.f32), the scales as one float2.  Slots past
// a tile's count are skipped: their opacity is zero and the tracer
// backward writes only the slots below the count of its zeroed output, so
// every gradient there is exactly zero and would add only zeros to
// surfel N - 1.  No sort, and no run of equal indices to walk: a surfel's
// contributions meet in the L2's atomic units, in no fixed order.  The
// gradients of one tile lie along K, so a warp's 32 slots read each of
// the 63 gradient rows as one coalesced 128-byte line.
//
// What bounds them on this card (H100, 3.35 TB/s): bytes.  The gather
// reads ~230 bytes a slot (index, validity, one surfel row of 58 floats)
// and writes 256 (64 floats), ~21 MB a pass at waymo's T x K = 168 x 256
// slots, ~6 us.  The scatter reads 252 bytes of gradients a slot plus
// the index and 10 floats of the surfel, ~13 MB a pass, and its output is
// the five zeroed (N, .) gradients, 58 floats a surfel: 67 MB at waymo's
// 288,623 surfels (~20 us), 189 MB at the 813,056 slots of the train
// cells' capacity (~56 us), several times the scatter's own bytes.  What
// the design does about it: the five gradients are one buffer zeroed by
// one memset (ops/kernels.py), laid out so each vector atomic is aligned,
// and only its touched rows see an atomic; the gather writes its outputs
// once, already in the tracer kernels' layout, so no permute or copy
// follows; neither kernel stages anything in shared memory, since no
// input is read twice by a block.
//
// Boundary (ops/kernels.py candidate_gather, candidate_scatter): float32
// surfel fields, contiguous; the index (T, K) int64 with the sentinel N;
// validity (T, K) bool; the origin, 3 floats `origin_stride` apart; each
// gradient (T, ...) with its rows contiguous and its tile stride given.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCoeffs = 16;             // SH coefficients
constexpr int kShRow = 3 * kCoeffs;     // a surfel's SH floats, (16, 3)
constexpr float kNormEps = 1e-12f;      // quaternions.normalize's clamp

__device__ __forceinline__ long long clamp_index(long long i, int n) {
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// The twin's quaternion normalisation and rotation matrix
// (core/quaternions.py normalize, to_rotation_matrix): q / max(|q|, eps),
// then the nine entries, m[r][c], columns w1, w2, n.  The sums of the
// norm and of dot3 are added in the order PyTorch's CUDA reduction over a
// last axis of 4 and of 3 adds them (ATen/native/cuda/Reduce.cuh: one
// lane per element, or two elements on one lane's accumulators, then a
// warp shuffle with falling offsets).
struct Rotation {
  float qn[4];     // normalised (w, x, y, z)
  float norm;      // |q| before the clamp
  float m[3][3];
};

__device__ __forceinline__ Rotation rotation_of(const float* q) {
  Rotation r;
  const float ss = __fadd_rn(
      __fadd_rn(__fmul_rn(q[0], q[0]), __fmul_rn(q[2], q[2])),
      __fadd_rn(__fmul_rn(q[1], q[1]), __fmul_rn(q[3], q[3])));
  r.norm = __fsqrt_rn(ss);
  const float d = fmaxf(r.norm, kNormEps);
#pragma unroll
  for (int i = 0; i < 4; ++i) r.qn[i] = __fdiv_rn(q[i], d);
  const float w = r.qn[0], x = r.qn[1], y = r.qn[2], z = r.qn[3];
  const float xx = __fmul_rn(x, x), yy = __fmul_rn(y, y),
              zz = __fmul_rn(z, z);
  const float xy = __fmul_rn(x, y), xz = __fmul_rn(x, z),
              yz = __fmul_rn(y, z);
  const float wx = __fmul_rn(w, x), wy = __fmul_rn(w, y),
              wz = __fmul_rn(w, z);
  r.m[0][0] = __fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(yy, zz)));
  r.m[0][1] = __fmul_rn(2.0f, __fsub_rn(xy, wz));
  r.m[0][2] = __fmul_rn(2.0f, __fadd_rn(xz, wy));
  r.m[1][0] = __fmul_rn(2.0f, __fadd_rn(xy, wz));
  r.m[1][1] = __fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(xx, zz)));
  r.m[1][2] = __fmul_rn(2.0f, __fsub_rn(yz, wx));
  r.m[2][0] = __fmul_rn(2.0f, __fsub_rn(xz, wy));
  r.m[2][1] = __fmul_rn(2.0f, __fadd_rn(yz, wx));
  r.m[2][2] = __fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(xx, yy)));
  return r;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[2], b[2])),
                   __fmul_rn(a[1], b[1]));
}

__global__ void __launch_bounds__(kThreads) candidate_gather_kernel(
    const float* __restrict__ means, const float* __restrict__ rotations,
    const float* __restrict__ scales, const float* __restrict__ opacities,
    const float4* __restrict__ sh, const float* __restrict__ origin,
    const long long* __restrict__ index, const bool* __restrict__ valid,
    float* __restrict__ axes, float* __restrict__ plane,
    float* __restrict__ inv_scale, float* __restrict__ opac,
    float* __restrict__ sign, float* __restrict__ sh_out, int n, int tiles,
    int k, int origin_stride, int sh_kept) {
  const long long slot =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (slot >= static_cast<long long>(tiles) * k) return;
  const int t = static_cast<int>(slot / k);
  const int j = static_cast<int>(slot - static_cast<long long>(t) * k);
  const long long i = clamp_index(index[slot], n);

  const float q[4] = {rotations[4 * i], rotations[4 * i + 1],
                      rotations[4 * i + 2], rotations[4 * i + 3]};
  const Rotation r = rotation_of(q);
  const float w1[3] = {r.m[0][0], r.m[1][0], r.m[2][0]};
  const float w2[3] = {r.m[0][1], r.m[1][1], r.m[2][1]};
  const float nv[3] = {r.m[0][2], r.m[1][2], r.m[2][2]};
  float omm[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    omm[c] = __fsub_rn(origin[c * origin_stride], means[3 * i + c]);
  }
  const float p = -dot3(nv, omm);
  const float planes[3] = {p, dot3(w1, omm), dot3(w2, omm)};

  const float* frame[3] = {nv, w1, w2};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      axes[((static_cast<long long>(t) * 3 + a) * 3 + c) * k + j] =
          frame[a][c];
    }
    plane[(static_cast<long long>(t) * 3 + a) * k + j] = planes[a];
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    inv_scale[(static_cast<long long>(t) * 2 + c) * k + j] =
        __fdiv_rn(1.0f, scales[2 * i + c]);
  }
  opac[slot] = __fmul_rn(__fmul_rn(opacities[i], valid[slot] ? 1.0f : 0.0f),
                         p != 0.0f ? 1.0f : 0.0f);
  sign[slot] = p < 0.0f ? 1.0f : -1.0f;

  // The row's 48 floats, (coefficient, channel), into (channel,
  // coefficient) rows of the output.
  float row[kShRow];
#pragma unroll
  for (int v = 0; v < kShRow / 4; ++v) {
    const float4 x = sh[i * (kShRow / 4) + v];
    row[4 * v] = x.x;
    row[4 * v + 1] = x.y;
    row[4 * v + 2] = x.z;
    row[4 * v + 3] = x.w;
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
    for (int c = 0; c < kCoeffs; ++c) {
      sh_out[((static_cast<long long>(t) * 3 + ch) * kCoeffs + c) * k + j] =
          __fmul_rn(row[3 * c + ch], c < sh_kept ? 1.0f : 0.0f);
    }
  }
}

__global__ void __launch_bounds__(kThreads) candidate_scatter_kernel(
    const float* __restrict__ means, const float* __restrict__ rotations,
    const float* __restrict__ scales, const float* __restrict__ opacities,
    const float* __restrict__ origin, const long long* __restrict__ index,
    const bool* __restrict__ valid, const float* __restrict__ d_axes,
    const float* __restrict__ d_plane, const float* __restrict__ d_inv_scale,
    const float* __restrict__ d_opac, const float* __restrict__ d_sh,
    float* __restrict__ g_means, float4* __restrict__ g_rotations,
    float2* __restrict__ g_scales, float* __restrict__ g_opacities,
    float4* __restrict__ g_sh, int n, int tiles, int k, int origin_stride,
    int sh_kept, long long s_axes, long long s_plane, long long s_inv,
    long long s_opac, long long s_sh) {
  const long long slot =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (slot >= static_cast<long long>(tiles) * k || !valid[slot]) return;
  const long long t = slot / k;
  const long long j = slot - t * k;
  const long long i = clamp_index(index[slot], n);

  const float q[4] = {rotations[4 * i], rotations[4 * i + 1],
                      rotations[4 * i + 2], rotations[4 * i + 3]};
  const Rotation r = rotation_of(q);
  float omm[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    omm[c] = __fsub_rn(origin[c * origin_stride], means[3 * i + c]);
  }
  const float nv[3] = {r.m[0][2], r.m[1][2], r.m[2][2]};
  const float p = -dot3(nv, omm);

  // Upstream gradients: axes rows [n, w1, w2] x (x, y, z), plane [p, a_u,
  // a_v], each along K.
  const float* da = d_axes + t * s_axes + j;
  const float* dpl = d_plane + t * s_plane + j;
  const float dp = dpl[0], dau = dpl[k], dav = dpl[2 * k];
  // G[r][c] = dL/dm[r][c]: column 0 is w1, 1 is w2, 2 is n; each frame
  // vector's gradient takes the plane terms (p = -n.(o - mu), a_u = w1.(o -
  // mu), a_v = w2.(o - mu)).
  float g[3][3];
  float d_omm[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g[c][2] = da[(0 * 3 + c) * k] - dp * omm[c];
    g[c][0] = da[(1 * 3 + c) * k] + dau * omm[c];
    g[c][1] = da[(2 * 3 + c) * k] + dav * omm[c];
    d_omm[c] = -dp * r.m[c][2] + dau * r.m[c][0] + dav * r.m[c][1];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) atomicAdd(g_means + 3 * i + c, -d_omm[c]);

  // The rotation matrix's VJP at the unit quaternion, then the
  // normalisation's: (dqn - qn (qn . dqn)) / |q|, or dqn / eps where the
  // clamp held.
  const float w = r.qn[0], x = r.qn[1], y = r.qn[2], z = r.qn[3];
  float dqn[4];
  dqn[0] = 2.0f * (-z * g[0][1] + y * g[0][2] + z * g[1][0] - x * g[1][2]
                   - y * g[2][0] + x * g[2][1]);
  dqn[1] = 2.0f * (y * g[0][1] + z * g[0][2] + y * g[1][0] - w * g[1][2]
                   + z * g[2][0] + w * g[2][1])
           - 4.0f * x * (g[1][1] + g[2][2]);
  dqn[2] = 2.0f * (x * g[0][1] + w * g[0][2] + x * g[1][0] + z * g[1][2]
                   - w * g[2][0] + z * g[2][1])
           - 4.0f * y * (g[0][0] + g[2][2]);
  dqn[3] = 2.0f * (-w * g[0][1] + x * g[0][2] + w * g[1][0] + y * g[1][2]
                   + x * g[2][0] + y * g[2][1])
           - 4.0f * z * (g[0][0] + g[1][1]);
  float4 dq;
  if (r.norm >= kNormEps) {
    const float proj = dqn[0] * w + dqn[1] * x + dqn[2] * y + dqn[3] * z;
    const float inv = 1.0f / r.norm;
    dq = make_float4((dqn[0] - w * proj) * inv, (dqn[1] - x * proj) * inv,
                     (dqn[2] - y * proj) * inv, (dqn[3] - z * proj) * inv);
  } else {
    const float inv = 1.0f / kNormEps;
    dq = make_float4(dqn[0] * inv, dqn[1] * inv, dqn[2] * inv, dqn[3] * inv);
  }
  atomicAdd(g_rotations + i, dq);

  // inv_scale = reciprocal(s): d_s = -(g (r r)).
  const float* dis = d_inv_scale + t * s_inv + j;
  const float r0 = 1.0f / scales[2 * i], r1 = 1.0f / scales[2 * i + 1];
  atomicAdd(g_scales + i, make_float2(-(dis[0] * (r0 * r0)),
                                      -(dis[k] * (r1 * r1))));

  // opac = opacity x valid x (p != 0): validity holds here.
  if (p != 0.0f) atomicAdd(g_opacities + i, d_opac[t * s_opac + j]);

  // d_sh[t][ch][c][k] -> the surfel's row (c, ch), masked past sh_kept;
  // four floats of the row per vector atomic, none for a masked group.
  const float* ds = d_sh + t * s_sh + j;
#pragma unroll
  for (int v = 0; v < kShRow / 4; ++v) {
    if ((4 * v) / 3 >= sh_kept) break;
    float e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = (4 * v + u) / 3, ch = (4 * v + u) % 3;
      e[u] = c < sh_kept ? ds[(ch * kCoeffs + c) * k] : 0.0f;
    }
    atomicAdd(g_sh + i * (kShRow / 4) + v,
              make_float4(e[0], e[1], e[2], e[3]));
  }
}

int blocks_for(int tiles, int k) {
  return static_cast<int>(
      (static_cast<long long>(tiles) * k + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int candidate_gather(const void* means, const void* rotations,
                                const void* scales, const void* opacities,
                                const void* sh, const void* origin,
                                const void* index, const void* valid,
                                void* axes, void* plane, void* inv_scale,
                                void* opac, void* sign, void* sh_out, int n,
                                int tiles, int k, int origin_stride,
                                int sh_kept, void* stream) {
  if (tiles == 0 || k == 0) return static_cast<int>(cudaSuccess);
  candidate_gather_kernel<<<blocks_for(tiles, k), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(means), static_cast<const float*>(rotations),
      static_cast<const float*>(scales),
      static_cast<const float*>(opacities), static_cast<const float4*>(sh),
      static_cast<const float*>(origin),
      static_cast<const long long*>(index), static_cast<const bool*>(valid),
      static_cast<float*>(axes), static_cast<float*>(plane),
      static_cast<float*>(inv_scale), static_cast<float*>(opac),
      static_cast<float*>(sign), static_cast<float*>(sh_out), n, tiles, k,
      origin_stride, sh_kept);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int candidate_scatter(const void* means, const void* rotations,
                                 const void* scales, const void* opacities,
                                 const void* origin, const void* index,
                                 const void* valid, const void* d_axes,
                                 const void* d_plane,
                                 const void* d_inv_scale,
                                 const void* d_opac, const void* d_sh,
                                 void* g_means, void* g_rotations,
                                 void* g_scales, void* g_opacities,
                                 void* g_sh, int n, int tiles, int k,
                                 int origin_stride, int sh_kept, int s_axes,
                                 int s_plane, int s_inv, int s_opac,
                                 int s_sh, void* stream) {
  if (tiles == 0 || k == 0) return static_cast<int>(cudaSuccess);
  candidate_scatter_kernel<<<blocks_for(tiles, k), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(means), static_cast<const float*>(rotations),
      static_cast<const float*>(scales),
      static_cast<const float*>(opacities),
      static_cast<const float*>(origin),
      static_cast<const long long*>(index), static_cast<const bool*>(valid),
      static_cast<const float*>(d_axes), static_cast<const float*>(d_plane),
      static_cast<const float*>(d_inv_scale),
      static_cast<const float*>(d_opac), static_cast<const float*>(d_sh),
      static_cast<float*>(g_means), static_cast<float4*>(g_rotations),
      static_cast<float2*>(g_scales), static_cast<float*>(g_opacities),
      static_cast<float4*>(g_sh), n, tiles, k, origin_stride, sh_kept,
      s_axes, s_plane, s_inv, s_opac, s_sh);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM (out[0]) and threads per block (out[1]) of device
// kernel `which`: 0 the gather, 1 the scatter.  k is unused (neither
// kernel's resources depend on it).  Returns the CUDA error.
extern "C" int candidate_prep_occupancy(int which, int k, int* out) {
  (void)k;
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (which == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, candidate_gather_kernel, kThreads, 0);
  } else if (which == 1) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, candidate_scatter_kernel, kThreads, 0);
  }
  out[0] = blocks;
  out[1] = kThreads;
  return static_cast<int>(err);
}

extern "C" const char* candidate_prep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
