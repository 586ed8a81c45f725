// Backward surfel tracer kernels for Hopper (sm_90a): the hand-derived VJP
// of tracer_forward.cu.
//
// Replaces: lidar_rt_tpu/ops/pallas_backward.py::_backward_kernel, the
// Pallas TPU backward kernel launched by backward_pallas_call, together
// with the in-kernel helper it calls from lidar_rt_tpu/ops/pallas_common.py:
// lane_cumsum, the per-chunk prefix of dL/dw * w, becomes the running
// per-ray prefix in a register.  Modes: tile order, and exact (per-ray
// depth) order, which also replaces the Pallas backward's depth sort
// (lidar_rt_tpu/ops/pallas_sort.py, called at pallas_backward.py:279-292
// and 377-425).  In tile order each pair's values come from a replay of
// the forward (float32), or with the cache (the reference's cache_fwd,
// pallas_backward.py:183-200,243-270) from the forward's bf16 residuals,
// in tracer_backward_cache_kernel; see "Cache" below.  The boundary is the Pallas kernel's: the forward's
// inputs
// plus the forward channels and their upstream gradients, both
// channel-major (T, 16, R); the output is one
// zero-initialised (T, 64, K) buffer whose rows are d_axes (0-8, as
// (3, 3)), d_plane (9-11), d_inv_scale (12-13), d_opac (14), a zero row
// (15) and d_sh (16-63, as (3, 16)), each summed over the tile's rays.
// lidar_rt_tpu_torch/ops/kernels.py splits it into the five gradients.
//
// The math (per ray, per candidate j composited front to back):
//   gw_j     = dL/dw_j = sum_ch g_ch c_ch,j  (channels 0-7 of the forward)
//   A_j      = sum_{k>j} gw_k w_k = gw_total - prefix_j, with gw_total =
//              sum_ch g_ch S_ch from the forward's channels (the cache
//              decode sums A_j itself, walking back to front)
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
// Design.  Per candidate, each of the 63 gradient rows is a sum over the
// tile's rays of a per-ray feature (SH basis, direction, g_5..g_7, 1) times
// a per-pair scalar.  tracer_backward_kernel takes these sums for a block
// of 128 rays, one thread each, staging 64 candidates at a time in shared
// memory, one warp of 32 rays per sum:
//  - rows 0-14 (the 10 geometric scalars against direction, g_5..g_7 and
//    1) with a 16-value transposing butterfly in each half-warp (at each
//    step every lane trades half of its values with its partner, so lane l
//    ends with its half's total of value l & 15), then one atomicAdd per
//    lane, two per row;
//  - the 48 d_sh rows, basis_s x x_ch, as the contraction the TPU kernel
//    takes (pallas_backward.py dot_rays): the warp writes each composited
//    candidate's x_ch to shared memory, and every 8 candidates
//    colour_sums multiplies the (16 x 32) basis of its lanes by the (32 x
//    24) x's on the tensor cores (mma.sync TF32, split 3xTF32 for float32
//    accuracy), 36 MMAs in place of 8 x 48 products and 8 x 1.5 butterflies.
//
// What bounds it on this card (H100; numbers in PERF.md, from
// chip_smoke.py): the dependent chain of each (warp, candidate) step that
// holds a composited pair (~274 K of ~1.19 M steps at the training
// render's inputs): intersection, shading, the transmittance and prefix
// recurrence, the chain to the 63 values, and their sums.  It is latency-
// bound: the tensor-core contraction, which takes fewer instructions than
// the butterflies it replaced, gains only where more candidates are
// composited, while shortening the chain (one fast division for
// dL/dalpha, one for dL/dp, where there were five IEEE divisions) gains
// ~13%, and every register spilled or block per SM lost costs more than an
// instruction saved.  What the design does about it:
//  - a warp first tests 32 candidates at once, one per lane, against a box
//    around its rays' unit directions (warp_cone, cone_misses in
//    tracer_common.cuh, shared with the forward kernels: a conservative
//    bound on the splat coordinates of every direction in the box), and
//    visits only the candidates the test cannot rule out:
//    ~68% of the steps are skipped.  A skipped pair has alpha = 0 for
//    every ray of the warp, which the replay would pass over with no
//    change to T, to the prefix or to the stop (T stays at or above T_MIN
//    once a ray has passed candidate 0, which is never skipped), so the
//    gradients are the same;
//  - registers are held to 80 (launch bound of 6 blocks per SM, which its
//    37 KB of shared memory also allows), with the MMA fragments in a
//    function of their own and the test's box in shared memory;
//  - the gradient divisions, which decide no gate, use __fdividef (2 ulp);
//  - blocks take the tiles in reverse order, heavy ground tiles first:
//    ~5-7% off the tail of the grid (1,344 blocks for 792 resident).
// Variants that lost are in PERF.md.
//
// Exact order runs two kernels.  tracer_backward_exact_kernel replays the
// forward's depth-order walk (the same nearest_hits passes, so the same
// hits in the same order and the same stop) with the running prefix of
// gw * w in that order, and writes each pair's (dL/dalpha, w) to a (T, K,
// R) float2 buffer, zero where the ray composited nothing (8 bytes per
// pair: 352 MB at T = 168, K = 256, R = 1024).  It costs what the exact
// forward costs (the same k-buffer rescans of the staged candidates).
// tracer_backward_kernel<true> then takes the sums over rays in candidate
// order, as in tile order, reading each pair instead of replaying it and
// recomputing its intersection and colour gate from the staged candidate.
// The first exact design summed during the walk, into 64 rows per
// candidate of shared memory (128 KB per 128-ray block, so one block of 4
// warps per SM) with 63 shared-memory atomics per hit on random columns:
// ~10x slower.
//
// Cache (tile order): tracer_backward_cache_kernel reads, for each step
// it visits, the (signed gated alpha, signed exclusive transmittance) pair
// that tracer_forward_kernel<true> wrote there, and decodes it as
// pallas_backward.py:183-200,243-270 does: alpha = |x|, the gradient gate
// is x > 0 (a gate failed at 0, the ALPHA_MAX clamp held below 0), T_excl
// = |y|, the live bit is y > 0, and G = alpha / max(opacity, 1e-12) in
// place of the exp.  A pair whose live bit is off is the ray's stop, and
// gets only the raw-T term, as in the replay (the reference zeroes a
// stopped ray's pairs per 128-candidate chunk only).  The intersection's
// locals that the gradient chain consumes (t, u, v, n.d, w1.d, w2.d) are
// recomputed (splat_locals: with no gate left to decide, the range takes
// the fast division).  Each ray is walked back to front, from the last
// index the forward stored (the candidate that stopped it, or the tile's
// last) down to candidate 0, chunks, steps and bits in reverse, and A_j
// is the sum of the gw w of the pairs already walked: no gw_total and no
// prefix, so no second set of the forward's sums is needed to make the
// two agree.  The cache is written only at the steps the forward visits,
// so this kernel must visit no other: the same box test (rounded alike in
// both translation units, tracer_common.cuh), candidate 0 always, and no
// step above the ray's last index.  A block stages no chunk above its
// rays' largest last index, so it reads no more than a walk to the stop.
//
// What bounds it on this card (PERF.md, chip_smoke.py): as the replay,
// the instructions of each visited step, plus the load of the step's pair
// from device memory, which the chain waits for (the cache, 168 MiB at
// the flagship training shape, is over three times L2; the first,
// front-to-back design took 0.420 ms where the replay takes 0.344, and
// loading each pair at its step, with the rest of this design, 0.399).
// What the design does about it: each pair is loaded two steps ahead (two
// registers in turn; a rotated queue waits on its moves), the decode drops
// the exp, the gates and the transmittance product, the candidates are
// staged whole in rows of kQuads + 1 float4 slots (constant offsets for
// every read; the swizzled rows of the forwards cost an index computation
// each, 6% here), and the SH basis, which the colour contraction already
// keeps in shared memory, is read from there in rows of kBasisRow floats
// per lane (constant offsets again) rather than held in 16 registers (80
// registers; 8 bytes of spill stores with the fast sums, as the replay's).
// Together 0.42 -> 0.33 ms, under the replay.
// Staging a chunk's pairs on chip (cp.async, TMA) does not fit: the 6
// blocks per SM leave ~0.4 KB of shared memory per block.
//
// fast (the reference's fast_math, pallas_backward.py:127-135, its d_sh
// contraction in one bf16 pass): colour_sums takes each d_sh product as
// one TF32 mma.sync (operands rounded to nearest TF32) where float32
// takes three (3xTF32).  It applies to every source: tile order replayed
// or cached, and the exact order's sums kernel.

#include <cuda_bf16.h>

#include "tracer_common.cuh"

namespace {

using namespace tracer;

constexpr int kGradRows = 64;  // rows of the (T, 64, K) gradient output
constexpr int kShRow = 16;     // first d_sh row
constexpr int kSumChunk = 64;  // candidates the sums kernel stages per round
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 8;      // candidates per colour contraction
constexpr int kWalkRays = 256;  // rays per exact walk block
// The cache kernel: candidates staged per round, in rows of kCacheStride
// float4 slots (60 x 17 x 16 bytes, where 64 would cost a block per SM),
// and its shared basis layout (basis_word).
constexpr int kCacheChunk = 60;
constexpr int kCacheStride = kQuads + 1;
constexpr int kBasisRow = 17;

// Where tracer_backward_kernel takes each pair's values: a replay of the
// forward (tile order) or the exact walk's (dL/dalpha, w) pairs.
enum PairSource { kReplay = 0, kFromPairs = 1 };

static_assert(kSumChunk <= kThreads, "each thread stages one candidate");
static_assert(kCacheChunk <= 64 && kCacheChunk <= kThreads,
              "the cache kernel's 64-bit step masks; one candidate a thread");
static_assert(kWalkRays % 32 == 0, "whole warps");

// One butterfly step: a lane keeps the half of its kHalf * 2 live values
// selected by its lane bit kHalf and adds its partner's copy of that half.
template <int kHalf>
__device__ __forceinline__ void butterfly_step(float (&v)[16], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
}

// Lane l of the warp returns the sum of v[l & 15] over the 16 lanes of its
// half-warp; v is clobbered.  Every index is a compile-time constant, so v
// stays in registers.
__device__ __forceinline__ float half_warp_transpose_sum(float (&v)[16],
                                                         int lane) {
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

// Lane l's word of row r in a warp's shared (rows, 32 lanes) array.  Row r
// is rotated by 4 r lanes, so that the mma fragment loads of
// colour_sums, 8 rows by 4 lanes at once, hit 32 different banks.
__device__ __forceinline__ int lane_word(int r, int l) {
  return r * 32 + ((l + 4 * r) & 31);
}

// Where a warp's shared copy of its lanes' SH basis keeps lane l's value
// s: with kRow = 0 at lane_word(s, l); else in a row of kRow >= 16 floats
// per lane, at l kRow + s, so that a lane reads its own values at constant
// offsets (kRow = 17: each of a warp's 32 rows starts in another bank).
template <int kRow>
__device__ __forceinline__ int basis_word(int s, int l) {
  return kRow == 0 ? lane_word(s, l) : l * kRow + s;
}

// Lane l's SH basis read as an array from its warp's shared copy: the
// cache kernel keeps no copy in registers.
template <int kRow>
struct SharedBasis {
  const float* s_basis;
  int lane;
  __device__ __forceinline__ float operator[](int s) const {
    return s_basis[basis_word<kRow>(s, lane)];
  }
};

// x as hi + lo for the TF32 tensor cores, which read only the top 19
// bits of an operand: hi is x with its low 13 mantissa bits cleared and lo
// = x - hi (exact), so hi + lo, as read, is x to within 2^-20 |x|.  Two
// instructions, where cvt.rna.tf32.f32 is several.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// x rounded to the nearest TF32 value, as the tensor cores read it.
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a b on the tensor cores: a (16 x 8, row-major), b (8 x 8), d
// (16 x 8), float accumulation, one warp.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The d_sh rows of up to kSlots candidates at once, as the product the
// TPU kernel takes over rays: d_sh[ch][s][cand] = sum over the warp's 32
// lanes of basis_s(lane) x_ch(lane, cand).  s_basis holds the lanes' SH
// basis (16 rows), s_x their x_ch for each slot (row ch * kSlots + slot),
// both in lane_word order; lane p's slot_cand is slot p's candidate, and
// slots [pending, kSlots) are ignored.  Three TF32 products per term
// (hi hi, hi lo, lo hi: the 3xTF32 split) keep float32's accuracy; kFast
// takes one, of the operands rounded to TF32.  Every lane of the warp
// calls it.  Not inlined: its fragments would otherwise share the
// candidate loop's registers and spill the loop's state.
template <bool kFast, int kRow = 0>
__device__ __noinline__ void colour_sums(const float* s_basis,
                                         const float* s_x, int pending,
                                         int slot_cand,
                                         float* __restrict__ grads,
                                         long long tile, int k, int lane) {
  __syncwarp();
  const int grp = lane >> 2, tig = lane & 3;
  float d[3][4] = {};
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // lanes [8 q, 8 q + 8)
    const int l0 = 8 * q + tig, l1 = l0 + 4;
    const float a[4] = {s_basis[basis_word<kRow>(grp, l0)],
                        s_basis[basis_word<kRow>(grp + 8, l0)],
                        s_basis[basis_word<kRow>(grp, l1)],
                        s_basis[basis_word<kRow>(grp + 8, l1)]};
    unsigned ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kFast) {
        ah[i] = to_tf32(a[i]);
      } else {
        split_tf32(a[i], ah[i], al[i]);
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float b[2] = {s_x[lane_word(ch * kSlots + grp, l0)],
                          s_x[lane_word(ch * kSlots + grp, l1)]};
      unsigned bh[2], bl[2];
      if (kFast) {
        bh[0] = to_tf32(b[0]);
        bh[1] = to_tf32(b[1]);
      } else {
        split_tf32(b[0], bh[0], bl[0]);
        split_tf32(b[1], bh[1], bl[1]);
        mma_tf32(d[ch], al, bh);
        mma_tf32(d[ch], ah, bl);
      }
      mma_tf32(d[ch], ah, bh);
    }
  }
  // d[ch] = rows (grp, grp + 8) x slots (2 tig, 2 tig + 1).
  const int p0 = 2 * tig, p1 = p0 + 1;
  const int c0 = __shfl_sync(0xffffffffu, slot_cand, p0);
  const int c1 = __shfl_sync(0xffffffffu, slot_cand, p1);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const int row = kShRow + 16 * ch + grp;
    if (p0 < pending) {
      add_row(grads, tile, row, k, c0, d[ch][0]);
      add_row(grads, tile, row + 8, k, c0, d[ch][2]);
    }
    if (p1 < pending) {
      add_row(grads, tile, row, k, c1, d[ch][1]);
      add_row(grads, tile, row + 8, k, c1, d[ch][3]);
    }
  }
  __syncwarp();
}

// A ray's inputs: its direction, min range and t0, the upstream gradients
// of its 10 channel rows, gw_total = sum_ch g_ch S_ch over rows 0-7 of the
// forward's channels `fwd`, its T_out and g_9 T_raw.
__device__ __forceinline__ void load_ray(
    long long ray_at, int rays, const float* __restrict__ dirs,
    const float* __restrict__ mind, const float* __restrict__ t0,
    const float* __restrict__ fwd, const float* __restrict__ up, float& dx,
    float& dy, float& dz, float& min_t, float& trans0, float (&g)[10],
    float& gw_total, float& t_out, float& g_raw) {
  dx = dirs[ray_at * 3 + 0];
  dy = dirs[ray_at * 3 + 1];
  dz = dirs[ray_at * 3 + 2];
  min_t = mind[ray_at];
  trans0 = t0[ray_at];
#pragma unroll
  for (int c = 0; c < 10; ++c) g[c] = up[c * rays];
#pragma unroll
  for (int c = 0; c < 8; ++c) gw_total += g[c] * fwd[c * rays];
  t_out = fwd[8 * rays];
  g_raw = g[9] * fwd[9 * rays];
}

// The terms of one pair of a ray, from its gated alpha, the
// transmittance before it, its live bit (the forward's T_MIN test) and
// its gradient gate (every gate passed and the ALPHA_MAX clamp off): the
// hit's weight w, dL/dalpha and the colour terms x_ch of the SH gradient,
// which the caller zeroes.  `running` is the ray's running sum of gw * w:
// walking in compositing order (kSuffix false) the prefix, which this
// pair joins before A_j = gw_total - prefix is taken; walking back to
// front (kSuffix true) A_j itself, the sum over the pairs after this one,
// which this pair joins after it is used.  A pair that is not live is the
// stop hit, seen by the raw-T row only.  `geo` reads the candidate's
// geometry, `shc` its SH values (RowCand and RowSh, or a QuadCand for
// both), `basis` the ray's SH basis (as shade_cand).
template <bool kSuffix, typename Geo, typename Sh, typename Basis>
__device__ __forceinline__ void pair_terms(
    float alpha, float trans, bool live, bool grad_gate, float t,
    const Geo& geo, const Sh& shc, const Basis& basis,
    const float (&g)[10], float gw_total, float t_out, float g_raw,
    float& running, float& d_alpha, float& w, float& x0, float& x1,
    float& x2) {
  const float one_m = fmaxf(1.0f - alpha, 1e-6f);
  if (!live) {
    if (grad_gate) d_alpha = -__fdividef(g_raw, one_m);
  } else if (alpha > 0.0f) {
    w = alpha * trans;
    float c0, c1, c2;
    shade_cand(basis, shc, c0, c1, c2);
    const float col0 = c0 + 0.5f;
    const float sg = geo.back().m.w;
    const float3 n = geo.normal();
    const float gw = g[0] * fmaxf(col0, 0.0f) + g[1] * (c1 + 0.5f)
                     + g[2] * (c2 + 0.5f) + g[3] * t + g[4]
                     + sg * (g[5] * n.x + g[6] * n.y + g[7] * n.z);
    float after;  // A_j
    if (kSuffix) {
      after = running;
      running += gw * w;
    } else {
      running += gw * w;
      after = gw_total - running;
    }
    if (grad_gate) {
      d_alpha = gw * trans
                - __fdividef(after + g[8] * t_out + g_raw, one_m);
    }
    x0 = col0 > 0.0f ? g[0] * w : 0.0f;
    x1 = g[1] * w;
    x2 = g[2] * w;
  }
}

// Replays the forward at hit h of candidate j, in the forward's order:
// the stop rule and pair_terms; advances trans and alive.
template <typename Rows>
__device__ __forceinline__ void replay_hit(
    const Hit& h, Rows s_geo, Rows s_sh, int j, const float basis[16],
    const float (&g)[10], float gw_total, float t_out, float g_raw,
    float& trans, float& prefix, bool& alive, float& d_alpha, float& w,
    float& x0, float& x1, float& x2) {
  const float next = next_trans(trans, h.alpha);
  const bool live = !(next < kTMin);
  pair_terms<false>(h.alpha, trans, live,
                    h.alpha > 0.0f && h.alpha_raw < kAlphaMax, h.t,
                    RowCand<Rows>{s_geo, j}, RowSh<Rows>{s_sh, j}, basis, g,
                    gw_total, t_out, g_raw, prefix, d_alpha, w, x0, x1, x2);
  if (!live) {
    alive = false;
  } else if (h.alpha > 0.0f) {
    trans = next;
  }
}

// The intersection's locals that the gradient chain consumes (n.d, t,
// w1.d, w2.d, u, v) of a pair that passed every gate in the forward: the
// decode decides no gate, so none is tested, and t takes the fast
// division (2 ulp; the forward's IEEE t decided the range gate).
template <typename Cand>
__device__ __forceinline__ Hit splat_locals(const Cand& cand, float dx,
                                            float dy, float dz) {
  Hit h = {};
  const float3 n = cand.normal();
  const GeoBack b = cand.back();
  h.qd = dot3_rn(dx, dy, dz, n.x, n.y, n.z);
  h.t = __fdividef(cand.p(), h.qd);
  h.bu = dot3_rn(dx, dy, dz, b.w1.x, b.w1.y, b.w1.z);
  h.bv = dot3_rn(dx, dy, dz, b.w2.x, b.w2.y, b.w2.z);
  h.u = __fmul_rn(__fadd_rn(b.w1.w, __fmul_rn(h.t, h.bu)), b.m.x);
  h.v = __fmul_rn(__fadd_rn(b.w2.w, __fmul_rn(h.t, h.bv)), b.m.y);
  return h;
}

// Decodes the forward's cached residuals `res`, the bits of one
// __nv_bfloat162 (signed gated alpha in the low half, signed exclusive
// transmittance in the high), of candidate `cand` (see "Cache" above) in
// place of a replay: h gets the intersection's locals and G = alpha /
// opacity; then pair_terms, walking back to front (`suffix`, A_j).
template <typename Cand, typename Basis>
__device__ __forceinline__ void decode_hit(
    unsigned res, const Cand& cand, float dx, float dy, float dz,
    const Basis& basis, const float (&g)[10], float t_out,
    float g_raw, float& suffix, Hit& h, float& d_alpha, float& w, float& x0,
    float& x1, float& x2) {
  const float x = __uint_as_float(res << 16);
  const float y = __uint_as_float(res & 0xffff0000u);
  const float alpha = fabsf(x);
  if (alpha > 0.0f) {
    h = splat_locals(cand, dx, dy, dz);
    h.alpha = alpha;
    h.g = __fdividef(alpha, fmaxf(cand.back().m.z, 1e-12f));
  }
  pair_terms<true>(alpha, fabsf(y), y > 0.0f, x > 0.0f, h.t, cand, cand,
                   basis, g, 0.0f, t_out, g_raw, suffix, d_alpha, w, x0, x1,
                   x2);
}

// The chain of one pair from dL/dalpha and its weight w to the candidate's
// fields: alpha -> (opacity, G) -> (u, v) -> (a_u, a_v, 1/s, t) -> (p,
// n.d, w1.d, w2.d), plus the direct depth term g_3 w.
struct PairGrad {
  float d_qd, d_bu, d_bv, d_p, d_au, d_av, d_is0, d_is1, d_op, sw;
};

template <typename Cand>
__device__ __forceinline__ PairGrad pair_grad(const Cand& cand, const Hit& h,
                                              float d_alpha, float w,
                                              float g3) {
  PairGrad p;
  const GeoBack b = cand.back();
  const float is0 = b.m.x, is1 = b.m.y;
  p.d_op = d_alpha * h.g;
  const float d_gg = d_alpha * b.m.z * h.g;
  const float d_u = -d_gg * h.u;
  const float d_v = -d_gg * h.v;
  const float d_t = d_u * is0 * h.bu + d_v * is1 * h.bv + g3 * w;
  p.d_p = __fdividef(d_t, h.qd);  // dL/dp
  p.d_qd = -p.d_p * h.t;
  p.d_au = d_u * is0;
  p.d_av = d_v * is1;
  p.d_is0 = d_u * (b.w1.w + h.t * h.bu);
  p.d_is1 = d_v * (b.w2.w + h.t * h.bv);
  p.d_bu = p.d_au * h.t;
  p.d_bv = p.d_av * h.t;
  p.sw = b.m.w * w;
  return p;
}

// The sums of one (warp, candidate) step in which some lane has a pair
// (`active`: dL/dalpha or w nonzero; the others pass zeros): rows 0-14 for
// each lane's pair, summed at once in each half-warp into candidate
// `cand`'s columns, then, if some lane composited it, its colour terms
// into the warp's next slot, and every kSlots slots colour_sums.  Every
// lane of the warp calls it.
template <bool kFast, int kRow = 0, typename Cand>
__device__ __forceinline__ void step_sums(
    const Cand& geo, const Hit& h, bool active, float d_alpha, float w,
    float x0, float x1, float x2, const float (&g)[10], float dx, float dy,
    float dz, int lane, int cand, long long tile, int k,
    float* __restrict__ grads, const float* s_basis, float* s_x,
    int& pending, int& slot_cand) {
  {
    float v[16];
    PairGrad p = {};
    if (active) p = pair_grad(geo, h, d_alpha, w, g[3]);
    v[0] = dx * p.d_qd + p.sw * g[5];
    v[1] = dy * p.d_qd + p.sw * g[6];
    v[2] = dz * p.d_qd + p.sw * g[7];
    v[3] = dx * p.d_bu;
    v[4] = dy * p.d_bu;
    v[5] = dz * p.d_bu;
    v[6] = dx * p.d_bv;
    v[7] = dy * p.d_bv;
    v[8] = dz * p.d_bv;
    v[9] = p.d_p;
    v[10] = p.d_au;
    v[11] = p.d_av;
    v[12] = p.d_is0;
    v[13] = p.d_is1;
    v[14] = p.d_op;
    v[15] = 0.0f;
    const float sum = half_warp_transpose_sum(v, lane);
    if ((lane & 15) < 15) add_row(grads, tile, lane & 15, k, cand, sum);
  }
  if (!__any_sync(0xffffffffu, w != 0.0f)) return;
  s_x[lane_word(pending, lane)] = x0;
  s_x[lane_word(kSlots + pending, lane)] = x1;
  s_x[lane_word(2 * kSlots + pending, lane)] = x2;
  if (lane == pending) slot_cand = cand;
  if (++pending == kSlots) {
    colour_sums<kFast, kRow>(s_basis, s_x, pending, slot_cand, grads, tile,
                             k, lane);
    pending = 0;
  }
}

// The sums over rays, one thread per ray.  kSrc = kReplay: tile order,
// the walk replayed here.  kFromPairs: exact order, each pair's
// (dL/dalpha, w) read from `pairs` (T, K, R), written by
// tracer_backward_exact_kernel.  kFast: the d_sh sums in one TF32 product
// per term.  A warp visits only the candidates
// that its cone of rays may hit (cone_misses, tested 32 candidates at a
// time, one per lane): the others have alpha = 0 for all its rays, which the
// replay would pass over without a change, except candidate 0, where a
// ray whose t0 is already below T_MIN stops.  Of a visited candidate with
// a pair in the warp, rows 0-14 are summed at once in each half-warp; the
// colour terms go to the warp's next slot, and every kSlots candidates
// colour_sums takes the d_sh rows of all of them (step_sums).
template <int kSrc, bool kFast>
__global__ void __launch_bounds__(kThreads, 6) tracer_backward_kernel(
    const int* __restrict__ cnt, const float* __restrict__ dirs,
    const float* __restrict__ mind, const float* __restrict__ t0,
    const float* __restrict__ axes, const float* __restrict__ plane,
    const float* __restrict__ inv_scale, const float* __restrict__ opac,
    const float* __restrict__ sign, const float* __restrict__ sh,
    const float* __restrict__ fwd_chans, const float* __restrict__ g_chans,
    const float2* __restrict__ pairs, float* __restrict__ grads, int rays,
    int k) {
  constexpr bool kPairs = kSrc == kFromPairs;
  __shared__ float s_geo[kGeo][kSumChunk];
  __shared__ float s_sh[kSh][kSumChunk];
  __shared__ float s_basis_all[kWarps][16 * 32];
  __shared__ float s_x_all[kWarps][3 * kSlots * 32];
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
  const int warp = threadIdx.x / 32;
  const long long ray_at = tile * rays + ray;
  float* s_basis = s_basis_all[warp];
  float* s_x = s_x_all[warp];

  float dx = 0.0f, dy = 0.0f, dz = 0.0f, min_t = 0.0f, trans0 = 0.0f;
  float g[10] = {};
  float gw_total = 0.0f, t_out = 0.0f, g_raw = 0.0f;
  if (has_ray) {
    const long long at = tile * kOutRows * rays + ray;
    load_ray(ray_at, rays, dirs, mind, t0, fwd_chans + at, g_chans + at, dx,
             dy, dz, min_t, trans0, g, gw_total, t_out, g_raw);
  }
  float basis[16];
  sh_basis(dx, dy, dz, basis);
#pragma unroll
  for (int s = 0; s < 16; ++s) s_basis[lane_word(s, lane)] = basis[s];
#pragma unroll
  for (int r = 0; r < 3 * kSlots; ++r) s_x[lane_word(r, lane)] = 0.0f;
  {
    const Cone cone = warp_cone(dx, dy, dz, has_ray);
    if (lane == 0) s_cone[warp] = cone;
    __syncwarp();
  }
  const Cone& cone = s_cone[warp];

  float trans = trans0;
  float prefix = 0.0f;  // running sum of gw * w over composited hits
  bool alive = has_ray;
  int pending = 0;      // filled colour slots, the same in every lane
  int slot_cand = 0;    // lane p < pending: slot p's candidate

  const int count = min(max(cnt[tile], 0), k);
  for (int base = 0; base < count; base += kSumChunk) {
    // Barrier before shared memory is overwritten; in tile order the
    // whole block stops once none of its rays is alive.
    if (kPairs) {
      __syncthreads();
    } else if (!__syncthreads_or(alive)) {
      break;
    }
    const int n = min(kSumChunk, count - base);
    stage_chunk(s_geo, s_sh, tile, k, base, n, axes, plane, inv_scale, opac,
                sign, sh);
    __syncthreads();
    if (!kPairs && !__any_sync(0xffffffffu, alive)) continue;

    for (int group = 0; group < n; group += 32) {
      const int mine = group + lane;
      const bool visit = mine < n && ((base == 0 && mine == 0)
                                      || !cone_misses(s_geo, mine, cone));
      unsigned todo = __ballot_sync(0xffffffffu, visit);
      while (todo != 0u) {
        const int j = group + __ffs(todo) - 1;
        todo &= todo - 1u;
        Hit h = {};
        float d_alpha = 0.0f, w = 0.0f, x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
        if (kPairs) {
          if (has_ray) {
            const float2 pw = pairs[(tile * k + base + j) * rays + ray];
            d_alpha = pw.x;
            w = pw.y;
          }
          if (d_alpha != 0.0f || w != 0.0f) {
            h = intersect(s_geo, j, dx, dy, dz, min_t);
            if (w != 0.0f) {  // the colour gate, as replay_hit decides it
              float c0, c1, c2;
              shade(basis, s_sh, j, c0, c1, c2);
              const float col0 = c0 + 0.5f;
              x0 = col0 > 0.0f ? g[0] * w : 0.0f;
              x1 = g[1] * w;
              x2 = g[2] * w;
            }
          }
        } else if (alive) {
          // Replay: the same gates, stop and shading as the forward.
          h = intersect(s_geo, j, dx, dy, dz, min_t);
          replay_hit(h, s_geo, s_sh, j, basis, g, gw_total, t_out, g_raw,
                     trans, prefix, alive, d_alpha, w, x0, x1, x2);
        }
        const bool active = d_alpha != 0.0f || w != 0.0f;
        if (!__any_sync(0xffffffffu, active)) continue;
        step_sums<kFast>(RowCand<float (*)[kSumChunk]>{s_geo, j}, h, active,
                         d_alpha, w, x0, x1, x2, g, dx, dy, dz, lane,
                         base + j, tile, k, grads, s_basis, s_x, pending,
                         slot_cand);
      }
    }
  }
  if (pending > 0) {
    colour_sums<kFast>(s_basis, s_x, pending, slot_cand, grads, tile, k,
                       lane);
  }
}

// The cache decode (tile order; see "Cache" above): the sums over rays,
// one thread per ray, each pair decoded from the forward's `cache` (T, K,
// R) and each ray walked from its `last` index (T, R) down to candidate
// 0.  A chunk's kCacheChunk candidates are staged whole and box-tested at
// once, two per lane, into a 64-bit mask of the warp's steps (none above
// its rays' largest last index), walked from the top bit down, each pair
// loaded two steps ahead.  A lane reads only the steps at or below its
// own last index.  The rows and colour terms of each step are summed as
// in tracer_backward_kernel (step_sums).
template <bool kFast>
__global__ void __launch_bounds__(kThreads, 6) tracer_backward_cache_kernel(
    const int* __restrict__ cnt, const float* __restrict__ dirs,
    const float* __restrict__ mind, const float* __restrict__ t0,
    const float* __restrict__ axes, const float* __restrict__ plane,
    const float* __restrict__ inv_scale, const float* __restrict__ opac,
    const float* __restrict__ sign, const float* __restrict__ sh,
    const float* __restrict__ fwd_chans, const float* __restrict__ g_chans,
    const __nv_bfloat162* __restrict__ cache, const int* __restrict__ last,
    float* __restrict__ grads, int rays, int k) {
  __shared__ float4 s_cand[kCacheChunk * kCacheStride];
  __shared__ float s_basis_all[kWarps][32 * (kBasisRow ? kBasisRow : 16)];
  __shared__ float s_x_all[kWarps][3 * kSlots * 32];
  __shared__ Cone s_cone[kWarps];

  const long long tile = gridDim.y - 1 - blockIdx.y;  // last-first
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool has_ray = ray < rays;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const long long ray_at = tile * rays + ray;
  float* s_basis = s_basis_all[warp];
  float* s_x = s_x_all[warp];

  float dx = 0.0f, dy = 0.0f, dz = 0.0f, min_t = 0.0f, trans0 = 0.0f;
  float g[10] = {};
  float gw_total = 0.0f, t_out = 0.0f, g_raw = 0.0f;
  int top = -1;  // this ray's last index: no step above it is read
  if (has_ray) {
    const long long at = tile * kOutRows * rays + ray;
    load_ray(ray_at, rays, dirs, mind, t0, fwd_chans + at, g_chans + at, dx,
             dy, dz, min_t, trans0, g, gw_total, t_out, g_raw);
    top = last[ray_at];
  }
  {
    float basis[16];
    sh_basis(dx, dy, dz, basis);
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      s_basis[basis_word<kBasisRow>(s, lane)] = basis[s];
    }
  }
  const SharedBasis<kBasisRow> basis{s_basis, lane};
#pragma unroll
  for (int r = 0; r < 3 * kSlots; ++r) s_x[lane_word(r, lane)] = 0.0f;
  {
    const Cone cone = warp_cone(dx, dy, dz, has_ray);
    if (lane == 0) s_cone[warp] = cone;
    __syncwarp();
  }
  const Cone& cone = s_cone[warp];
  const int warp_top = __reduce_max_sync(0xffffffffu, top);
  // This ray's pairs, candidate c at c * rays.
  const unsigned* steps = reinterpret_cast<const unsigned*>(cache)
                          + tile * k * rays + ray;

  float suffix = 0.0f;  // A_j: the sum of gw * w over the pairs walked
  int pending = 0;      // filled colour slots, the same in every lane
  int slot_cand = 0;    // lane p < pending: slot p's candidate

  const int count = min(max(cnt[tile], 0), k);
  for (int base = max(count - 1, 0) / kCacheChunk * kCacheChunk; base >= 0;
       base -= kCacheChunk) {
    // Barrier before shared memory is overwritten; a chunk above every
    // ray's last index is not staged.
    if (!__syncthreads_or(top >= base)) continue;
    const int n = min(kCacheChunk, count - base);
    if (threadIdx.x < n) {
      stage_quads<kCacheStride>(s_cand, threadIdx.x, tile, k,
                                base + threadIdx.x, axes, plane, inv_scale,
                                opac, sign, sh);
    }
    __syncthreads();
    if (warp_top < base) continue;  // warp-uniform

    // The steps the forward visited (candidate 0 always), bit c for
    // candidate base + c.
    unsigned long long todo = 0ull;
#pragma unroll
    for (int half = 0; half < (kCacheChunk + 31) / 32; ++half) {
      const int mine = 32 * half + lane;
      const bool visit =
          mine < n && base + mine <= warp_top
          && ((base == 0 && mine == 0)
              || !cone_misses_cand(quad_cand<kCacheStride>(s_cand, mine),
                                   cone));
      todo |= static_cast<unsigned long long>(
                  __ballot_sync(0xffffffffu, visit)) << (32 * half);
    }
    // The next step down (-1 past the last), taken off the mask, and its
    // pair, loaded where this lane reads it.
    const auto pop = [&todo]() {
      if (todo == 0ull) return -1;
      const int c = 63 - __clzll(todo);
      todo ^= 1ull << c;
      return c;
    };
    const auto load = [&](int c) {
      return c >= 0 && base + c <= top
                 ? __ldcs(steps + static_cast<long long>(base + c) * rays)
                 : 0u;
    };
    // Step j's sums, from its pair `res`.
    const auto step = [&](int j, unsigned res) {
      const QuadCand cand = quad_cand<kCacheStride>(s_cand, j);
      Hit h = {};
      float d_alpha = 0.0f, w = 0.0f, x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
      if (base + j <= top) {
        decode_hit(res, cand, dx, dy, dz, basis, g, t_out, g_raw, suffix, h,
                   d_alpha, w, x0, x1, x2);
      }
      const bool active = d_alpha != 0.0f || w != 0.0f;
      if (__any_sync(0xffffffffu, active)) {
        step_sums<kFast, kBasisRow>(cand, h, active, d_alpha, w, x0, x1, x2,
                                    g, dx, dy, dz, lane, base + j, tile, k,
                                    grads, s_basis, s_x, pending, slot_cand);
      }
    };
    // The steps go in turn through two registers, each refilled with the
    // pair two steps down as its step starts, so that a load runs under
    // two steps' work.  (One register loaded one step ahead was 1% slower;
    // a longer queue in an array, rotated each step, no faster: moving a
    // register whose load is in flight waits for the load.)
    int ja = pop(), jb = pop();
    unsigned ra = load(ja), rb = load(jb);
    while (ja >= 0) {
      {
        const int j = ja;
        const unsigned res = ra;
        ja = pop();
        ra = load(ja);
        step(j, res);
      }
      if (jb < 0) break;
      {
        const int j = jb;
        const unsigned res = rb;
        jb = pop();
        rb = load(jb);
        step(j, res);
      }
    }
  }
  if (pending > 0) {
    colour_sums<kFast, kBasisRow>(s_basis, s_x, pending, slot_cand, grads,
                                  tile, k, lane);
  }
}

// Exact order, first kernel: the VJP's walk in each ray's depth order.
// It replays tracer_forward_exact_kernel (the same nearest_hits passes,
// here over every staged candidate where the forward scans only its
// warp's box-test survivors: the same hits in the same order and the same
// stop) with the running
// prefix of gw * w in that order, and writes each pair's (dL/dalpha, w) to
// pairs[tile][j][ray]: zero for j < count unless the ray composited j or
// stopped at it.  Dynamic shared memory: the tile's kGeo + kSh staged
// rows, k floats each.
__global__ void __launch_bounds__(kWalkRays) tracer_backward_exact_kernel(
    const int* __restrict__ cnt, const float* __restrict__ dirs,
    const float* __restrict__ mind, const float* __restrict__ t0,
    const float* __restrict__ axes, const float* __restrict__ plane,
    const float* __restrict__ inv_scale, const float* __restrict__ opac,
    const float* __restrict__ sign, const float* __restrict__ sh,
    const float* __restrict__ fwd_chans, const float* __restrict__ g_chans,
    float2* __restrict__ pairs, int rays, int k) {
  extern __shared__ float smem[];
  const RowView s_geo{smem, k};
  const RowView s_sh{smem + kGeo * k, k};

  const long long tile = blockIdx.y;
  const int ray = blockIdx.x * kWalkRays + threadIdx.x;
  const bool has_ray = ray < rays;
  const long long ray_at = tile * rays + ray;
  const int count = min(max(cnt[tile], 0), k);
  stage_all<kWalkRays>(s_geo, s_sh, tile, k, count, axes, plane, inv_scale,
                       opac, sign, sh);
  __syncthreads();

  float dx = 0.0f, dy = 0.0f, dz = 0.0f, min_t = 0.0f, trans0 = 0.0f;
  float g[10] = {};
  float gw_total = 0.0f, t_out = 0.0f, g_raw = 0.0f;
  float2* mine = pairs + tile * k * rays + ray;  // candidate j at j * rays
  if (has_ray) {
    const long long at = tile * kOutRows * rays + ray;
    load_ray(ray_at, rays, dirs, mind, t0, fwd_chans + at, g_chans + at, dx,
             dy, dz, min_t, trans0, g, gw_total, t_out, g_raw);
    // Zero this ray's pairs here, where the coalesced stores overlap the
    // walk's arithmetic: a memset of the buffer would be a pass of its own
    // over the same bytes, slower on the card (PERF.md).
    for (int j = 0; j < count; ++j) {
      mine[static_cast<long long>(j) * rays] = make_float2(0.0f, 0.0f);
    }
  }
  float basis[16];
  sh_basis(dx, dy, dz, basis);

  float trans = trans0;
  float prefix = 0.0f;
  bool alive = has_ray;
  unsigned long long cur = 0;
  while (alive) {
    unsigned long long bk[kBuf];
    nearest_hits(RowStage{s_geo}, AllCands{}, count, dx, dy, dz, min_t, cur,
                 bk);
#pragma unroll
    for (int b = 0; b < kBuf; ++b) {
      if (bk[b] == kEmptyKey) break;
      const int j = key_index(bk[b]);
      const Hit h = intersect(s_geo, j, dx, dy, dz, min_t);
      float d_alpha = 0.0f, w = 0.0f, x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
      replay_hit(h, s_geo, s_sh, j, basis, g, gw_total, t_out, g_raw, trans,
                 prefix, alive, d_alpha, w, x0, x1, x2);
      if (d_alpha != 0.0f || w != 0.0f) {
        mine[static_cast<long long>(j) * rays] = make_float2(d_alpha, w);
      }
      if (!alive) break;
    }
    if (!alive || bk[kBuf - 1] == kEmptyKey) break;
    cur = bk[kBuf - 1];
  }
}

int walk_smem(int k) {
  return static_cast<int>(sizeof(float)) * (kGeo + kSh) * k;
}

using SumsKernel = void (*)(const int*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float2*, float*, int, int);
using CacheKernel = void (*)(const int*, const float*, const float*,
                             const float*, const float*, const float*,
                             const float*, const float*, const float*,
                             const float*, const float*, const float*,
                             const __nv_bfloat162*, const int*, float*, int,
                             int);

// The sums kernel of a pair source and precision.
SumsKernel sums_kernel(int src, bool fast) {
  switch (2 * src + (fast ? 1 : 0)) {
    case 2 * kReplay: return tracer_backward_kernel<kReplay, false>;
    case 2 * kReplay + 1: return tracer_backward_kernel<kReplay, true>;
    case 2 * kFromPairs: return tracer_backward_kernel<kFromPairs, false>;
    default: return tracer_backward_kernel<kFromPairs, true>;
  }
}

CacheKernel cache_kernel(bool fast) {
  return fast ? tracer_backward_cache_kernel<true>
              : tracer_backward_cache_kernel<false>;
}

}  // namespace

// Launches the kernels on `stream` over (tiles, rays, k), in exact order if
// `exact` is nonzero; returns the first CUDA error of the launches.  grads
// (tiles, 64, k) must be zero.  pairs: exact order's (tiles, k, rays)
// float2 buffer, uninitialised (the walk writes what the sums read);
// unused in tile order.  cache, last: null (replay), or in tile order the
// forward's (tiles, k, rays) __nv_bfloat162 residuals and (tiles, rays)
// int32 last indices, as tracer_forward wrote them for these inputs.
// fast: the d_sh sums in one TF32 product per term.
extern "C" int tracer_backward(const void* cnt, const void* dirs,
                               const void* mind, const void* t0,
                               const void* axes, const void* plane,
                               const void* inv_scale, const void* opac,
                               const void* sign, const void* sh,
                               const void* fwd_chans, const void* g_chans,
                               void* pairs, const void* cache,
                               const void* last, void* grads, int tiles,
                               int rays, int k, int exact, int fast,
                               void* stream) {
  if ((exact && cache != nullptr)
      || ((cache == nullptr) != (last == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0 || rays == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((rays + kThreads - 1) / kThreads, tiles);
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
  const auto fc = static_cast<const float*>(fwd_chans);
  const auto gc = static_cast<const float*>(g_chans);
  const auto pr = static_cast<float2*>(pairs);
  const auto gr = static_cast<float*>(grads);
  if (exact) {
    const int smem = walk_smem(k);
    cudaError_t err = cudaFuncSetAttribute(
        tracer_backward_exact_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 walk_grid((rays + kWalkRays - 1) / kWalkRays, tiles);
    tracer_backward_exact_kernel<<<walk_grid, kWalkRays, smem, s>>>(
        c, d, md, tr, ax, pl, is, op, sg, shc, fc, gc, pr, rays, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const SumsKernel sums = sums_kernel(kFromPairs, fast != 0);
    sums<<<grid, kThreads, 0, s>>>(c, d, md, tr, ax, pl, is, op, sg, shc, fc,
                                   gc, pr, gr, rays, k);
  } else if (cache != nullptr) {
    const CacheKernel decode = cache_kernel(fast != 0);
    decode<<<grid, kThreads, 0, s>>>(
        c, d, md, tr, ax, pl, is, op, sg, shc, fc, gc,
        static_cast<const __nv_bfloat162*>(cache),
        static_cast<const int*>(last), gr, rays, k);
  } else {
    const SumsKernel sums = sums_kernel(kReplay, fast != 0);
    sums<<<grid, kThreads, 0, s>>>(c, d, md, tr, ax, pl, is, op, sg, shc, fc,
                                   gc, nullptr, gr, rays, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM (out[0]) and threads per block (out[1]) of device
// kernel `which` at k candidates per tile: 0 the tile-order kernel, 1 the
// exact walk, 2 the exact sums, 3 the cache decode with fast sums, 4 the
// exact sums fast, 5 tile order fast, 6 the cache decode at 3xTF32.
// Returns the first CUDA error.
extern "C" int tracer_backward_occupancy(int which, int k, int* out) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  out[1] = kThreads;
  if (which == 1) {
    const int smem = walk_smem(k);
    err = cudaFuncSetAttribute(tracer_backward_exact_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tracer_backward_exact_kernel, kWalkRays, smem);
    }
    out[1] = kWalkRays;
  } else if (which == 3 || which == 6) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, cache_kernel(which == 3), kThreads, 0);
  } else if (which >= 0 && which < 7) {
    const int src[] = {kReplay, 0, kFromPairs, 0, kFromPairs, kReplay};
    const bool fast[] = {false, false, false, false, true, true};
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, sums_kernel(src[which], fast[which]), kThreads, 0);
  }
  out[0] = blocks;
  return static_cast<int>(err);
}

extern "C" const char* tracer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
