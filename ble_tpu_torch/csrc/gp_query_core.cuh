// The GP query engine of csrc/gp_query.cu (B5, the column query) and
// csrc/gp_window.cu (B2, the query phase after each observe): the
// posterior of one env at a contiguous range of pressure levels that share
// the env's (x, y, t). For each level l of the range
//
//   k*[l, a] = s_f^2 exp(-|q_l - loc_a| / ls) act_a,
//   means[l] = sum_a k*[l, a] alpha[a, :],
//   var[l]   = s_f^2 - sum_j k*[l, j] sum_a k*[l, a] kinv[a, j],
//   dev[l]   = clip(var / s_f^2, 0, 1),
//
// both times any_valid. This is the TPU column query's order, v = k* kinv
// (ble_tpu/ops/pallas_gp.py:65). The TPU window kernel forms kinv k*
// instead (ble_tpu/ops/pallas_gp_window.py:249-256), and B2's plain version
// follows it; both are the quadratic form k*^T kinv k*, equal in exact
// arithmetic for any kinv, symmetric or not, so one engine serves both.
//
// Bound: per level, 2 x 128 x 128 multiply-adds of the product against 12
// bytes of output; at B2's and B5's batches compute-bound on the float32
// CUDA cores (67 TFLOP/s). Full float32: the variance cancels operands of
// ~13 down to s_n^2 = 0.05, which TF32 or bf16 would swamp. On the H100
// the product is held back by its shared-memory loads more than by the
// FMA pipes: its loop alone runs at ~43 TFLOP/s with the three 16-byte
// loads a step of the 4 x 8 thread tile below, ~53 with one and ~55 with
// none, and an 8 x 8 tile (four loads for 64 FMAs, the sum over a split
// between the half-warps) reaches ~45 (csrc/bench/product_tile.cu,
// chip_smoke.py --phases tile). Every 16-byte load delivers a float4 to
// each lane, shared addresses or not.
//
// Design, against what held the first kernels back:
// - 16-byte shared loads on both operands. kinv is resident with rows of
//   132 floats (gp_core.cuh) and k* is kept slot-major, 64 levels a chunk,
//   with rows of 68 floats. In a chunk of more than 16 levels a warp owns
//   16 levels x 64 slots and a thread 4 levels x 8 slots: each step over a
//   reads one float4 of k* (4 levels) and two float4 of kinv (slots
//   jb..jb+3 and jb+32..jb+35) for 32 FMAs. The warp's k* read touches 4
//   distinct chunks (broadcast) and each kinv read 8 consecutive ones, free
//   of bank conflicts: 3 loads and 12 floats a lane for 32 FMAs, against 12
//   scalar loads in the first kernels. The variance is taken from the whole
//   product of each level and slot: one summed from partial products over
//   halves of a adds partial quadratic forms that cancel, which multiplies
//   its rounding error.
// - kinv arrives by cp.async (stage_kinv) while the k* chunk and the
//   distances are built; the engine waits for it only before its first
//   product.
// - No idle-half-block side loops. The means are folded into the k* build:
//   the thread that builds k*[l, a] for a group of slots adds
//   k*[l, a] alpha[a, :] into two registers as it goes, 2 FMAs next to the
//   exp and sqrt it pays anyway. The build spreads the chunk's L = 16, 32
//   or 64 levels over all 256 threads (L / 2 slots each, unrolled). The
//   variance is reduced over a warp's slots with shuffles, then over the
//   slot ranges through shared memory, in the phase that overlaps the next
//   chunk's build.
// - A warp whose 16 levels all lie past the range's end skips the product:
//   the ragged last chunk costs what it holds, to 16 levels. A chunk of at
//   most 16 levels (B5's slices at small batch) takes a thin tile instead,
//   so that all 8 warps work on it: warp w owns slots 16w..16w+15, a thread
//   4 levels x 2 slots.
// The level range is the caller's: B5 splits an env's levels over several
// CTAs when the batch is too small to fill the card.

#pragma once

#include "gp_core.cuh"

namespace ble_gp {

constexpr int kChunk = 64;           // levels a chunk
constexpr int kWarpLevels = 16;      // levels a warp owns in a chunk
constexpr int kKsStride = kChunk + 4;  // k* rows: slot-major, 68 floats
// Floats of the engine's two buffers: the k* chunk (kCap x kKsStride) and
// the reductions, double-buffered by chunk parity: the means partials
// [2][256 threads][2] and the variance partials [2][128].
constexpr int kKstarFloats = kCap * kKsStride;
constexpr int kRedFloats = 2 * kThreads * 2 + 2 * 2 * kChunk;

// Levels of each CTA when one env's `n_levels` levels are split into
// `n_slices` contiguous slices: ceil(n_levels / n_slices) rounded up to a
// whole warp's levels. ops/gp_query.py:slice_levels is the same function.
__host__ __device__ __forceinline__ int slice_levels(int n_levels,
                                                     int n_slices) {
  const int per = (n_levels + n_slices - 1) / n_slices;
  return (per + kWarpLevels - 1) / kWarpLevels * kWarpLevels;
}

// The posterior at levels [l_begin, l_end) of one env, written as
// lvl[l * 3 + {0, 1, 2}] = [mean_u, mean_v, deviation].
//   kinv: shared, kCap rows of kKinvStride floats, possibly still in flight
//     from stage_kinv (the engine waits before reading it);
//   slot (CAP,) float4 and alpha (CAP, 2): shared and synchronised;
//     slot[a] = [pressure of slot a, the x/y/t part of its scaled squared
//     distance to the column plus 1e-12, active 0/1, unused];
//   pres: the pressure of level l at pres[l] (device or shared memory);
//   kstar, red: shared scratch of kKstarFloats and kRedFloats floats.
// Every thread of the block calls it; it ends synchronised, with its
// scratch free.
__device__ __forceinline__ void query_levels(
    const float* kinv, const float4* slot, const float* alpha,
    const float* __restrict__ pres,
    float* kstar, float* red, int l_begin, int l_end, float any_valid,
    float* __restrict__ lvl) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float sf2 = F(kSigmaF2);
  float* mred = red;                        // [2][kThreads][2]
  float* vred = red + 2 * kThreads * 2;     // [2][2 * kChunk]

  // Product, wide (a chunk of more than 16 levels): warp -> (level range
  // lr, slot half sh); lane -> (level group lg, slot group jg), slots
  // jb..jb+3 and jb+32..jb+35.
  const int lr = warp & 3, sh = warp >> 2;
  const int lg = lane & 3, jg = lane >> 2;
  const int lc = lr * kWarpLevels + 4 * lg;  // first of this thread's levels
  const int jb = sh * 64 + 4 * jg;

  // Means and deviations of the chunk at l0 with `cnt` levels, from the
  // partials of parity p; threads 0..cnt-1, one level each. A chunk of at
  // most 16 levels was built by 16 slot groups and its product split over
  // 8 slot ranges; a wider one by 256 / L slot groups and 2 slot halves.
  auto finish = [&](int l0, int cnt, int p, int lbits) {
    if (tid < cnt) {
      const int groups = kThreads >> lbits;
      const float2* m = reinterpret_cast<const float2*>(mred) +
                        p * kThreads + tid;
      float mu = 0.0f, mv = 0.0f;
      for (int g = 0; g < groups; ++g) {
        const float2 mg = m[g << lbits];
        mu += mg.x;
        mv += mg.y;
      }
      const float* v = vred + p * 2 * kChunk;
      float q = 0.0f;
      if (lbits == 4) {
        for (int w = 0; w < kThreads / 32; ++w) q += v[w * 16 + tid];
      } else {
        q = v[tid] + v[kChunk + tid];
      }
      const float var = sf2 - q;
      const float dev = fminf(fmaxf(var / sf2, 0.0f), 1.0f);
      float* o = lvl + (size_t)(l0 + tid) * 3;
      o[0] = mu * any_valid;
      o[1] = mv * any_valid;
      o[2] = dev * any_valid;
    }
  };

  int p = 0, prev_l0 = 0, prev_cnt = 0, prev_bits = 6;
  for (int l0 = l_begin; l0 < l_end; l0 += kChunk, p ^= 1) {
    const int cnt = min(kChunk, l_end - l0);
    // Build: thread -> (level bl of the chunk's first L = 16, 32 or 64
    // levels, the fewest that hold it; a group bq of L / 2 slots).
    const int lbits = cnt <= 16 ? 4 : cnt <= 32 ? 5 : 6;
    {
      const int bl = tid & ((1 << lbits) - 1), bq = tid >> lbits;
      const int n_a = 1 << (lbits - 1), a0 = bq * n_a;
      float m0 = 0.0f, m1 = 0.0f;
      float* kcol = kstar + bl;
      if (bl < cnt) {
        const float pr = pres[l0 + bl];
#pragma unroll 4
        for (int a = a0; a < a0 + n_a; ++a) {
          const float4 sl = slot[a];
          const float2 al = reinterpret_cast<const float2*>(alpha)[a];
          const float dp = (pr - sl.x) * F(1.0 / kLsP);
          const float d = sqrtf(sl.y + dp * dp);
          const float ks = (sf2 * expf(-d)) * sl.z;
          m0 += ks * al.x;
          m1 += ks * al.y;
          kcol[a * kKsStride] = ks;
        }
      } else {
        // Levels past the range are zero columns.
        for (int a = a0; a < a0 + n_a; ++a) kcol[a * kKsStride] = 0.0f;
      }
      reinterpret_cast<float2*>(mred)[p * kThreads + tid] =
          make_float2(m0, m1);
    }
    if (l0 > l_begin) finish(prev_l0, prev_cnt, p ^ 1, prev_bits);
    cp_async_wait_all();
    __syncthreads();

    if (lbits == 4) {
      // Thin chunk (at most 16 levels, B5's small-batch slices): every warp
      // takes 16 slots, 16 * warp + 2 * jg + {0, 1}, for all 16 levels.
      float acc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.0f;
      const int lt = 4 * lg, jt = 16 * warp + 2 * jg;
      const float* kp = kstar + lt;
      const float* vp = kinv + jt;
#pragma unroll 8
      for (int a = 0; a < kCap; ++a) {
        const float4 k4 = *reinterpret_cast<const float4*>(kp + a * kKsStride);
        const float2 v2 =
            *reinterpret_cast<const float2*>(vp + a * kKinvStride);
        const float ks[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(ks[i], v2.x, acc[i][0]);
          acc[i][1] = fmaf(ks[i], v2.y, acc[i][1]);
        }
      }
      float part[4];
      const float4 k0 =
          *reinterpret_cast<const float4*>(kstar + jt * kKsStride + lt);
      const float4 k1 =
          *reinterpret_cast<const float4*>(kstar + (jt + 1) * kKsStride + lt);
      part[0] = fmaf(k1.x, acc[0][1], k0.x * acc[0][0]);
      part[1] = fmaf(k1.y, acc[1][1], k0.y * acc[1][0]);
      part[2] = fmaf(k1.z, acc[2][1], k0.z * acc[2][0]);
      part[3] = fmaf(k1.w, acc[3][1], k0.w * acc[3][0]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
      if (jg == 0)
        *reinterpret_cast<float4*>(vred + p * 2 * kChunk + warp * 16 + lt) =
            make_float4(part[0], part[1], part[2], part[3]);
    } else if (lr * kWarpLevels < cnt) {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      const float* kp = kstar + lc;
      const float* vp = kinv + jb;
#pragma unroll 4
      for (int a = 0; a < kCap; ++a) {
        const float4 k4 = *reinterpret_cast<const float4*>(kp + a * kKsStride);
        const float4 v0 =
            *reinterpret_cast<const float4*>(vp + a * kKinvStride);
        const float4 v1 =
            *reinterpret_cast<const float4*>(vp + a * kKinvStride + 32);
        const float ks[4] = {k4.x, k4.y, k4.z, k4.w};
        const float kv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ks[i], kv[j], acc[i][j]);
      }
      // k*[l, j] v[l, j] over this thread's 8 slots, then over the warp's
      // 8 slot groups (lanes lg + 4 jg) by shuffles.
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int slot = jb + (j < 4 ? j : 28 + j);
        const float4 k4 =
            *reinterpret_cast<const float4*>(kstar + slot * kKsStride + lc);
        part[0] = fmaf(k4.x, acc[0][j], part[0]);
        part[1] = fmaf(k4.y, acc[1][j], part[1]);
        part[2] = fmaf(k4.z, acc[2][j], part[2]);
        part[3] = fmaf(k4.w, acc[3][j], part[3]);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
      if (jg == 0)
        *reinterpret_cast<float4*>(vred + p * 2 * kChunk + sh * kChunk + lc) =
            make_float4(part[0], part[1], part[2], part[3]);
    }
    __syncthreads();
    prev_l0 = l0;
    prev_cnt = cnt;
    prev_bits = lbits;
  }
  if (prev_cnt > 0) finish(prev_l0, prev_cnt, p ^ 1, prev_bits);
  cp_async_wait_all();
  __syncthreads();
}

}  // namespace ble_gp
