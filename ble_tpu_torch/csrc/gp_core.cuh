// What the three GP kernels share: the GP's constants, the padded layout
// of kinv in shared memory and its asynchronous staging, and for
// csrc/gp_window.cu (B2, observe + query per step) and csrc/gp_observe.cu
// (B3/B4, observe only) the load and store of one env's state to and from
// shared memory and the observe on it: observe_step on one CTA, built from
// plan_insert, gram_pivots, w_row and insert_slot, of which B3's cluster
// observe (csrc/gp_observe.cu) shares all but gram_pivots.
// csrc/gp_query_core.cuh, the query engine of B2 and B5, builds on it.
//
// The observe is the TPU kernels' _observe_core + _finish
// (ble_tpu/ops/pallas_gp_window.py, ble_tpu/ops/pallas_gp_observe.py): two
// stale expiries by first index, ring eviction, bordered insert with the
// clamped Gram-chain pivots read off the 4x4 S = U^T kinv U
// (d_min = 1/(s_f^2 + s_n^2), schur >= s_n^2), the 8 rank-1 terms applied as
// kinv += (W c) W^T, then alpha = kinv' (errors * active). With `enabled`
// false the state is left exactly as it was.
//
// Every function here expects a block of kThreads = 256 threads, each of
// which calls it.

#pragma once

#include <cuda_runtime.h>

#define F(x) ((float)(x))

namespace ble_gp {

constexpr int kCap = 128;
constexpr int kThreads = 256;
// Rows of kinv padded to 132 floats, 33 16-byte chunks: every read of kinv
// is a 16-byte load along a row. A warp reading the same 4 columns of 32
// consecutive rows touches 8 distinct chunks mod 8 in each quarter-warp
// (33 is odd), and a warp reading 8 consecutive chunks of one row takes one
// wavefront: both free of bank conflicts. Scalar walks down a column are
// not (4-way), and nothing here makes them.
constexpr int kKinvStride = kCap + 4;

constexpr double kSigmaF2 = 3.6 * 3.6;
constexpr double kSigmaN2 = 0.05;
constexpr double kTimeHorizonS = 6.0 * 3600.0;
constexpr double kLsX = 357000.0, kLsY = 357000.0, kLsP = 326.0,
                 kLsT = 34560.0;

// Scratch the observe needs, in floats: U (CAP, 4) | M (CAP, 4) | W (CAP, 8)
// | W c (CAP, 8).
constexpr int kObserveScratchFloats = kCap * 24;
// Small area: S (16) | c (8) | coefficients a[q][j] (16) | stale words (4).
constexpr int kSmallFloats = 64;
constexpr int kSmallS = 0, kSmallC = 16, kSmallA = 24, kSmallWords = 40;

// 16-byte asynchronous copy from device to shared memory (cp.async, no
// register round trip), and the waits that complete it. A thread's copies
// are visible to the block after it waits and the block synchronises.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of one env's 128x128 inverse (`src`, dense rows) into
// `kinv` (padded rows): 16 cp.async of 16 bytes a thread, one group. The
// caller runs cp_async_wait_all() and synchronises before reading kinv.
__device__ __forceinline__ void stage_kinv(float* kinv,
                                           const float* __restrict__ src) {
  for (int i = threadIdx.x; i < kCap * kCap / 4; i += kThreads) {
    const int r = i / (kCap / 4), c = (i % (kCap / 4)) * 4;
    cp_async16(kinv + r * kKinvStride + c, src + i * 4);
  }
  cp_async_commit();
}

// The state in shared memory; kinv has kCap rows of kKinvStride floats.
struct State {
  float* kinv;
  float* loc;    // (CAP, 4)
  float* err;    // (CAP, 2)
  float* act;    // (CAP,) 0/1
  float* alpha;  // (CAP, 2)
};

// Env e's state from device memory into shared memory: kinv by cp.async,
// still in flight on return (observe_step waits for it just before its
// first read of kinv, so the stale-slot search and U overlap the copy),
// the small tables by plain loads. The caller synchronises before using
// them.
__device__ __forceinline__ void load_state(
    const State& s, int e, const float* __restrict__ loc_in,
    const float* __restrict__ err_in, const float* __restrict__ act_in,
    const float* __restrict__ kinv_in, const float* __restrict__ alpha_in) {
  const int tid = threadIdx.x;
  stage_kinv(s.kinv, kinv_in + (size_t)e * kCap * kCap);
  for (int i = tid; i < kCap * 4; i += kThreads)
    s.loc[i] = loc_in[(size_t)e * kCap * 4 + i];
  for (int i = tid; i < kCap * 2; i += kThreads) {
    s.err[i] = err_in[(size_t)e * kCap * 2 + i];
    s.alpha[i] = alpha_in[(size_t)e * kCap * 2 + i];
  }
  if (tid < kCap) s.act[tid] = act_in[(size_t)e * kCap + tid];
}

// Env e's state from shared memory back to device memory. The caller
// synchronises before it.
__device__ __forceinline__ void store_state(
    const State& s, int e, int count, float* __restrict__ loc_out,
    float* __restrict__ err_out, float* __restrict__ act_out,
    float* __restrict__ kinv_out, float* __restrict__ alpha_out,
    int* __restrict__ cnt_out) {
  const int tid = threadIdx.x;
  float4* dst = reinterpret_cast<float4*>(kinv_out + (size_t)e * kCap * kCap);
  for (int i = tid; i < kCap * kCap / 4; i += kThreads) {
    const int r = i / (kCap / 4), c = (i % (kCap / 4)) * 4;
    dst[i] = *reinterpret_cast<const float4*>(s.kinv + r * kKinvStride + c);
  }
  for (int i = tid; i < kCap * 4; i += kThreads)
    loc_out[(size_t)e * kCap * 4 + i] = s.loc[i];
  for (int i = tid; i < kCap * 2; i += kThreads) {
    err_out[(size_t)e * kCap * 2 + i] = s.err[i];
    alpha_out[(size_t)e * kCap * 2 + i] = s.alpha[i];
  }
  if (tid < kCap) act_out[(size_t)e * kCap + tid] = s.act[tid];
  if (tid == 0) cnt_out[e] = count;
}

// What the observe removes and inserts: the first two stale slots (kCap
// where there is none), the ring slot, whether the ring slot is evicted,
// and this thread's slot's active flag after the insert (threads < kCap).
struct Plan {
  int first1, first2, slot;
  bool slot_active;
  float act_final_i;
};

// The observe's first phase, the same for every slicing of kinv's rows:
// the stale-slot ballot over the whole state (act, loc), the slots the
// observation removes and inserts, and the update basis U = [e1 e2 eo v]
// (CAP, 4) into `u_mat` by threads < kCap. Holds one block barrier; the
// caller synchronises before reading u_mat.
__device__ __forceinline__ Plan plan_insert(const float* act, const float* loc,
                                            float* small, float* u_mat,
                                            int count, float x, float y,
                                            float p, float t) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Stale slots: active and older than the 6-hour window.
  if (warp < kCap / 32) {
    int i = tid;
    bool stale = act[i] > 0.5f && (t - loc[i * 4 + 3]) >= F(kTimeHorizonS);
    unsigned word = __ballot_sync(0xffffffffu, stale);
    if (lane == 0) reinterpret_cast<unsigned*>(small)[kSmallWords + warp] =
        word;
  }
  __syncthreads();
  Plan pl;
  pl.first1 = kCap;
  pl.first2 = kCap;
  {
    const unsigned* words =
        reinterpret_cast<const unsigned*>(small) + kSmallWords;
    for (int w = 0; w < kCap / 32; ++w) {
      unsigned word = words[w];
      while (word && pl.first2 == kCap) {
        int bit = __ffs(word) - 1;
        word &= word - 1;
        if (pl.first1 == kCap) pl.first1 = w * 32 + bit;
        else pl.first2 = w * 32 + bit;
      }
    }
  }
  pl.slot = count % kCap;
  // The ring slot is evicted when it is still active after the expiries.
  pl.slot_active =
      act[pl.slot] > 0.5f && pl.slot != pl.first1 && pl.slot != pl.first2;

  pl.act_final_i = 0.0f;
  if (tid < kCap) {
    const int i = tid;
    float e1 = i == pl.first1 ? 1.0f : 0.0f;
    float e2 = i == pl.first2 ? 1.0f : 0.0f;
    float slot_e = i == pl.slot ? 1.0f : 0.0f;
    float eo = (pl.slot_active && i == pl.slot) ? 1.0f : 0.0f;
    float act_after_rm = (e1 > 0.5f || e2 > 0.5f) ? 0.0f : act[i];
    float act_pre = eo > 0.5f ? 0.0f : act_after_rm;
    pl.act_final_i = fmaxf(act_pre, slot_e);
    float dx = (x - loc[i * 4 + 0]) / F(kLsX);
    float dy = (y - loc[i * 4 + 1]) / F(kLsY);
    float dp = (p - loc[i * 4 + 2]) / F(kLsP);
    float dt = (t - loc[i * 4 + 3]) / F(kLsT);
    float d = sqrtf(dx * dx + dy * dy + dp * dp + dt * dt + F(1e-12));
    float v = (F(kSigmaF2) * expf(-d)) * act_pre;
    u_mat[i * 4 + 0] = e1;
    u_mat[i * 4 + 1] = e2;
    u_mat[i * 4 + 2] = eo;
    u_mat[i * 4 + 3] = v;
  }
  return pl;
}

// Gram-chain pivots (pallas_gp_window._observe_core) from the 4x4
// S = U^T kinv U in small[kSmallS..]: the coefficients c (8) and
// a[q * 4 + j] = tc[q][j] / safe[q] into `small`. One thread runs it.
__device__ __forceinline__ void gram_pivots(const Plan& pl, float* small) {
  const bool removing[3] = {pl.first1 < kCap, pl.first2 < kCap,
                            pl.slot_active};
  const float* sm = small + kSmallS;
  const float d0 = F(kSigmaF2 + kSigmaN2);
  const float d_min = F(1.0 / (kSigmaF2 + kSigmaN2));
  float tc[4][4];
  float safe[3];
  for (int j = 0; j < 3; ++j) {
    float dj = sm[j * 4 + j];
    for (int q = 0; q < j; ++q) {
      float acc = 0.0f;
      for (int r = 0; r < q; ++r) acc = acc + (tc[r][q] / safe[r]) * tc[r][j];
      tc[q][j] = sm[j * 4 + q] - acc;
      dj = dj - tc[q][j] * tc[q][j] / safe[q];
    }
    safe[j] = fabsf(dj) > d_min ? dj : (removing[j] ? d_min : 1.0f);
  }
  for (int q = 0; q < 3; ++q) {
    float acc = 0.0f;
    for (int r = 0; r < q; ++r) acc = acc + (tc[r][q] / safe[r]) * tc[r][3];
    tc[q][3] = sm[3 * 4 + q] - acc;
  }
  float dv_acc = 0.0f;
  for (int q = 0; q < 3; ++q) dv_acc = dv_acc + tc[q][3] * tc[q][3] / safe[q];
  const float d_v = sm[3 * 4 + 3] - dv_acc;
  const float schur = fmaxf(d0 - d_v, F(kSigmaN2));
  float* c = small + kSmallC;
  c[0] = -1.0f / safe[0];
  c[1] = -1.0f / safe[1];
  c[2] = -1.0f / safe[2];
  c[3] = 1.0f;
  c[4] = 1.0f;
  c[5] = 1.0f;
  c[6] = 1.0f / schur;
  c[7] = -1.0f;
  float* a = small + kSmallA;  // a[q * 4 + j] = tc[q][j] / safe[q].
  for (int j = 1; j < 4; ++j)
    for (int q = 0; q < j; ++q) a[q * 4 + j] = tc[q][j] / safe[q];
}

// Row i of the update vectors in real space, W = [w0 w1 w2 e1 e2 eo yv
// slot_e], from row i of M = kinv U and of U: into `wr` (8 floats) and,
// scaled by c, into `wc` (8 floats, 16-byte aligned).
__device__ __forceinline__ void w_row(int i, int slot, const float* m_row,
                                      const float* u_row, const float* small,
                                      float* wr, float* wc) {
  const float* a = small + kSmallA;
  float w[4];
  for (int j = 0; j < 4; ++j) {
    float wj = m_row[j];
    for (int q = 0; q < j; ++q) wj = wj - a[q * 4 + j] * w[q];
    w[j] = wj;
  }
  float slot_e = i == slot ? 1.0f : 0.0f;
  wr[0] = w[0];
  wr[1] = w[1];
  wr[2] = w[2];
  wr[3] = u_row[0];
  wr[4] = u_row[1];
  wr[5] = u_row[2];
  wr[6] = w[3] - slot_e;
  wr[7] = slot_e;
  const float* c = small + kSmallC;
  float4* wc4 = reinterpret_cast<float4*>(wc);
  wc4[0] = make_float4(wr[0] * c[0], wr[1] * c[1], wr[2] * c[2],
                       wr[3] * c[3]);
  wc4[1] = make_float4(wr[4] * c[4], wr[5] * c[5], wr[6] * c[6],
                       wr[7] * c[7]);
}

// The slot bookkeeping of an enabled observe: every slot's active flag,
// and the observation's location and error into the ring slot.
__device__ __forceinline__ void insert_slot(const Plan& pl, float* act,
                                            float* loc, float* err, float x,
                                            float y, float p, float t,
                                            float eu, float ev) {
  const int tid = threadIdx.x;
  if (tid < kCap) act[tid] = pl.act_final_i;
  if (tid < 4) loc[pl.slot * 4 + tid] = tid == 0 ? x : tid == 1 ? y
                                      : tid == 2 ? p : t;
  if (tid == 4) err[pl.slot * 2 + 0] = eu;
  if (tid == 5) err[pl.slot * 2 + 1] = ev;
}

// One observation [x, y, p, t, eu, ev] into the state; `count` is the
// number of observations ever written and advances when `enabled`.
// `scratch` holds kObserveScratchFloats and `small` kSmallFloats floats.
// Starts with the state synchronised but kinv possibly still in flight
// from load_state; ends with alpha written but not synchronised, so the
// caller synchronises before reading alpha.
__device__ __forceinline__ void observe_step(
    const State& s, float* scratch, float* small, int& count, float x,
    float y, float p, float t, float eu, float ev, bool enabled) {
  float* kinv = s.kinv;
  float* loc = s.loc;
  float* err = s.err;
  float* act = s.act;
  float* alpha = s.alpha;
  float* u_mat = scratch;               // (CAP, 4)
  float* m_mat = scratch + kCap * 4;    // (CAP, 4)
  float* w_mat = scratch + kCap * 8;    // (CAP, 8)
  float* wc_mat = scratch + kCap * 16;  // (CAP, 8): W scaled by c
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const Plan pl = plan_insert(act, loc, small, u_mat, count, x, y, p, t);
  const int slot = pl.slot;
  cp_async_wait_all();
  __syncthreads();

  // M = kinv U: thread -> (row tid % CAP, columns 2 * (tid / CAP) + {0, 1}),
  // the row walked 16 bytes at a time.
  {
    const int i = tid % kCap, j0 = 2 * (tid / kCap);
    const float4* row = reinterpret_cast<const float4*>(kinv + i * kKinvStride);
    float m0 = 0.0f, m1 = 0.0f;
    for (int k4 = 0; k4 < kCap / 4; ++k4) {
      const float4 a = row[k4];
      const float* u = u_mat + k4 * 16 + j0;
      m0 += a.x * u[0];
      m1 += a.x * u[1];
      m0 += a.y * u[4];
      m1 += a.y * u[5];
      m0 += a.z * u[8];
      m1 += a.z * u[9];
      m0 += a.w * u[12];
      m1 += a.w * u[13];
    }
    m_mat[i * 4 + j0] = m0;
    m_mat[i * 4 + j0 + 1] = m1;
  }
  __syncthreads();

  // S = U^T M: warp w computes entries 2w and 2w + 1 of the 4x4.
  for (int q = 0; q < 2; ++q) {
    const int idx = 2 * warp + q, a = idx / 4, b = idx % 4;
    float acc = 0.0f;
    for (int i = lane; i < kCap; i += 32)
      acc += u_mat[i * 4 + a] * m_mat[i * 4 + b];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) small[kSmallS + idx] = acc;
  }
  __syncthreads();

  if (tid == 0) gram_pivots(pl, small);
  __syncthreads();

  if (tid < kCap)
    w_row(tid, slot, m_mat + tid * 4, u_mat + tid * 4, small,
          w_mat + tid * 8, wc_mat + tid * 8);
  __syncthreads();

  if (enabled) {
    // Rank-8 update kinv += (W c) W^T: column j = tid % CAP, rows of one
    // parity, W[j, :] kept in registers, row i of W c read as two 16-byte
    // broadcasts.
    const int j = tid % kCap;
    float wj[8];
    for (int r = 0; r < 8; ++r) wj[r] = w_mat[j * 8 + r];
    for (int i = tid / kCap; i < kCap; i += kThreads / kCap) {
      const float4 a = reinterpret_cast<const float4*>(wc_mat + i * 8)[0];
      const float4 b = reinterpret_cast<const float4*>(wc_mat + i * 8)[1];
      float acc = a.x * wj[0];
      acc += a.y * wj[1];
      acc += a.z * wj[2];
      acc += a.w * wj[3];
      acc += b.x * wj[4];
      acc += b.y * wj[5];
      acc += b.z * wj[6];
      acc += b.w * wj[7];
      kinv[i * kKinvStride + j] += acc;
    }
    insert_slot(pl, act, loc, err, x, y, p, t, eu, ev);
    ++count;
  }
  __syncthreads();

  if (enabled) {
    // alpha = kinv' (errors * active): thread -> (row tid % CAP, comp),
    // the row walked 16 bytes at a time.
    const int i = tid % kCap, comp = tid / kCap;
    const float4* row = reinterpret_cast<const float4*>(kinv + i * kKinvStride);
    float acc = 0.0f;
    for (int k4 = 0; k4 < kCap / 4; ++k4) {
      const float4 a = row[k4];
      const int kk = k4 * 4;
      acc += a.x * (err[kk * 2 + comp] * act[kk]);
      acc += a.y * (err[kk * 2 + 2 + comp] * act[kk + 1]);
      acc += a.z * (err[kk * 2 + 4 + comp] * act[kk + 2]);
      acc += a.w * (err[kk * 2 + 6 + comp] * act[kk + 3]);
    }
    alpha[i * 2 + comp] = acc;
  }
}

}  // namespace ble_gp
