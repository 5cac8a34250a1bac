// GP observe (the bordered-inverse update) for Hopper (sm_90a), one launch
// for any number of envs.
//
// Replaces the TPU kernels ble_tpu/ops/pallas_gp_observe.py:observe (B3,
// one env: _kernel, _env_body, _finish) and :observe_batched (B4, _kernel_
// blocked, 8 envs a grid program). For each env: two stale expiries by first
// index, ring eviction, the bordered insert with the clamped Gram-chain
// pivots, kinv' = kinv + (W c) W^T, alpha = kinv' (errors * active); an env
// whose `enabled` flag is 0 gets its inputs back exactly (count too).
//
// Two designs, chosen by the wrapper from the batch and the card's SM count
// (ops/gp_observe.py:observe_split) and passed in as `split`:
//
// - split = 1, when the envs alone give every SM a CTA (B4 at 4096): one
//   CTA of 256 threads per env (the TPU's 8-env blocking amortised
//   per-program DMA setup, which a CTA does not pay). The env's 128x128
//   float32 inverse is staged once by cp.async into dynamic shared memory,
//   in rows padded to 132 floats (the stale-slot search and U overlap the
//   copy), updated there by gp_core.cuh:observe_step (the same code as B2's
//   observe phase, walking kinv's rows 16 bytes at a time), and written
//   back once.
// - split = S in {2, 4, 8} at small batch (B3 at E = 1): one env's observe
//   over a thread-block cluster of S CTAs on S SMs
//   (gp_observe_cluster_kernel below).
//   CTA rank r owns rows [r R, r R + R) of kinv, R = 128 / S, and stages
//   only those (8 KiB at S = 8), with the rest of its inputs, in one
//   cp.async group, so the 64 KiB read and write spread over S SMs and
//   every barrier waits on R rows' work. M = kinv U and alpha are
//   row-local: M's three indicator columns are columns of kinv, read as
//   they are, and kinv v and alpha are split over 2S threads a row and
//   joined by shuffles. The 4x4 S = U^T M is summed from the CTAs'
//   partials in rank order through distributed shared memory, so every
//   CTA holds the same S and computes the same pivots itself, their
//   divisions spread over a warp's lanes. The rank-8 update of a row needs
//   W at every column: each CTA builds W on its own rows and, after a
//   second cluster barrier, gathers the other ranks' rows (4 KiB in all).
//   Rank 0 alone writes the slot tables and the count.
//
// All arithmetic is float32 on the CUDA cores.
//
// Bound, per env: ~137 KiB of traffic (kinv in and out, plus the small
// tables) against ~0.47 MFLOP, so at E = 4096 it is memory-bound
// (~575 MB, 0.17 ms at 3.35 TB/s; 1.9 GFLOP, 0.03 ms at 67 TFLOP/s). At
// E = 1 it is bound by launch latency and the chain of barriers, which the
// cluster shortens.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gp_core.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace ble_gp;

// Shared memory layout of the one-CTA-per-env kernel, in floats.
constexpr int kOffKinv = 0;
constexpr int kOffLoc = kOffKinv + kCap * kKinvStride;
constexpr int kOffErr = kOffLoc + kCap * 4;
constexpr int kOffAct = kOffErr + kCap * 2;
constexpr int kOffAlpha = kOffAct + kCap;
constexpr int kOffScratch = kOffAlpha + kCap * 2;
constexpr int kOffSmall = kOffScratch + kObserveScratchFloats;
constexpr int kSmemFloats = kOffSmall + kSmallFloats;
constexpr int kSmemBytes = kSmemFloats * 4;

__global__ void __launch_bounds__(kThreads, 2)
gp_observe_kernel(const float* __restrict__ obs,
                  const float* __restrict__ loc_in,
                  const float* __restrict__ err_in,
                  const float* __restrict__ act_in,
                  const float* __restrict__ kinv_in,
                  const float* __restrict__ alpha_in,
                  const int* __restrict__ cnt_in, float* __restrict__ loc_out,
                  float* __restrict__ err_out, float* __restrict__ act_out,
                  float* __restrict__ kinv_out, float* __restrict__ alpha_out,
                  int* __restrict__ cnt_out) {
  extern __shared__ __align__(16) float smem[];
  const State s{smem + kOffKinv, smem + kOffLoc, smem + kOffErr,
                smem + kOffAct, smem + kOffAlpha};
  const int e = blockIdx.x;
  const float* ob = obs + (size_t)e * 8;
  int count = cnt_in[e];

  load_state(s, e, loc_in, err_in, act_in, kinv_in, alpha_in);
  __syncthreads();
  observe_step(s, smem + kOffScratch, smem + kOffSmall, count, ob[0], ob[1],
               ob[2], ob[3], ob[4], ob[5], ob[6] > 0.5f);
  __syncthreads();
  store_state(s, e, count, loc_out, err_out, act_out, kinv_out, alpha_out,
              cnt_out);
}

// The sliced observe's shared memory layout, in floats (every offset a
// multiple of 4): this CTA's R rows of kinv, the slot tables whole, its R
// rows of alpha, U whole and its last column v alone, its rows of M, W
// whole (its own rows built here,
// the others gathered), its rows of W c, its part of S, the observation
// row, the small area.
template <int S>
struct Sliced {
  static constexpr int kRows = kCap / S;
  // Threads a row in the row walks of M and alpha.
  static constexpr int kParts = kThreads / kRows;
  static constexpr int kOffKinv = 0;
  static constexpr int kOffLoc = kOffKinv + kRows * kKinvStride;
  static constexpr int kOffErr = kOffLoc + kCap * 4;
  static constexpr int kOffAct = kOffErr + kCap * 2;
  static constexpr int kOffAlpha = kOffAct + kCap;
  static constexpr int kOffU = kOffAlpha + kRows * 2;
  static constexpr int kOffV = kOffU + kCap * 4;
  static constexpr int kOffM = kOffV + kCap;
  static constexpr int kOffW = kOffM + kRows * 4;
  static constexpr int kOffWc = kOffW + kCap * 8;
  static constexpr int kOffPart = kOffWc + kRows * 8;
  static constexpr int kOffObs = kOffPart + 16;
  static constexpr int kOffSmall = kOffObs + 8;
  static constexpr int kBytes = (kOffSmall + kSmallFloats) * 4;
  static_assert(kCap % S == 0 && kParts <= 32 && (kParts & (kParts - 1)) == 0,
                "a row's threads must be a power of two within a warp");
};

// The arrive and the wait of a cluster barrier, apart: a CTA arrives when it
// has done its last read of another CTA's shared memory and waits just
// before it exits, so that none exits while another still reads it. The
// arrive orders no memory (relaxed): the reads it follows have returned,
// since their values were stored before it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The quotient num[lane] / den on lanes [0, n), n <= 8; 0 on the others.
__device__ __forceinline__ float lane_quotient(int lane, int n,
                                               const float* num, float den) {
  float q = 0.0f;
  if (lane < n) {
    float x = num[0];
#pragma unroll
    for (int k = 1; k < 8; ++k)
      if (k < n && lane == k) x = num[k];
    q = x / den;
  }
  return q;
}

// gp_core.cuh:gram_pivots on the 32 lanes of warp 0, every lane calling it:
// the same arithmetic, but the divisions by one pivot run on separate
// lanes, one level of the chain at a time (safe0, safe1, safe2, then the
// Schur complement), and are broadcast by shuffles. On one thread each
// IEEE division's slow-path branch keeps the next from starting.
__device__ __forceinline__ void gram_pivots_warp(const Plan& pl,
                                                 float* small) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const float* sm = small + kSmallS;
  const float d_min = F(1.0 / (kSigmaF2 + kSigmaN2));
  auto pick = [&](float dj, bool removing) {
    return fabsf(dj) > d_min ? dj : (removing ? d_min : 1.0f);
  };
  const float safe0 = pick(sm[0], pl.first1 < kCap);
  const float tc01 = sm[1 * 4 + 0] - 0.0f;
  const float tc02 = sm[2 * 4 + 0] - 0.0f;
  const float tc03 = sm[3 * 4 + 0] - 0.0f;
  // Level 0: every division by safe0.
  const float n0[7] = {tc01 * tc01, tc02 * tc02, tc01, tc02, tc03,
                       tc03 * tc03, -1.0f};
  const float v0 = lane_quotient(lane, 7, n0, safe0);
  const float q01 = __shfl_sync(full, v0, 0), q02 = __shfl_sync(full, v0, 1);
  const float a01 = __shfl_sync(full, v0, 2), a02 = __shfl_sync(full, v0, 3);
  const float a03 = __shfl_sync(full, v0, 4), q03 = __shfl_sync(full, v0, 5);
  const float c0 = __shfl_sync(full, v0, 6);
  const float safe1 = pick(sm[1 * 4 + 1] - q01, pl.first2 < kCap);
  const float tc12 = sm[2 * 4 + 1] - (0.0f + a01 * tc02);
  const float tc13 = sm[3 * 4 + 1] - (0.0f + a01 * tc03);
  // Level 1: every division by safe1.
  const float n1[5] = {tc12 * tc12, tc12, tc13, tc13 * tc13, -1.0f};
  const float v1 = lane_quotient(lane, 5, n1, safe1);
  const float q12 = __shfl_sync(full, v1, 0), a12 = __shfl_sync(full, v1, 1);
  const float a13 = __shfl_sync(full, v1, 2), q13 = __shfl_sync(full, v1, 3);
  const float c1 = __shfl_sync(full, v1, 4);
  const float safe2 = pick((sm[2 * 4 + 2] - q02) - q12, pl.slot_active);
  const float tc23 = sm[3 * 4 + 2] - ((0.0f + a02 * tc03) + a12 * tc13);
  // Level 2: every division by safe2.
  const float n2[3] = {tc23 * tc23, tc23, -1.0f};
  const float v2 = lane_quotient(lane, 3, n2, safe2);
  const float q23 = __shfl_sync(full, v2, 0), a23 = __shfl_sync(full, v2, 1);
  const float c2 = __shfl_sync(full, v2, 2);
  const float d_v = sm[3 * 4 + 3] - (((0.0f + q03) + q13) + q23);
  const float schur = fmaxf(F(kSigmaF2 + kSigmaN2) - d_v, F(kSigmaN2));
  if (lane == 0) {
    float* c = small + kSmallC;
    c[0] = c0;
    c[1] = c1;
    c[2] = c2;
    c[3] = 1.0f;
    c[4] = 1.0f;
    c[5] = 1.0f;
    c[6] = 1.0f / schur;
    c[7] = -1.0f;
    float* a = small + kSmallA;
    a[0 * 4 + 1] = a01;
    a[0 * 4 + 2] = a02;
    a[1 * 4 + 2] = a12;
    a[0 * 4 + 3] = a03;
    a[1 * 4 + 3] = a13;
    a[2 * 4 + 3] = a23;
  }
}

// Env blockIdx.x / S's observe on cluster rank r: rows [r R, r R + R).
template <int S>
__global__ void __launch_bounds__(kThreads)
gp_observe_cluster_kernel(const float* __restrict__ obs,
                          const float* __restrict__ loc_in,
                          const float* __restrict__ err_in,
                          const float* __restrict__ act_in,
                          const float* __restrict__ kinv_in,
                          const float* __restrict__ alpha_in,
                          const int* __restrict__ cnt_in,
                          float* __restrict__ loc_out,
                          float* __restrict__ err_out,
                          float* __restrict__ act_out,
                          float* __restrict__ kinv_out,
                          float* __restrict__ alpha_out,
                          int* __restrict__ cnt_out) {
  using L = Sliced<S>;
  constexpr int R = L::kRows, P = L::kParts;
  extern __shared__ __align__(16) float smem[];
  float* kinv = smem + L::kOffKinv;
  float* loc = smem + L::kOffLoc;
  float* err = smem + L::kOffErr;
  float* act = smem + L::kOffAct;
  float* alpha = smem + L::kOffAlpha;
  float* u_mat = smem + L::kOffU;
  float* v_col = smem + L::kOffV;
  float* m_mat = smem + L::kOffM;
  float* w_all = smem + L::kOffW;
  float* wc_mat = smem + L::kOffWc;
  float* part = smem + L::kOffPart;
  float* ob = smem + L::kOffObs;
  float* small = smem + L::kOffSmall;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int e = blockIdx.x / S;
  const int r0 = rank * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int count = cnt_in[e];

  // Every input in one group of 16-byte cp.async, so that the CTA waits
  // for one round trip: this CTA's rows of kinv, the slot tables whole,
  // this CTA's rows of alpha, the observation row.
  const float* kinv_src = kinv_in + (size_t)e * kCap * kCap + r0 * kCap;
  for (int i = tid; i < R * kCap / 4; i += kThreads) {
    const int r = i / (kCap / 4), c = (i % (kCap / 4)) * 4;
    cp_async16(kinv + r * kKinvStride + c, kinv_src + i * 4);
  }
  for (int i = tid; i < kCap; i += kThreads)
    cp_async16(loc + i * 4, loc_in + (size_t)e * kCap * 4 + i * 4);
  // The small tables, one chunk a thread.
  const struct {
    float* dst;
    const float* src;
    int chunks;
  } tables[4] = {{err, err_in + (size_t)e * kCap * 2, kCap / 2},
                 {act, act_in + (size_t)e * kCap, kCap / 4},
                 {alpha, alpha_in + (size_t)e * kCap * 2 + r0 * 2, R / 2},
                 {ob, obs + (size_t)e * 8, 2}};
  int chunk = tid;
#pragma unroll
  for (const auto& tb : tables) {
    if (chunk >= 0 && chunk < tb.chunks)
      cp_async16(tb.dst + chunk * 4, tb.src + chunk * 4);
    chunk -= tb.chunks;
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const float x = ob[0], y = ob[1], p = ob[2], t = ob[3];
  const bool enabled = ob[6] > 0.5f;

  const Plan pl = plan_insert(act, loc, small, u_mat, count, x, y, p, t);
  if (tid < kCap) v_col[tid] = u_mat[tid * 4 + 3];
  __syncthreads();

  // M = kinv U on this CTA's rows. U's first three columns (e1, e2, eo)
  // each pick one slot or none, so those columns of M are columns of kinv,
  // read as they are (the product's sum adds only exact zeros to them).
  // The last, kinv v, is a dot product: P threads a row, each over every
  // P-th 16-byte chunk of it, joined by shuffles.
  {
    const int rl = tid / P, q = tid % P;
    const float* row = kinv + rl * kKinvStride;
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const float4* v4 = reinterpret_cast<const float4*>(v_col);
    float m3 = 0.0f;
#pragma unroll
    for (int k = 0; k < kCap / 4 / P; ++k) {
      const int c = k * P + q;
      const float4 a = row4[c];
      const float4 v = v4[c];
      m3 += a.x * v.x;
      m3 += a.y * v.y;
      m3 += a.z * v.z;
      m3 += a.w * v.w;
    }
#pragma unroll
    for (int off = P / 2; off > 0; off >>= 1)
      m3 += __shfl_xor_sync(0xffffffffu, m3, off);
    if (q == 0)
      reinterpret_cast<float4*>(m_mat)[rl] = make_float4(
          pl.first1 < kCap ? row[pl.first1] : 0.0f,
          pl.first2 < kCap ? row[pl.first2] : 0.0f,
          pl.slot_active ? row[pl.slot] : 0.0f, m3);
  }
  __syncthreads();

  // This CTA's part of S = U^T M: warp w computes entries 2w and 2w + 1.
  for (int qq = 0; qq < 2; ++qq) {
    const int idx = 2 * warp + qq, a = idx / 4, b = idx % 4;
    float acc = 0.0f;
    for (int i = lane; i < R; i += 32)
      acc += u_mat[(r0 + i) * 4 + a] * m_mat[i * 4 + b];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) part[idx] = acc;
  }
  cluster.sync();

  // S, summed over the ranks in rank order: the same in every CTA.
  if (tid < 16) {
    float acc = 0.0f;
#pragma unroll
    for (int rk = 0; rk < S; ++rk) acc += cluster.map_shared_rank(part, rk)[tid];
    small[kSmallS + tid] = acc;
  }
  __syncthreads();
  if (warp == 0) gram_pivots_warp(pl, small);
  __syncthreads();

  if (tid < R)
    w_row(r0 + tid, pl.slot, m_mat + tid * 4, u_mat + (r0 + tid) * 4, small,
          w_all + (r0 + tid) * 8, wc_mat + tid * 8);
  cluster.sync();

  // The other ranks' rows of W, two 16-byte chunks a row.
  for (int i = tid; i < kCap * 2; i += kThreads) {
    const int rk = (i / 2) / R;
    if (rk != rank)
      reinterpret_cast<float4*>(w_all)[i] = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(w_all, rk))[i];
  }
  cluster_arrive();
  __syncthreads();

  if (enabled) {
    // Rank-8 update of this CTA's rows, kinv += (W c) W^T: column
    // j = tid % CAP with W[j, :] in registers, rows of one parity, row i of
    // W c read as two 16-byte broadcasts.
    const int j = tid % kCap;
    const float4 wa = reinterpret_cast<const float4*>(w_all + j * 8)[0];
    const float4 wb = reinterpret_cast<const float4*>(w_all + j * 8)[1];
#pragma unroll
    for (int i = tid / kCap; i < R; i += kThreads / kCap) {
      const float4 a = reinterpret_cast<const float4*>(wc_mat + i * 8)[0];
      const float4 b = reinterpret_cast<const float4*>(wc_mat + i * 8)[1];
      float acc = a.x * wa.x;
      acc += a.y * wa.y;
      acc += a.z * wa.z;
      acc += a.w * wa.w;
      acc += b.x * wb.x;
      acc += b.y * wb.y;
      acc += b.z * wb.z;
      acc += b.w * wb.w;
      kinv[i * kKinvStride + j] += acc;
    }
    insert_slot(pl, act, loc, err, x, y, p, t, ob[4], ob[5]);
    ++count;
  }
  __syncthreads();

  if (enabled) {
    // alpha = kinv' (errors * active) on this CTA's rows, split as M is.
    const int rl = tid / P, q = tid % P;
    const float4* row = reinterpret_cast<const float4*>(kinv + rl * kKinvStride);
    const float4* err4 = reinterpret_cast<const float4*>(err);
    const float4* act4 = reinterpret_cast<const float4*>(act);
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int k = 0; k < kCap / 4 / P; ++k) {
      const int c = k * P + q;
      const float4 a = row[c];
      const float4 ea = err4[c * 2], eb = err4[c * 2 + 1];
      const float4 ac = act4[c];
      a0 += a.x * (ea.x * ac.x);
      a1 += a.x * (ea.y * ac.x);
      a0 += a.y * (ea.z * ac.y);
      a1 += a.y * (ea.w * ac.y);
      a0 += a.z * (eb.x * ac.z);
      a1 += a.z * (eb.y * ac.z);
      a0 += a.w * (eb.z * ac.w);
      a1 += a.w * (eb.w * ac.w);
    }
#pragma unroll
    for (int off = P / 2; off > 0; off >>= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, off);
      a1 += __shfl_xor_sync(0xffffffffu, a1, off);
    }
    if (q == 0) {
      alpha[rl * 2 + 0] = a0;
      alpha[rl * 2 + 1] = a1;
    }
  }
  __syncthreads();

  // This CTA's rows of kinv and alpha; rank 0 the slot tables and count.
  float4* dst =
      reinterpret_cast<float4*>(kinv_out + (size_t)e * kCap * kCap + r0 * kCap);
  for (int i = tid; i < R * kCap / 4; i += kThreads) {
    const int r = i / (kCap / 4), c = (i % (kCap / 4)) * 4;
    dst[i] = *reinterpret_cast<const float4*>(kinv + r * kKinvStride + c);
  }
  if (tid < R * 2) alpha_out[(size_t)e * kCap * 2 + r0 * 2 + tid] = alpha[tid];
  if (rank == 0) {
    for (int i = tid; i < kCap * 4; i += kThreads)
      loc_out[(size_t)e * kCap * 4 + i] = loc[i];
    for (int i = tid; i < kCap * 2; i += kThreads)
      err_out[(size_t)e * kCap * 2 + i] = err[i];
    if (tid < kCap) act_out[(size_t)e * kCap + tid] = act[tid];
    if (tid == 0) cnt_out[e] = count;
  }
  cluster_wait();
}

struct Args {
  const float *obs, *loc_in, *err_in, *act_in, *kinv_in, *alpha_in;
  const int* cnt_in;
  float *loc_out, *err_out, *act_out, *kinv_out, *alpha_out;
  int* cnt_out;
};

// The dynamic shared memory limit of each kernel is raised once per
// process (the attribute holds for the device current at the first
// launch).
cudaError_t launch_per_env(const Args& a, int n, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gp_observe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return attr;
  gp_observe_kernel<<<n, kThreads, kSmemBytes, stream>>>(
      a.obs, a.loc_in, a.err_in, a.act_in, a.kinv_in, a.alpha_in, a.cnt_in,
      a.loc_out, a.err_out, a.act_out, a.kinv_out, a.alpha_out, a.cnt_out);
  return cudaGetLastError();
}

// The launch configuration of the cluster kernel over `n` envs; `attr`
// receives the cluster dimension.
template <int S>
cudaLaunchConfig_t cluster_config(int n, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Sliced<S>::kBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = S;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int S>
cudaError_t set_cluster_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gp_observe_cluster_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Sliced<S>::kBytes);
  return attr;
}

template <int S>
cudaError_t launch_sliced(const Args& a, int n, cudaStream_t stream) {
  cudaError_t err = set_cluster_smem<S>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<S>(n, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, gp_observe_cluster_kernel<S>, a.obs,
                           a.loc_in, a.err_in, a.act_in, a.kinv_in,
                           a.alpha_in, a.cnt_in, a.loc_out, a.err_out,
                           a.act_out, a.kinv_out, a.alpha_out, a.cnt_out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int S>
cudaError_t sliced_info(int* info) {
  cudaError_t err = set_cluster_smem<S>();
  if (err != cudaSuccess) return err;
  info[0] = Sliced<S>::kBytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[1], gp_observe_cluster_kernel<S>, kThreads, Sliced<S>::kBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<S>(1, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(&info[2],
                                        gp_observe_cluster_kernel<S>, &cfg);
}

}  // namespace

// obs (n, 8) = [x, y, p, t, err_u, err_v, enabled, 0]; state buffers loc
// (n, 128, 4), err (n, 128, 2), act (n, 128) as 0/1 floats, kinv
// (n, 128, 128), alpha (n, 128, 2), count (n,), each with its output twin.
// `split` is 1 (one CTA per env) or the cluster size S in {2, 4, 8}.
// Returns the first CUDA error of the attribute call or the launch.
extern "C" int ble_gp_observe(const float* obs, const float* loc_in,
                              const float* err_in, const float* act_in,
                              const float* kinv_in, const float* alpha_in,
                              const int* cnt_in, float* loc_out,
                              float* err_out, float* act_out, float* kinv_out,
                              float* alpha_out, int* cnt_out, int n,
                              int split, cudaStream_t stream) {
  const Args a{obs,     loc_in,  err_in,  act_in,   kinv_in,   alpha_in, cnt_in,
               loc_out, err_out, act_out, kinv_out, alpha_out, cnt_out};
  if (n <= 0) return (int)cudaGetLastError();
  switch (split) {
    case 1: return (int)launch_per_env(a, n, stream);
    case 2: return (int)launch_sliced<2>(a, n, stream);
    case 4: return (int)launch_sliced<4>(a, n, stream);
    case 8: return (int)launch_sliced<8>(a, n, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The one-CTA-per-env kernel's dynamic shared memory in bytes and its
// resident CTAs per SM, as info[0] and info[1]. Returns the first CUDA
// error.
extern "C" int ble_gp_observe_info(int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      gp_observe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  info[0] = kSmemBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[1], gp_observe_kernel, kThreads, kSmemBytes);
}

// The cluster kernel at cluster size `split` (2, 4 or 8): its dynamic shared
// memory in bytes, resident CTAs per SM and clusters resident on the card
// at once, as info[0..2]. Returns the first CUDA error.
extern "C" int ble_gp_observe_cluster_info(int split, int* info) {
  switch (split) {
    case 2: return (int)sliced_info<2>(info);
    case 4: return (int)sliced_info<4>(info);
    case 8: return (int)sliced_info<8>(info);
    default: return (int)cudaErrorInvalidValue;
  }
}
