// Fused K-step GP observe + 181-level query for Hopper (sm_90a).
//
// Replaces the TPU kernel ble_tpu/ops/pallas_gp_window.py:window (kernel
// _kernel, cores _observe_core and _step_one). For each env and step: the
// GP observe (two stale expiries, ring eviction, bordered insert with the
// clamped Gram-chain pivots read off the 4x4 U^T kinv U, the rank-8 update
// kinv += (W c) W^T and alpha = kinv' targets; an exact no-op when the
// step's `enabled` flag is 0), then the posterior at 181 pressure levels
// against the updated state: means = k*^T alpha and
// dev = clip((s^2 - sum k* (kinv k*)) / s^2, 0, 1), zero with no active slot.
//
// Design: one CTA of 256 threads per env. The 128x128 float32 inverse lives
// in dynamic shared memory (rows padded to 129 floats, so row and column
// walks are both free of bank conflicts) for all K steps, beside the small
// per-slot buffers; it is read from and written to device memory once per
// window. The observe phase is gp_core.cuh's, shared with the
// observe-only kernel csrc/gp_observe.cu: stale-slot search by warp ballot,
// M = kinv U and S = U^T M as block reductions, the scalar pivot chain on
// one thread with the same clamps as the JAX package
// (d_min = 1/(s_f^2 + s_n^2), schur >= s_n^2).
// The query builds k* 64 levels at a time in shared memory and forms
// kinv k* with an 8x4 register tile per thread in full float32 on the CUDA
// cores: no tensor cores, because the variance cancels operands of ~13 down
// to s_n^2 = 0.05 (TF32 or bf16 would swamp it). The level output is
// written as (K, E, 181, 3) directly.
//
// Bound, per env and step: ~6.5 MFLOP, dominated by kinv k* at
// 2 x 128 x 128 x 181, against ~136 KiB of traffic (kinv in and out); at
// 4096 envs that is ~27 GFLOP and ~570 MB: compute-bound on the float32
// CUDA cores. Using kinv's symmetry and its residency across K, and
// cp.async/TMA staging of the inverse, are later work.
//
// Built with nvcc's default --fmad=true: sums of products contract to FMA,
// as cuBLAS's do; the kernel is held to the plain PyTorch version at
// atol 5e-3, the JAX package's tolerance for this kernel.

#include <cuda_runtime.h>

#include "gp_core.cuh"

namespace {

using namespace ble_gp;

constexpr int kLevels = 181;
constexpr int kChunk = 64;
constexpr int kNumChunks = (kLevels + kChunk - 1) / kChunk;
constexpr int kRowGroups = 16;  // vv tile: 16 row groups x 16 column groups.
constexpr int kTileRows = kCap / kRowGroups;  // 8
constexpr int kTileCols = kChunk / 16;  // 4

constexpr double kPresMin = 5000.0, kPresStep = (14000.0 - 5000.0) / 180.0;

// Shared memory layout, in floats.
constexpr int kOffKinv = 0;
constexpr int kOffLoc = kOffKinv + kCap * kKinvStride;
constexpr int kOffErr = kOffLoc + kCap * 4;
constexpr int kOffAct = kOffErr + kCap * 2;
constexpr int kOffAlpha = kOffAct + kCap;
constexpr int kOffQc = kOffAlpha + kCap * 2;
constexpr int kOffScratch = kOffQc + kCap;  // k* chunk, or U | M | W.
constexpr int kOffRed = kOffScratch + kCap * kChunk;
constexpr int kOffSmall = kOffRed + kRowGroups * kChunk;
constexpr int kSmemFloats = kOffSmall + kSmallFloats;
constexpr int kSmemBytes = kSmemFloats * 4;
static_assert(kCap * kChunk >= kObserveScratchFloats, "scratch too small");

__global__ void __launch_bounds__(kThreads, 2)
gp_window_kernel(const float* __restrict__ obs_seq,
                 const float* __restrict__ loc_in,
                 const float* __restrict__ err_in,
                 const float* __restrict__ act_in,
                 const float* __restrict__ kinv_in,
                 const float* __restrict__ alpha_in,
                 const int* __restrict__ cnt_in, float* __restrict__ loc_out,
                 float* __restrict__ err_out, float* __restrict__ act_out,
                 float* __restrict__ kinv_out, float* __restrict__ alpha_out,
                 int* __restrict__ cnt_out, float* __restrict__ level,
                 int n, int k_steps) {
  extern __shared__ float smem[];
  const State s{smem + kOffKinv, smem + kOffLoc, smem + kOffErr,
                smem + kOffAct, smem + kOffAlpha};
  const float* loc = s.loc;
  const float* act = s.act;
  const float* alpha = s.alpha;
  const float* kinv = s.kinv;
  float* qc = smem + kOffQc;
  float* scratch = smem + kOffScratch;
  float* red = smem + kOffRed;
  float* small = smem + kOffSmall;

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const float sf2 = F(kSigmaF2);

  // --- Load the GP state once per window. ---
  load_state(s, e, loc_in, err_in, act_in, kinv_in, alpha_in);
  int count = cnt_in[e];
  __syncthreads();

  for (int k = 0; k < k_steps; ++k) {
    const float* ob = obs_seq + ((size_t)k * n + e) * 8;
    const float x = ob[0], y = ob[1], p = ob[2], t = ob[3];
    const float eu = ob[4], ev = ob[5];
    const bool enabled = ob[6] > 0.5f;

    observe_step(s, scratch, small, count, x, y, p, t, eu, ev, enabled);
    // ---------------- query ----------------
    if (tid < kCap) {
      const int i = tid;
      float qdx = (x - loc[i * 4 + 0]) / F(kLsX);
      float qdy = (y - loc[i * 4 + 1]) / F(kLsY);
      float qdt = (t - loc[i * 4 + 3]) / F(kLsT);
      qc[i] = qdx * qdx + qdy * qdy + qdt * qdt + F(1e-12);
    }
    const float any_valid =
        __syncthreads_or(tid < kCap && act[tid] > 0.0f) ? 1.0f : 0.0f;

    float* lvl = level + ((size_t)k * n + e) * kLevels * 3;
    for (int ch = 0; ch < kNumChunks; ++ch) {
      const int l0 = ch * kChunk;
      // k* chunk (CAP, 64); levels past 181 are zero columns.
      for (int idx = tid; idx < kCap * kChunk; idx += kThreads) {
        const int a = idx / kChunk, jl = idx % kChunk, l = l0 + jl;
        float ks = 0.0f;
        if (l < kLevels) {
          float pres = F(kPresMin + kPresStep * l);
          float qdp = (pres - loc[a * 4 + 2]) / F(kLsP);
          float qd = sqrtf(qc[a] + qdp * qdp);
          ks = (sf2 * expf(-qd)) * act[a];
        }
        scratch[idx] = ks;
      }
      __syncthreads();

      if (tid < 2 * kChunk) {
        const int jl = tid % kChunk, comp = tid / kChunk, l = l0 + jl;
        if (l < kLevels) {
          float acc = 0.0f;
          for (int a = 0; a < kCap; ++a)
            acc += alpha[a * 2 + comp] * scratch[a * kChunk + jl];
          lvl[l * 3 + comp] = acc * any_valid;
        }
      }

      // vv = kinv k* on an 8 x 4 register tile, then k* . vv per column.
      {
        const int rg = tid / 16, cg = tid % 16;
        float acc[kTileRows][kTileCols];
#pragma unroll
        for (int i = 0; i < kTileRows; ++i)
#pragma unroll
          for (int jj = 0; jj < kTileCols; ++jj) acc[i][jj] = 0.0f;
        const float* krows = kinv + rg * kTileRows * kKinvStride;
        for (int kk = 0; kk < kCap; ++kk) {
          float b[kTileCols];
#pragma unroll
          for (int jj = 0; jj < kTileCols; ++jj)
            b[jj] = scratch[kk * kChunk + cg + 16 * jj];
#pragma unroll
          for (int i = 0; i < kTileRows; ++i) {
            float a = krows[i * kKinvStride + kk];
#pragma unroll
            for (int jj = 0; jj < kTileCols; ++jj) acc[i][jj] += a * b[jj];
          }
        }
#pragma unroll
        for (int jj = 0; jj < kTileCols; ++jj) {
          const int col = cg + 16 * jj;
          float part = 0.0f;
#pragma unroll
          for (int i = 0; i < kTileRows; ++i)
            part += scratch[(rg * kTileRows + i) * kChunk + col] * acc[i][jj];
          red[rg * kChunk + col] = part;
        }
      }
      __syncthreads();

      if (tid < kChunk) {
        const int l = l0 + tid;
        if (l < kLevels) {
          float sum = 0.0f;
          for (int g = 0; g < kRowGroups; ++g) sum += red[g * kChunk + tid];
          float var = sf2 - sum;
          float dev = fminf(fmaxf(var / sf2, 0.0f), 1.0f);
          lvl[l * 3 + 2] = dev * any_valid;
        }
      }
      __syncthreads();
    }
  }

  // --- Write the GP state back. ---
  store_state(s, e, count, loc_out, err_out, act_out, kinv_out, alpha_out,
              cnt_out);
}

}  // namespace

// obs_seq (K, n, 8) = [x, y, p, t, err_u, err_v, enabled, 0]; state
// buffers loc (n, 128, 4), err (n, 128, 2), act (n, 128) as 0/1 floats,
// kinv (n, 128, 128), alpha (n, 128, 2), count (n,); level (K, n, 181, 3).
// Returns the first CUDA error of the attribute call or the launch.
extern "C" int ble_gp_window(const float* obs_seq, const float* loc_in,
                             const float* err_in, const float* act_in,
                             const float* kinv_in, const float* alpha_in,
                             const int* cnt_in, float* loc_out,
                             float* err_out, float* act_out, float* kinv_out,
                             float* alpha_out, int* cnt_out, float* level,
                             int n, int k_steps, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gp_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    gp_window_kernel<<<n, kThreads, kSmemBytes, stream>>>(
        obs_seq, loc_in, err_in, act_in, kinv_in, alpha_in, cnt_in, loc_out,
        err_out, act_out, kinv_out, alpha_out, cnt_out, level, n, k_steps);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory the kernel asks for, in bytes.
extern "C" int ble_gp_window_smem_bytes() { return kSmemBytes; }
