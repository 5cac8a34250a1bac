// Fused K-step GP observe + 181-level query for Hopper (sm_90a).
//
// Replaces the TPU kernel ble_tpu/ops/pallas_gp_window.py:window (kernel
// _kernel, cores _observe_core and _step_one). For each env and step: the
// GP observe (two stale expiries, ring eviction, bordered insert with the
// clamped Gram-chain pivots read off the 4x4 U^T kinv U, the rank-8 update
// kinv += (W c) W^T and alpha = kinv' targets; an exact no-op when the
// step's `enabled` flag is 0), then the posterior at 181 pressure levels
// against the updated state: means = k*^T alpha and
// dev = clip((s^2 - k*^T kinv k*) / s^2, 0, 1), zero with no active slot.
//
// Bound, per env and step: ~6.7 MFLOP, dominated by the quadratic form at
// 2 x 181 x 128 x 128, against ~136 KiB of traffic (kinv in and out); at
// 4096 envs ~27.6 GFLOP (0.41 ms at 67 TFLOP/s) against ~570 MB (0.17 ms
// at 3.35 TB/s): compute-bound on the float32 CUDA cores.
//
// Design: one CTA of 256 threads per env, two CTAs an SM. The 128x128
// float32 inverse lives in dynamic shared memory for all K steps, in rows
// padded to 132 floats; it is read from and written to device memory once
// per window. It arrives by cp.async (gp_core.cuh:load_state), with no
// register round trip, while the first observe searches the stale slots
// by warp ballot and builds U; the observe waits for it just before
// M = kinv U. The observe is gp_core.cuh's, shared with the observe-only
// kernel csrc/gp_observe.cu: M = kinv U and alpha = kinv' targets walk
// kinv's rows 16 bytes at a time, the rank-8 update reads each row of W c
// as two 16-byte broadcasts, S = U^T M is a block reduction and the
// scalar pivot chain runs on one thread with the same clamps as the JAX
// package (d_min = 1/(s_f^2 + s_n^2), schur >= s_n^2). The query is the
// engine B5 uses, gp_query_core.cuh:query_levels, over all 181 levels: its
// header says what it does about the first kernel's scalar shared loads,
// idle-half-block side loops and ragged last chunk. It forms k* kinv, not
// the TPU kernel's kinv k*: both sums are the quadratic form k*^T kinv k*
// and differ only in rounding. The level output is written as
// (K, E, 181, 3) directly.
//
// Built with nvcc's default --fmad=true: sums of products contract to FMA,
// as cuBLAS's do; the kernel is held to the plain PyTorch version at
// atol 5e-3, the JAX package's tolerance for this kernel.

#include <cuda_runtime.h>

#include "gp_core.cuh"
#include "gp_query_core.cuh"

namespace {

using namespace ble_gp;

constexpr int kLevels = 181;
constexpr double kPresMin = 5000.0, kPresStep = (14000.0 - 5000.0) / 180.0;

// Shared memory layout, in floats (every offset a multiple of 4).
constexpr int kOffKinv = 0;
constexpr int kOffLoc = kOffKinv + kCap * kKinvStride;
constexpr int kOffErr = kOffLoc + kCap * 4;
constexpr int kOffAct = kOffErr + kCap * 2;
constexpr int kOffAlpha = kOffAct + kCap;
constexpr int kOffSlot = kOffAlpha + kCap * 2;
constexpr int kOffPres = kOffSlot + kCap * 4;
constexpr int kOffScratch = kOffPres + 192;  // k* chunk, or U | M | W.
constexpr int kOffRed = kOffScratch + kKstarFloats;
constexpr int kOffSmall = kOffRed + kRedFloats;
constexpr int kSmemFloats = kOffSmall + kSmallFloats;
constexpr int kSmemBytes = kSmemFloats * 4;
static_assert(kKstarFloats >= kObserveScratchFloats, "scratch too small");
static_assert(kLevels <= 192, "pressure table too small");

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
  extern __shared__ __align__(16) float smem[];
  const State s{smem + kOffKinv, smem + kOffLoc, smem + kOffErr,
                smem + kOffAct, smem + kOffAlpha};
  float4* slot = reinterpret_cast<float4*>(smem + kOffSlot);
  float* pres = smem + kOffPres;
  float* scratch = smem + kOffScratch;
  float* small = smem + kOffSmall;

  const int e = blockIdx.x;
  const int tid = threadIdx.x;

  // --- Load the GP state once per window; kinv is still in flight. ---
  load_state(s, e, loc_in, err_in, act_in, kinv_in, alpha_in);
  if (tid < kLevels) pres[tid] = F(kPresMin + kPresStep * tid);
  int count = cnt_in[e];
  __syncthreads();

  for (int k = 0; k < k_steps; ++k) {
    const float* ob = obs_seq + ((size_t)k * n + e) * 8;
    const float x = ob[0], y = ob[1], p = ob[2], t = ob[3];
    const float eu = ob[4], ev = ob[5];
    const bool enabled = ob[6] > 0.5f;

    observe_step(s, scratch, small, count, x, y, p, t, eu, ev, enabled);
    // ---------------- query ----------------
    bool active = false;
    if (tid < kCap) {
      const float4 lo = reinterpret_cast<const float4*>(s.loc)[tid];
      const float qdx = (x - lo.x) / F(kLsX);
      const float qdy = (y - lo.y) / F(kLsY);
      const float qdt = (t - lo.w) / F(kLsT);
      const float a = s.act[tid];
      slot[tid] = make_float4(
          lo.z, qdx * qdx + qdy * qdy + qdt * qdt + F(1e-12), a, 0.0f);
      active = a > 0.0f;
    }
    const float any_valid = __syncthreads_or(active) ? 1.0f : 0.0f;
    query_levels(s.kinv, slot, s.alpha, pres, scratch,
                 smem + kOffRed, 0, kLevels, any_valid,
                 level + ((size_t)k * n + e) * kLevels * 3);
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
  // The shared memory limit is raised once per process.
  static const cudaError_t attr = cudaFuncSetAttribute(
      gp_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  if (n > 0) {
    gp_window_kernel<<<n, kThreads, kSmemBytes, stream>>>(
        obs_seq, loc_in, err_in, act_in, kinv_in, alpha_in, cnt_in, loc_out,
        err_out, act_out, kinv_out, alpha_out, cnt_out, level, n, k_steps);
  }
  return (int)cudaGetLastError();
}

// The kernel's dynamic shared memory in bytes and its resident CTAs per SM,
// as info[0] and info[1]. Returns the first CUDA error.
extern "C" int ble_gp_window_info(int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      gp_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  info[0] = kSmemBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[1], gp_window_kernel, kThreads, kSmemBytes);
}
