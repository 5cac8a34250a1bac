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
// Design: one CTA of 256 threads per env, whatever the batch: B3 is E = 1
// and B4 any E (the TPU's 8-env blocking amortised per-program DMA setup,
// which a CTA does not pay). The env's 128x128 float32 inverse is staged
// once by cp.async into dynamic shared memory, in rows padded to 132 floats
// (the stale-slot search and U overlap the copy), updated there by
// gp_core.cuh (the same code as B2's observe phase, walking kinv's rows 16
// bytes at a time), and written back once. All arithmetic is float32 on
// the CUDA cores.
//
// Bound, per env: ~137 KiB of traffic (kinv in and out, plus the small
// tables) against ~0.47 MFLOP, so at E = 4096 it is memory-bound
// (~575 MB, 0.17 ms at 3.35 TB/s; 1.9 GFLOP, 0.03 ms at 67 TFLOP/s). At
// E = 1 it is bound by launch latency and the serial chain of block
// barriers.

#include <cuda_runtime.h>

#include "gp_core.cuh"

namespace {

using namespace ble_gp;

// Shared memory layout, in floats.
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

}  // namespace

// obs (n, 8) = [x, y, p, t, err_u, err_v, enabled, 0]; state buffers loc
// (n, 128, 4), err (n, 128, 2), act (n, 128) as 0/1 floats, kinv
// (n, 128, 128), alpha (n, 128, 2), count (n,), each with its output twin.
// Returns the first CUDA error of the attribute call or the launch.
extern "C" int ble_gp_observe(const float* obs, const float* loc_in,
                              const float* err_in, const float* act_in,
                              const float* kinv_in, const float* alpha_in,
                              const int* cnt_in, float* loc_out,
                              float* err_out, float* act_out, float* kinv_out,
                              float* alpha_out, int* cnt_out, int n,
                              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gp_observe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    gp_observe_kernel<<<n, kThreads, kSmemBytes, stream>>>(
        obs, loc_in, err_in, act_in, kinv_in, alpha_in, cnt_in, loc_out,
        err_out, act_out, kinv_out, alpha_out, cnt_out);
  }
  return (int)cudaGetLastError();
}

// The kernel's dynamic shared memory in bytes and its resident CTAs per SM,
// as info[0] and info[1]. Returns the first CUDA error.
extern "C" int ble_gp_observe_info(int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      gp_observe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  info[0] = kSmemBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[1], gp_observe_kernel, kThreads, kSmemBytes);
}
