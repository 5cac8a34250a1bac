// GP posterior at a column of pressures for Hopper (sm_90a).
//
// Replaces the TPU kernel ble_tpu/ops/pallas_gp.py:query_column (B5,
// kernel _kernel): for each env, N query points share the env's (x, y, t)
// and differ in pressure; k*[l, a] = s_f^2 exp(-|q_l - loc_a| / ls) on the
// active slots, means = k* alpha, v = k* kinv and
// dev = clip((s_f^2 - sum_a k*[l, a] v[l, a]) / s_f^2, 0, 1); both are zero
// for an env with no active slot.
//
// Bound, per env at N = 181: ~6.3 MFLOP, dominated by v = k* kinv at
// 2 x 181 x 128 x 128, against ~71 KiB of traffic (kinv in, the levels
// out); at 4096 envs ~25.6 GFLOP (0.38 ms at 67 TFLOP/s) against ~290 MB
// (0.09 ms at 3.35 TB/s): compute-bound on the float32 CUDA cores. At one
// env the same 6.3 MFLOP is a few microseconds of one SM: latency-bound.
//
// Design: a grid of (E, S) CTAs of 256 threads; CTA (e, s) computes the
// s-th contiguous slice of env e's levels (gp_query_core.cuh:slice_levels)
// with the shared query engine, gp_query_core.cuh:query_levels, which also
// serves B2. The wrapper (ops/gp_query.py:level_split) picks S from E, N
// and the card's SM count: S = 1 when the envs alone fill the card, and up
// to one slice per 16 levels when they do not (12 CTAs for one env at 181
// levels, each reading the env's inverse from L2). Each CTA stages the
// inverse with cp.async into rows padded to 132 floats and builds the
// x/y/t distances while the copy flies. What the engine does about the
// first kernel's scalar shared loads, synchronous kinv load, idle-half-
// block side loops and ragged last chunk is in its header.

#include <cuda_runtime.h>

#include "gp_core.cuh"
#include "gp_query_core.cuh"

namespace {

using namespace ble_gp;

// Shared memory layout, in floats (every offset a multiple of 4).
constexpr int kOffKinv = 0;
constexpr int kOffSlot = kOffKinv + kCap * kKinvStride;
constexpr int kOffAlpha = kOffSlot + kCap * 4;
constexpr int kOffKstar = kOffAlpha + kCap * 2;
constexpr int kOffRed = kOffKstar + kKstarFloats;
constexpr int kSmemFloats = kOffRed + kRedFloats;
constexpr int kSmemBytes = kSmemFloats * 4;

__global__ void __launch_bounds__(kThreads, 2)
gp_query_kernel(const float* __restrict__ loc_in,
                const float* __restrict__ act_in,
                const float* __restrict__ alpha_in,
                const float* __restrict__ kinv_in,
                const float* __restrict__ q_in,
                const float* __restrict__ pres, float* __restrict__ out,
                int n_levels, int n_slices) {
  extern __shared__ __align__(16) float smem[];
  float* kinv = smem + kOffKinv;
  float4* slot = reinterpret_cast<float4*>(smem + kOffSlot);
  float* alpha = smem + kOffAlpha;

  const int e = blockIdx.x;
  const int per = slice_levels(n_levels, n_slices);
  const int l_begin = blockIdx.y * per;
  const int l_end = min(n_levels, l_begin + per);
  if (l_begin >= l_end) return;
  const int tid = threadIdx.x;

  stage_kinv(kinv, kinv_in + (size_t)e * kCap * kCap);
  // The x/y/t part of each slot's distance to the column, and the active
  // mask (pallas_gp._kernel's lane vector c), while kinv is in flight.
  bool active = false;
  if (tid < kCap) {
    const float* q = q_in + (size_t)e * 4;
    const float4 lo =
        reinterpret_cast<const float4*>(loc_in + (size_t)e * kCap * 4)[tid];
    const float dx = (q[0] - lo.x) / F(kLsX);
    const float dy = (q[1] - lo.y) / F(kLsY);
    const float dt = (q[2] - lo.w) / F(kLsT);
    const float a = act_in[(size_t)e * kCap + tid];
    slot[tid] = make_float4(lo.z, dx * dx + dy * dy + dt * dt + F(1e-12), a,
                            0.0f);
    active = a > 0.0f;
    reinterpret_cast<float2*>(alpha)[tid] =
        reinterpret_cast<const float2*>(alpha_in + (size_t)e * kCap * 2)[tid];
  }
  const float any_valid = __syncthreads_or(active) ? 1.0f : 0.0f;

  query_levels(kinv, slot, alpha, pres, smem + kOffKstar,
               smem + kOffRed, l_begin, l_end, any_valid,
               out + (size_t)e * n_levels * 3);
}

}  // namespace

// loc (n, 128, 4), act (n, 128) as 0/1 floats, alpha (n, 128, 2), kinv
// (n, 128, 128), q (n, 4) = [x, y, t, 0], pres (n_levels,); out
// (n, n_levels, 3) = [mean_u, mean_v, deviation]. Each env's levels are
// split into n_slices slices, one CTA each. Returns the first CUDA error
// of the attribute call or the launch.
extern "C" int ble_gp_query(const float* loc, const float* act,
                            const float* alpha, const float* kinv,
                            const float* q, const float* pres, float* out,
                            int n, int n_levels, int n_slices,
                            cudaStream_t stream) {
  // The shared memory limit is raised once per process.
  static const cudaError_t attr = cudaFuncSetAttribute(
      gp_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  if (n > 0 && n_levels > 0 && n_slices > 0) {
    gp_query_kernel<<<dim3(n, n_slices), kThreads, kSmemBytes, stream>>>(
        loc, act, alpha, kinv, q, pres, out, n_levels, n_slices);
  }
  return (int)cudaGetLastError();
}

// The kernel's dynamic shared memory in bytes and its resident CTAs per SM,
// as info[0] and info[1]. Returns the first CUDA error.
extern "C" int ble_gp_query_info(int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      gp_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  info[0] = kSmemBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[1], gp_query_kernel, kThreads, kSmemBytes);
}
